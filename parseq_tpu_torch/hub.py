"""Model factory API of the port (counterpart of parseq_tpu/hub.py).

    from parseq_tpu_torch import hub
    model = hub.parseq()                                  # random weights, cuda
    model = hub.vitstr(seed=1)                 # also parseq_patch16_224, abinet, crnn, trba
    model = hub.parseq(pretrained='weights/parseq-bb5792a6.pt', device='cuda')
    model = hub.parseq(pretrained=True)                   # released weights, from the cache
    labels, confidences = model.read(images_nhwc)

`pretrained` takes a local PyTorch file (a reference state_dict as `.pt` or
`.ckpt`, or a checkpoint the port's trainer wrote), or True for the released
weights of the model, found offline in the checksum cache
(`utils/pretrained.py`: $PARSEQ_TPU_CACHE, ~/.cache/parseq_tpu/checkpoints,
torch.hub's cache). Only downloading them needs the network, and the port
does not download: a missing file raises naming the file and the
directories searched. As in the JAX package there is no trbc factory: TRBC
is `registry.create_model('trbc')` or a checkpoint.
"""

from __future__ import annotations

from parseq_tpu_torch.utils.registry import ModelBundle, create_model, load_from_checkpoint


def _factory(experiment):
    def fn(pretrained: str | bool | None = None, **kwargs) -> ModelBundle:
        if pretrained is True:
            from parseq_tpu_torch.utils.pretrained import load_pretrained

            return load_pretrained(experiment, **kwargs)
        if pretrained:
            return load_from_checkpoint(pretrained, **kwargs)
        return create_model(experiment, **kwargs)

    fn.__name__ = experiment.replace('-', '_')
    fn.__doc__ = (f'Build {experiment}: random weights, a local checkpoint path, or '
                  f'pretrained=True for the released weights from the cache.')
    return fn


parseq = _factory('parseq')
parseq_tiny = _factory('parseq-tiny')
parseq_patch16_224 = _factory('parseq-patch16-224')
vitstr = _factory('vitstr')
abinet = _factory('abinet')
crnn = _factory('crnn')
trba = _factory('trba')
