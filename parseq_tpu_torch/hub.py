"""Model factory API of the port (counterpart of parseq_tpu/hub.py).

    from parseq_tpu_torch import hub
    model = hub.parseq()                                  # random weights, cuda
    model = hub.vitstr(seed=1)                            # also parseq_patch16_224, abinet
    model = hub.parseq(pretrained='weights/parseq-bb5792a6.pt', device='cuda')
    model = hub.parseq(pretrained=True)                   # released weights, from the cache
    labels, confidences = model.read(images_nhwc)

`pretrained` takes a local PyTorch file (a reference state_dict as `.pt` or
`.ckpt`, or a checkpoint the port's trainer wrote), or True for the released
weights of the model, found offline in the checksum cache
(`utils/pretrained.py`: $PARSEQ_TPU_CACHE, ~/.cache/parseq_tpu/checkpoints,
torch.hub's cache). Only downloading them needs the network, and the port
does not download: a missing file raises naming the file and the
directories searched.
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


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'hub.{name} is not ported to PyTorch yet ({item})')

    fn.__name__ = name
    return fn


parseq = _factory('parseq')
parseq_tiny = _factory('parseq-tiny')
parseq_patch16_224 = _factory('parseq-patch16-224')
vitstr = _factory('vitstr')
abinet = _factory('abinet')
crnn = _not_ported('crnn', 'ROADMAP queue A item 16')
trba = _not_ported('trba', 'ROADMAP queue A item 16')
