"""Model factory API of the port (counterpart of parseq_tpu/hub.py).

    from parseq_tpu_torch import hub
    model = hub.parseq()                                  # random weights, cuda
    model = hub.parseq(pretrained='weights/parseq-bb5792a6.pt', device='cuda')
    labels, confidences = model.read(images_nhwc)

`pretrained` takes a local reference PyTorch `.pt` path. Resolving released
weights by name (`pretrained=True`) needs the network and is not ported.
"""

from __future__ import annotations

from parseq_tpu_torch.utils.registry import ModelBundle, create_model, load_from_checkpoint


def _factory(experiment):
    def fn(pretrained: str | None = None, **kwargs) -> ModelBundle:
        if pretrained is True:
            raise NotImplementedError(
                'pretrained=True resolves released weights over the network and is not '
                'ported; pass a local .pt path')
        if pretrained:
            return load_from_checkpoint(pretrained, **kwargs)
        return create_model(experiment, **kwargs)

    fn.__name__ = experiment.replace('-', '_')
    fn.__doc__ = f'Build {experiment} (optionally from a local reference .pt path).'
    return fn


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'hub.{name} is not ported to PyTorch yet ({item})')

    fn.__name__ = name
    return fn


parseq = _factory('parseq')
parseq_tiny = _factory('parseq-tiny')
parseq_patch16_224 = _not_ported(
    'parseq_patch16_224', 'ROADMAP queue A item 14: its L=196 encoder needs kernel B2')
vitstr = _not_ported('vitstr', 'ROADMAP queue A item 14')
crnn = _not_ported('crnn', 'ROADMAP queue A item 16')
trba = _not_ported('trba', 'ROADMAP queue A item 16')
abinet = _not_ported('abinet', 'ROADMAP queue A item 15')
