"""The program under test as the cells build it: the registry's ModelBundle
of a configuration, holding the seed's weights."""

from __future__ import annotations


def bundle(ctx, state_dict):
    """`utils/registry.py`'s bundle of the cell's configuration (its composed
    model config, bf16 compute) on the run's device, loaded strictly with
    `state_dict` and built under that device, so no random init of its own
    runs on the host."""
    import torch
    from parseq_tpu_torch.utils import registry

    cfg = ctx.cell.config
    with torch.device(ctx.device):
        return registry._bundle(cfg['experiment'], dict(cfg['model']), dtype=torch.bfloat16,
                                device=ctx.device, state_dict=state_dict)
