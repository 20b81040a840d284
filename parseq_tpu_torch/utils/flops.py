"""Static FLOP counting with torch's FlopCounterMode, in fvcore's convention
(counterpart of parseq_tpu/utils/flops.py).

The reference bench reports fvcore's static analysis, which counts one
multiply-accumulate of a matrix product or convolution as one FLOP; the
JAX package's jaxpr walk matches it. torch's counter counts two per MAC, so
the total is halved. Like the jaxpr walk, it sees only the products torch
dispatches (mm, bmm, addmm, convolution, ...): elementwise work is not
counted, and neither is a product inside an opaque call (a hand-written
kernel, cuDNN's LSTM), so callers count through the plain paths.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn, *args, **kwargs) -> float:
    """Run ``fn(*args, **kwargs)`` once (no autograd) and return its MACs.

    When `fn` is a module its parameters are frozen while it runs: the
    counter's module tracker hooks every submodule input that requires
    grad, and fails on a parameter passed as one under no_grad."""
    params = [p for p in fn.parameters() if p.requires_grad] if isinstance(fn, nn.Module) else []
    for p in params:
        p.requires_grad_(False)
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            fn(*args, **kwargs)
    finally:
        for p in params:
            p.requires_grad_(True)
    return counter.get_total_flops() / 2
