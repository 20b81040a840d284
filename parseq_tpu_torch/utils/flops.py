"""Static FLOP counting with torch's FlopCounterMode, in fvcore's convention
(counterpart of parseq_tpu/utils/flops.py).

The reference bench reports fvcore's static analysis, which counts one
multiply-accumulate of a matrix product or convolution as one FLOP; the
JAX package's jaxpr walk matches it. torch's counter counts two per MAC, so
the total is halved. Like the jaxpr walk, it sees only the products torch
dispatches (mm, bmm, addmm, convolution, ...): elementwise work is not
counted, and neither is a product inside an opaque call (a hand-written
kernel, cuDNN's LSTM), so callers count through the plain paths. torch's
counter has no formula for the int8 product `aten._int_mm` (ops/quant.py)
and would count it as 0; `INT_MM_FLOPS` gives it 2 * M * K * N, so an int8
encoder counts the MACs of its bf16 one, as the JAX walk counts an int8
dot_general's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """torch._int_mm (M, K) x (K, N): 2 * M * K * N, as for mm."""
    (m, k), (k2, n) = a_shape, b_shape
    assert k == k2, (a_shape, b_shape)
    return 2 * m * k * n


INT_MM_FLOPS = {torch.ops.aten._int_mm: _int_mm_flop}


def count_flops(fn, *args, **kwargs) -> float:
    """Run ``fn(*args, **kwargs)`` once (no autograd) and return its MACs.

    When `fn` is a module its parameters are frozen while it runs: the
    counter's module tracker hooks every submodule input that requires
    grad, and fails on a parameter passed as one under no_grad."""
    params = [p for p in fn.parameters() if p.requires_grad] if isinstance(fn, nn.Module) else []
    for p in params:
        p.requires_grad_(False)
    try:
        with FlopCounterMode(display=False, custom_mapping=INT_MM_FLOPS) as counter, \
                torch.no_grad():
            fn(*args, **kwargs)
    finally:
        for p in params:
            p.requires_grad_(True)
    return counter.get_total_flops() / 2
