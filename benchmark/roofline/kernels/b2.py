"""B2, fused self-attention (ops/attention.py -> csrc/attention.cu). Copied
from the repository's chip smoke test, b2_bound."""

from roofline.bounds import bound

# the CUDA function's name as the profiler gives it
PATTERN = r'\battention_kernel\b'


def bound_ms(B, L, h, D, elt=2):
    """q, k, v read once, o written once; QK^T and PV on inputs of the
    operands' type."""
    flops = 4 * B * h * L * L * (D // h)
    return bound(4 * B * L * D * elt, **({'bf16_flops': flops} if elt == 2
                                          else {'f32_flops': flops}))
