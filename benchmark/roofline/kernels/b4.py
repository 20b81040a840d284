"""B4, the attention backward (ops/flash_bwd.py -> csrc/flash_bwd.cu).
Copied from the repository's chip smoke test, b4_bound."""

from roofline.bounds import bound

# the CUDA function's name as the profiler gives it
PATTERN = r'\bbwd_kernel\b'


def bound_ms(B, h, L, dh, elt=2):
    """q, k, v, dO read once, dq, dk, dv written once; QK^T, dO V^T, P^T dO,
    dS K, dS^T Q."""
    flops = 10 * B * h * L * L * dh
    return bound(7 * B * h * L * dh * elt, **({'bf16_flops': flops} if elt == 2
                                             else {'f32_flops': flops}))
