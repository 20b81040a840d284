"""B5, every pre-LN encoder block in one launch (ops/encoder_kernel.py ->
csrc/encoder_blocks.cu). Copied from the repository's chip smoke test,
b5_bound."""

from roofline.bounds import bound

# the CUDA function's name as the profiler gives it
PATTERN = r'\bencoder_blocks_kernel\b'


def bound_ms(B, L, D, F, depth):
    """x read once and out written once (bf16), every layer's weights (bf16)
    and LayerNorm parameters (f32) read once; per layer the four products
    and the attention's QK^T and PV in bf16."""
    weights = 2 * (3 * D * D + D * D + 2 * D * F + 3 * D + D + F + D) + 4 * 4 * D
    bf16 = 2 * B * L * D * (3 * D + D + 2 * F) + 4 * B * L * L * D
    return bound(2 * B * L * D * 2 + depth * weights, bf16_flops=depth * bf16)
