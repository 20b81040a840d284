"""B1, the fused greedy AR decode (ops/ar_kernel.py -> csrc/ar_decode.cu).
Copied from the repository's chip smoke test, b1_bound."""

from roofline.bounds import bound

# the CUDA function's name as the profiler gives it
PATTERN = r'\bar_decode_kernel\b'


def bound_ms(B, M, D, heads, n, C, F, num_tokens):
    """From memory (B, M, D) bf16 to logits (B, n, C) f32: reads memory and
    the bf16 decoder weights once, writes the logits. bf16-input products:
    the cross-attention K/V of memory, then per step and row the self k|v,
    self out, cross q, cross out, MLP and head; f32: the queries against the
    memory keys and values and the self-attention cache (on average
    (n + 1) / 2 keys)."""
    weights = 2 * (2 * D * D + 3 * D * D + 2 * D * F + C * D + num_tokens * D)
    bytes_moved = B * M * D * 2 + weights + B * n * C * 4
    bf16 = 2 * B * M * D * 2 * D + B * n * 2 * (2 * D * D + 3 * D * D + 2 * D * F + D * C)
    f32 = B * n * (2 * 2 * M * D + 2 * 2 * (n + 1) / 2 * D)
    return bound(bytes_moved, bf16, f32)
