"""Encoder self-attention (port of the plain branch of
parseq_tpu/ops/attention.py:encoder_self_attention).

The JAX package sends sequences of length >= KERNEL_MIN_LEN to its Pallas
attention kernel and shorter ones through plain einsum attention. The
PARSeq encoder (L=128) is below the gate, so this port has only the plain
branch; the long-sequence kernel is ROADMAP queue B item B2.
"""

from __future__ import annotations

from parseq_tpu_torch.ops import layers

KERNEL_MIN_LEN = 192


def encoder_self_attention(x, in_weight, in_bias, out_weight, out_bias, num_heads):
    """layers.mha(x, x, x) with no mask, for L < KERNEL_MIN_LEN."""
    if x.shape[1] >= KERNEL_MIN_LEN:
        raise NotImplementedError(
            f'encoder self-attention at L={x.shape[1]} >= {KERNEL_MIN_LEN} runs through '
            'the fused attention kernel, which is not ported yet (ROADMAP queue B, kernel B2)')
    return layers.mha(x, x, x, in_weight, in_bias, out_weight, out_bias, num_heads=num_heads)
