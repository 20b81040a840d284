"""Core layers as plain tensor functions (port of parseq_tpu/ops/layers.py).

Conventions, kept from the JAX package so both compute the same numbers:
  * Weights are in torch layout, ``(out_features, in_features)``; the
    modules that hold them use the reference state_dict names.
  * Parameters stay float32 and are cast to the activation dtype at each
    use, so one set of weights serves both f32 and bf16 compute.
  * Attention masks are additive float biases (0 = allowed, NEG_INF =
    masked). NEG_INF is finite so a fully masked softmax row has no NaN.
  * LayerNorm statistics and softmax are float32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9  # finite "minus infinity": avoids NaN rows in fully-masked softmax


def linear(x, weight, bias=None):
    """y = x @ weight.T + bias, in x's dtype."""
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layer_norm(x, weight, bias, *, eps=1e-5):
    """LayerNorm over the last axis; statistics in float32, result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def gelu(x):
    """GELU, dtype-adaptive as in the JAX package: exact erf form at f32,
    tanh form at bf16 (the two differ by far less than bf16 rounding)."""
    return F.gelu(x, approximate='tanh' if x.dtype == torch.bfloat16 else 'none')


def bool_to_bias(mask, dtype=torch.float32):
    """torch-convention boolean mask (True = masked) -> additive bias."""
    return torch.where(mask, torch.tensor(NEG_INF, dtype=dtype, device=mask.device),
                       torch.tensor(0.0, dtype=dtype, device=mask.device))


def attention(q, k, v, *, bias=None):
    """Scaled dot-product attention. q: (..., h, Lq, dh), k/v: (..., h, Lk, dh).

    Scores and softmax in float32; the probabilities are cast to v's dtype
    before the PV product."""
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype) @ v


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def mha(q, k, v, in_weight, in_bias, out_weight, out_bias, *, num_heads,
        attn_bias=None, key_padding_mask=None):
    """Multi-head attention with nn.MultiheadAttention semantics.

    q: (B, Lq, D); k, v: (B, Lk, D). `in_weight` (3D, D) / `in_bias` (3D,)
    hold the packed q|k|v projections (nn.MultiheadAttention.in_proj_* and
    timm's qkv Linear alike). attn_bias: additive, broadcastable to
    (B, h, Lq, Lk). key_padding_mask: bool (B, Lk), True = ignore that key.
    """
    wq, wk, wv = in_weight.chunk(3)
    bq, bk, bv = in_bias.chunk(3)
    qh = _split_heads(linear(q, wq, bq), num_heads)
    kh = _split_heads(linear(k, wk, bk), num_heads)
    vh = _split_heads(linear(v, wv, bv), num_heads)

    bias = None
    if attn_bias is not None:
        bias = attn_bias
        while bias.dim() < 4:
            bias = bias[None]
    if key_padding_mask is not None:
        kp = bool_to_bias(key_padding_mask)[:, None, None, :]  # (B, 1, 1, Lk)
        bias = kp if bias is None else bias + kp

    out = attention(qh, kh, vh, bias=bias)
    return linear(_merge_heads(out), out_weight, out_bias)


def mlp(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias):
    """fc1 -> gelu -> fc2."""
    return linear(gelu(linear(x, fc1_weight, fc1_bias)), fc2_weight, fc2_bias)


def embedding(ids, weight, dtype=torch.float32):
    return weight.to(dtype)[ids]
