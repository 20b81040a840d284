"""Core layers as plain tensor functions (port of parseq_tpu/ops/layers.py).

Conventions, kept from the JAX package so both compute the same numbers:
  * Weights are in torch layout, ``(out_features, in_features)``; the
    modules that hold them use the reference state_dict names.
  * Parameters stay float32 and are cast to the activation dtype at each
    use, so one set of weights serves both f32 and bf16 compute.
  * Attention masks are additive float biases (0 = allowed, NEG_INF =
    masked). NEG_INF is finite so a fully masked softmax row has no NaN.
  * LayerNorm statistics and softmax are float32 whatever the compute dtype.
  * Dropout takes its bits from an explicit torch.Generator or from
    pregenerated bits (uint8, or 16-bit values in uint16/int32), as the JAX
    package's takes a key or pregenerated bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from parseq_tpu_torch.ops import quant

NEG_INF = -1e9  # finite "minus infinity": avoids NaN rows in fully-masked softmax


def linear(x, weight, bias=None):
    """y = x @ weight.T + bias, in x's dtype. An Int8Weight (ops/quant.py,
    the int8 serving path) runs quant.int8_linear instead."""
    if isinstance(weight, quant.Int8Weight):
        return quant.int8_linear(x, weight, bias)
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


def dropout(x, rate, rng=None):
    """Inverted dropout (JAX `layers.dropout` semantics). Identity when rng is
    None (eval) or rate == 0; zeros when rate >= 1.

    rng: a torch.Generator on x's device (16-bit bits of x's shape are drawn
    from it), or pregenerated bits broadcastable against x: uint8 bits drop
    where bits < round(rate*256) and scale survivors by the QUANTIZED keep
    rate (rate 0.1 -> 26/256), so the result stays unbiased; 16-bit bits
    (uint16 or int32 values in [0, 65536)) drop where bits < round(rate*65536)
    and scale by 1 / (1 - rate)."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if isinstance(rng, torch.Tensor) and rng.dtype == torch.uint8:
        thr8 = min(int(round(rate * 256.0)), 255)
        if thr8 == 0:
            raise ValueError(f'dropout rate {rate} is not representable in uint8 bulk bits '
                             f'(round(rate*256) == 0); pass 16-bit bits')
        keep_q = torch.tensor(1.0 - thr8 / 256.0, dtype=x.dtype)
        return torch.where(rng >= thr8, x / keep_q, 0).to(x.dtype)
    # the keep rate rounded to x's dtype first, as JAX's weakly typed scalar is
    keep = torch.tensor(1.0 - rate, dtype=x.dtype)
    thr = min(int(round(rate * 65536.0)), 65535)
    if isinstance(rng, torch.Generator):
        bits = torch.randint(0, 65536, x.shape, generator=rng, device=x.device, dtype=torch.int32)
    else:
        bits = rng.to(torch.int32)  # uint16 has no comparison kernels in torch
    return torch.where(bits >= thr, x / keep, 0).to(x.dtype)


def bool_to_bias(mask, dtype=torch.float32):
    """torch-convention boolean mask (True = masked) -> additive bias.

    Built from Python scalars on the mask's device: a scalar tensor made
    there would be a pageable host-to-device copy, which waits for every
    kernel queued before it."""
    return torch.where(mask, NEG_INF, 0.0).to(dtype)


def attention(q, k, v, *, bias=None, dropout_rate=0.0, rng=None):
    """Scaled dot-product attention. q: (..., h, Lq, dh), k/v: (..., h, Lk, dh)
    (leading dims broadcast).

    Scores and softmax in float32; the probabilities are cast to v's dtype
    before the (training-only) probability dropout and the PV product."""
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    return dropout(probs.to(v.dtype), dropout_rate, rng) @ v


def _split_heads(x, num_heads):
    *lead, l, d = x.shape
    return x.reshape(*lead, l, num_heads, d // num_heads).transpose(-2, -3)


def _merge_heads(x):
    *lead, h, l, dh = x.shape
    return x.transpose(-2, -3).reshape(*lead, l, h * dh)


def mha(q, k, v, in_weight, in_bias, out_weight, out_bias, *, num_heads,
        attn_bias=None, key_padding_mask=None, dropout_rate=0.0, rng=None):
    """Multi-head attention with nn.MultiheadAttention semantics.

    q: (..., B, Lq, D); k, v: (..., B, Lk, D), leading dims broadcast (the
    permutation axis of the training loss). `in_weight` (3D, D) / `in_bias`
    (3D,) hold the packed q|k|v projections (nn.MultiheadAttention.in_proj_*
    and timm's qkv Linear alike). attn_bias: additive, broadcastable to
    (..., B, h, Lq, Lk); a 2-D or 3-D bias gets leading unit dims.
    key_padding_mask: bool (B, Lk), True = ignore that key. dropout_rate/rng:
    attention-probability dropout (see `dropout`).
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

    out = attention(qh, kh, vh, bias=bias, dropout_rate=dropout_rate, rng=rng)
    return linear(_merge_heads(out), out_weight, out_bias)


def packed_self_attention(qkv, num_heads):
    """Unmasked attention of a packed (..., L, 3D) q|k|v projection: mha's
    math after its in-projection."""
    q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    return _merge_heads(attention(q, k, v))


def mlp(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias, *, dropout_rate=0.0, rng=None):
    """fc1 -> gelu -> (dropout) -> fc2."""
    h = dropout(gelu(linear(x, fc1_weight, fc1_bias)), dropout_rate, rng)
    return linear(h, fc2_weight, fc2_bias)


def ce_ignore_pad(logits, targets, pad_id, num_classes):
    """Token-mean cross entropy of logits (..., C) against targets (...) with
    PAD ignored, in float32. Returns (loss, numel): numel counts the
    non-PAD targets, and the loss is 0 when there are none."""
    valid = targets != pad_id
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long().clamp(0, num_classes - 1)[..., None])[..., 0]
    numel = valid.sum()
    return (nll * valid).sum() / numel.clamp(min=1), numel


def embedding(ids, weight, dtype=torch.float32):
    return weight.to(dtype)[ids]
