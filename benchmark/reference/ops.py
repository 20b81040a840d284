"""The reference's arithmetic: float32 products with TF32 off, and the
lower precision its control computes in.

`Ops('f32')` is the reference. `Ops('fp8')` is the control of a bf16
configuration put in the program's place, as fp8 training computes: every
product takes both operands rounded to float8 e4m3 with one scale a tensor
(amax / 448), summed in float32; in the backward pass the incoming gradient
is rounded to float8 e5m2 the same way (amax / 57344) before the two
products with the saved e4m3 operands.
"""

from __future__ import annotations

import math

import torch

# the largest finite float8 e4m3fn and e5m2
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_f32():
    """Turn TF32 off for products and convolutions in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def _round(t, dtype):
    """t rounded to `dtype` with one scale for the tensor, back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX[dtype]
    return (t / scale).to(dtype).float() * scale


class _Fp8Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, torch.float8_e4m3fn), _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = a.shape, b.shape
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        sa, sb = ctx.shapes
        return ((qg @ qb.transpose(-1, -2)).sum_to_size(sa),
                (qa.transpose(-1, -2) @ qg).sum_to_size(sb))


class Ops:
    def __init__(self, precision='f32'):
        if precision not in ('f32', 'fp8'):
            raise ValueError(f'precision must be f32 or fp8, got {precision!r}')
        self.precision = precision

    def mm(self, a, b):
        """a (..., K) @ b (..., K, N)."""
        if self.precision == 'fp8':
            return _Fp8Mm.apply(a, b)
        return a @ b

    def linear(self, x, w, b=None):
        """x @ w.T + b, w in torch layout (out, in)."""
        y = self.mm(x, w.t())
        return y if b is None else y + b


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu(x):
    """The exact GELU of nn.GELU()."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def split_heads(x, h):
    *lead, n, d = x.shape
    return x.reshape(*lead, n, h, d // h).transpose(-2, -3)


def merge_heads(x):
    *lead, h, n, dh = x.shape
    return x.transpose(-2, -3).reshape(*lead, n, h * dh)


def attend(ops, q, k, v, mask=None, drop=None):
    """softmax(q k^T / sqrt(dh)) v on (..., h, n, dh); mask: bool, True where
    a key is hidden, broadcast against the scores; drop: a function applied
    to the probabilities (training dropout)."""
    s = ops.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = drop(p)
    return ops.mm(p, v)


def normalize_u8(images):
    """uint8 (B, H, W, 3) -> float32 in [-1, 1] (the released transforms:
    ToTensor, then Normalize(0.5, 0.5))."""
    return (images.float() / 255.0 - 0.5) / 0.5
