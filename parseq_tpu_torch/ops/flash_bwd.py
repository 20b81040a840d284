"""Encoder self-attention with a hand-written backward: kernel B4 (port of
parseq_tpu/ops/flash_bwd.py: attention_flashbwd, _attn_fwd_ref,
_one_head_bwd, _bwd_pallas).

`attention_flashbwd(qkv, num_heads, scale)` is an autograd Function on the
packed (B, L, 3D) q|k|v projection. Its forward is the plain einsum forward
of the JAX package (`_attn_fwd_ref`: f32 scores, f32 softmax, the
probabilities cast to the compute dtype before PV). Its backward is
`attention_flashbwd_backward`, which launches the CUDA kernel
`csrc/flash_bwd.cu` on a CUDA tensor (or raises) and computes the plain
PyTorch version, `attention_flashbwd_backward_reference`, on a CPU tensor.
The gradient is written straight into one packed (B, L, 3D) tensor through
strided (B, h, L, dh) views, so the q|k|v split needs no copies either way.

Numerics of both backward versions (those of the TPU kernel): dO is cast
to q's dtype, then q, k, v and dO are widened to f32; P, dP and dS are f32
and every product is taken in f32; dq, dk and dv are stored in q's dtype.
The bf16 kernel runs the products on the tensor cores: Q K^T and dO V^T are
exact bf16 products summed in f32, and the three products with P or dS take
them as bf16 hi + lo pairs, 16 significant bits (csrc/flash_bwd.cu).

The card check of B4 (`chip_smoke.py` and the `gpu` tests) is defined here
once: `check_operands` draws inputs whose scores spread by about
CHECK_SCORE_STD, and `check_errors` holds |kernel - plain| of each of dq, dk
and dv, relative to its max|plain|, against CHECK_LIMITS.
"""

from __future__ import annotations

import ctypes
import math

import torch

from parseq_tpu_torch.kernels.build import CSRC, load_library

HEAD_DIMS = (32, 64)  # the kernel's head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made by attention_flashbwd_backward in this process.
launches = 0


def split_heads(x, num_heads):
    """(B, L, D) -> (B, h, L, dh) view (no copy for any row stride)."""
    B, L, D = x.shape
    return x.view(B, L, num_heads, D // num_heads).transpose(1, 2)


def attention_forward_reference(q, k, v, scale):
    """Plain forward on (B, h, L, dh): softmax(scale q k^T) in f32, the
    probabilities cast to q's dtype before PV (`_attn_fwd_ref`)."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)
    return p.to(q.dtype) @ v


def attention_flashbwd_backward_reference(q, k, v, do, scale):
    """Plain PyTorch version of kernel B4 (`_one_head_bwd` for every batch row
    and head). q, k, v, do: (B, h, L, dh), any strides. Returns dq, dk, dv in
    q's dtype."""
    grads = _grads(q.float(), k.float(), v.float(), do.to(q.dtype).float(), scale)
    return tuple(g.to(q.dtype) for g in grads)


def _grads(q, k, v, do, scale):
    """`_one_head_bwd` on f32 (..., L, dh) tensors: dq, dk, dv in f32."""
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    return dq, dk, dv


# The card check of B4 against its plain version. Inputs: q and k ~ N(0,
# sigma^2) with sigma^2 * sqrt(dh) * scale = CHECK_SCORE_STD, so the scores
# spread by about CHECK_SCORE_STD and every key's weight shows; v and dO ~
# N(0, 1).
CHECK_SCORE_STD = 2.75
# Limits on (max, mean) of |kernel - plain| / max|plain|, per gradient. bf16:
# an output may round to the neighbouring bf16 value (at most one step,
# 2^-8 of |x| <= 2^-8 of the largest), so the max limit is 2^-7; the mean
# limit 2^-17 sits ~45x above the P and dS hi + lo split of the kernel and
# ~14x below P and dS rounded once to bf16 (the library's rounding points),
# which a CPU emulation of both gives at (8, 6, 128, 64)
# (tests/test_torch_flash_bwd.py plants that fault and others). f32: only
# the order of the f32 sums differs.
CHECK_LIMITS = {torch.bfloat16: (2.0 ** -7, 2.0 ** -17), torch.float32: (1e-5, 1e-6)}


def check_operands(B, h, L, dh, generator, dtype=torch.bfloat16):
    """(q, k, v, do, dq, dk, dv, scale) for the card check: q, k, v as (B, h,
    L, dh) views of one packed (B, L, 3 h dh) projection, do contiguous, and
    dq, dk, dv views of one packed gradient (the training path's layout),
    drawn from `generator` on its device."""
    D, scale = h * dh, dh ** -0.5
    sigma = math.sqrt(CHECK_SCORE_STD / (math.sqrt(dh) * scale))
    dev = generator.device
    qkv = torch.randn(B, L, 3 * D, generator=generator, device=dev)
    qkv[..., :2 * D] *= sigma
    qkv = qkv.to(dtype)
    do = torch.randn(B, h, L, dh, generator=generator, device=dev).to(dtype)
    grad = torch.empty_like(qkv)
    q, k, v = (split_heads(qkv[..., i * D:(i + 1) * D], h) for i in range(3))
    dq, dk, dv = (split_heads(grad[..., i * D:(i + 1) * D], h) for i in range(3))
    return q, k, v, do, dq, dk, dv, scale


def check_errors(got, want):
    """[(max, mean) of |got - want| over max|want|] for each of dq, dk, dv."""
    errs = []
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        top = w.float().abs().max()
        errs.append((float(diff.max() / top), float(diff.mean() / top)))
    return errs


def check_passes(got, want):
    """True when each of got's dq, dk, dv is finite, of want's shape and
    type, and within CHECK_LIMITS of it."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g).all():
            return False
    limit_max, limit_mean = CHECK_LIMITS[want[0].dtype]
    return all(m <= limit_max and a <= limit_mean for m, a in check_errors(got, want))


def library():
    """Build (first use) and load the kernel library with its ctypes signatures."""
    lib = load_library('flash_bwd', (CSRC / 'flash_bwd.cu',))
    fn = lib.parseq_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.parseq_flash_bwd_max_len.argtypes = []
        lib.parseq_flash_bwd_max_len.restype = ctypes.c_int
        lib.parseq_flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.parseq_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def kernel_takes(L, dh):
    """Whether kernel B4 takes this sequence length and head width."""
    return L % 8 == 0 and dh in HEAD_DIMS and L <= 256


def attention_flashbwd_backward(q, k, v, do, scale, dq, dk, dv):
    """Attention backward (kernel B4): writes dq, dk, dv (B, h, L, dh) in place.

    q, k, v, do and the outputs may be strided views (unit channel stride),
    e.g. of the packed projection and of its packed gradient. On CPU tensors
    this is the plain version; a CUDA tensor launches the kernel or raises."""
    global launches
    tensors = (q, k, v, do, dq, dk, dv)
    if all(t.device.type == 'cpu' for t in tensors):
        for out, g in zip((dq, dk, dv), attention_flashbwd_backward_reference(q, k, v, do, scale)):
            out.copy_(g)
        return
    if q.dim() != 4:
        raise ValueError(f'attention_flashbwd_backward: q must be (B, h, L, dh), got '
                         f'{tuple(q.shape)}')
    B, H, L, dh = q.shape
    if q.dtype not in _DTYPES or not kernel_takes(L, dh) or not scale > 0:
        raise ValueError(f'attention_flashbwd_backward: the kernel takes f32 or bf16, L <= 256 '
                         f'with L % 8 == 0, dh in {HEAD_DIMS} and scale > 0; got (B, h, L, dh) = '
                         f'{(B, H, L, dh)} {q.dtype}, scale {scale}')
    if q.device.type != 'cuda':
        raise ValueError(f'attention_flashbwd_backward: unsupported device {q.device}')
    do = do.to(q.dtype)
    for name, t in zip(('q', 'k', 'v', 'do', 'dq', 'dk', 'dv'), (q, k, v, do, dq, dk, dv)):
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != (B, H, L, dh):
            raise ValueError(f'attention_flashbwd_backward: {name} must be a {(B, H, L, dh)} '
                             f'{q.dtype} tensor on {q.device}, got {tuple(t.shape)} {t.dtype} '
                             f'on {t.device}')
        if t.stride(3) != 1:
            raise ValueError(f'attention_flashbwd_backward: {name} needs unit channel stride, '
                             f'got strides {t.stride()}')
    lib = library()
    # f32 operands take the kernel's two f32 passes, with row statistics between them.
    stats = (torch.empty(B * H * L * 3, dtype=torch.float32, device=q.device)
             if q.dtype == torch.float32 else None)
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, do, dq, dk, dv)
                                         for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.parseq_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              None if stats is None else stats.data_ptr(),
                              strides, B, H, L, dh, _DTYPES[q.dtype], scale, stream)
    if rc != 0:
        raise RuntimeError(f'attention backward kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_flash_bwd_error_string(rc).decode()})')
    launches += 1


class _AttentionFlashBwd(torch.autograd.Function):
    """Packed q|k|v (B, L, 3D) -> o (B, L, D); backward through kernel B4."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        D = qkv.shape[-1] // 3
        q, k, v = (split_heads(qkv[..., i * D:(i + 1) * D], num_heads) for i in range(3))
        o = attention_forward_reference(q, k, v, scale)
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], D)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        D, h = qkv.shape[-1] // 3, ctx.num_heads
        grad = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        q, k, v = (split_heads(qkv[..., i * D:(i + 1) * D], h) for i in range(3))
        dq, dk, dv = (split_heads(grad[..., i * D:(i + 1) * D], h) for i in range(3))
        attention_flashbwd_backward(q, k, v, split_heads(do.contiguous(), h), ctx.scale, dq, dk, dv)
        return grad, None, None


def attention_flashbwd(qkv, num_heads, scale):
    """Unmasked multi-head self-attention on the packed (B, L, 3D) projection
    with the kernel-B4 backward. Returns (B, L, D) in qkv's dtype."""
    return _AttentionFlashBwd.apply(qkv, num_heads, scale)
