"""Encoder self-attention, the fused no-split attention kernel B2 and the
head-split attention kernel B3 (port of parseq_tpu/ops/attention.py:
encoder_self_attention, fused_attention_nosplit, _reference_nosplit,
fused_attention, _reference_attention, _mha_flashbwd).

`encoder_self_attention` takes the packed q|k|v projection and routes it,
with the JAX package's gate: sequences of at least KERNEL_MIN_LEN go to
`fused_attention_nosplit`, which launches the hand-written CUDA kernel
`csrc/attention.cu` on a CUDA tensor (or raises) and computes its plain
PyTorch version, `fused_attention_nosplit_reference`, on a CPU tensor.
Under autograd (training), a shorter sequence whose shape the backward
kernel takes (L a multiple of 8, dh 32 or 64) goes to
`flash_bwd.attention_flashbwd`, the counterpart of the JAX package's
`_mha_flashbwd`: einsum forward, kernel-B4 backward. Everything else, and
everything inside `kernels.plain()`, runs `layers.packed_self_attention`.

`fused_attention` (B3) is the same computation on the head-split (BH, L, dh)
layout; the JAX package calls it from no model, only from its tests. Both
are autograd Functions, as the JAX package's custom VJPs are: the forward
is the kernel (its plain version on a CPU tensor), the backward recomputes
through autograd of the plain version from the saved q, k, v.

Numerics of both versions (those of the TPU kernels): scores are f32 sums of
products times `scale`; softmax in f32, normalised before the probabilities
are cast to v's dtype; PV in v's dtype with f32 accumulation. The kernel
takes bf16 or f32 operands (all three of one type; o in that type), dh = 64,
L <= 416 and scale > 0, and raises on anything else.

The card check of B2 and B3 (`chip_smoke.py` and the `gpu` tests) is
defined here once: `check_operands` draws inputs whose scores spread by
about CHECK_SCORE_STD, and `check_errors` holds |kernel - plain| relative
to max|plain| against CHECK_LIMITS.
"""

from __future__ import annotations

import ctypes
import math

import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.kernels.build import CSRC, load_library
from parseq_tpu_torch.ops import flash_bwd, layers

# Kernel gate, as in the JAX package (its value was measured on a TPU; the
# port keeps it until its own gate is measured on the H100).
KERNEL_MIN_LEN = 192
HEAD_DIM = 64  # the kernel's head width (dh of every L >= 192 user)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # q, k, v and o, all of one type

# Kernel launches made in this process by fused_attention_nosplit (B2) and
# by fused_attention (B3).
launches = 0
split_launches = 0


def _attend(q, k, v, scale):
    """Attention on (..., L, dh) at the kernels' rounding points: f32 scores
    and softmax, p normalised before its cast to v's dtype, PV in v's dtype
    with f32 sums."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)
    return p.to(v.dtype) @ v


def fused_attention_nosplit_reference(q, k, v, num_heads, scale):
    """Plain PyTorch version of kernel B2. q, k, v: (B, L, D), any strides.
    Returns (B, L, D) in v's dtype."""
    B, L, D = q.shape
    dh = D // num_heads

    def split(x):
        return x.reshape(B, L, num_heads, dh).transpose(1, 2)

    return _attend(split(q), split(k), split(v), scale).transpose(1, 2).reshape(B, L, D)


def fused_attention_reference(q, k, v, scale):
    """Plain PyTorch version of kernel B3 (`_reference_attention`). q, k, v:
    (BH, L, dh), any strides. Returns (BH, L, dh) in v's dtype."""
    return _attend(q, k, v, scale)


# The card check of B2 and B3 against their plain versions. Inputs: q and k
# ~ N(0, sigma^2) with sigma^2 * sqrt(dh) * scale = CHECK_SCORE_STD, v ~ N(0,
# 1), so the scores spread by about CHECK_SCORE_STD (not ~1, where softmax
# is near uniform and o is small): every key's weight shows in o.
CHECK_SCORE_STD = 2.75
# Limits on (max, mean) of |kernel - plain| / max|plain|. Both sides take
# the same rounding points with the f32 sums in another order. bf16: an
# output may round to the neighbouring bf16 value, at most one step,
# 2^-7 of the largest |o|; such flips are rare (a CPU emulation of another
# sum order gives a mean of ~1e-7), so the mean limit 2^-14 sits far above
# them and below the planted faults (tests/test_torch_attention.py): the
# unnormalised-p fault gives a mean of ~2e-4, the others exceed the max
# limit 50-fold. f32: only the order of the sums differs (B4's f32 limit).
CHECK_LIMITS = {torch.bfloat16: (2.0 ** -7, 2.0 ** -14), torch.float32: (1e-5, 1e-6)}


def check_operands(B, L, D, dh, scale, generator, dtype=torch.bfloat16):
    """q, k, v (B, L, D) for the card check, as column views of one packed
    (B, L, 3D) tensor (the layout of the encoder's projection), drawn from
    `generator` on its device."""
    sigma = math.sqrt(CHECK_SCORE_STD / (math.sqrt(dh) * scale))
    qkv = torch.randn(B, L, 3 * D, generator=generator, device=generator.device)
    qkv[..., :2 * D] *= sigma
    qkv = qkv.to(dtype)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def check_errors(got, want):
    """(max, mean) of |got - want| over max|want|, in f32."""
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    return float(diff.max() / top), float(diff.mean() / top)


def check_passes(got, want):
    """True when got is finite, of want's shape and type, and within
    CHECK_LIMITS of it."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        return False
    rel_max, rel_mean = check_errors(got, want)
    limit_max, limit_mean = CHECK_LIMITS[want.dtype]
    return rel_max <= limit_max and rel_mean <= limit_mean


def _plain_vjp(plain, inputs, grad, *args):
    """Gradients of plain(*inputs, *args) for the output cotangent `grad`,
    by autograd of the plain version recomputed from the inputs (the JAX
    package's `_bwd` and `_ns_bwd`)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(plain(*leaves, *args), leaves, grad)


def library():
    """Build (first use) and load the kernel library with its ctypes signatures."""
    lib = load_library('attention', (CSRC / 'attention.cu',))
    fn = lib.parseq_attention_nosplit
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.parseq_attention_split.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 7
                                               + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p])
        lib.parseq_attention_split.restype = ctypes.c_int
        lib.parseq_attention_max_len.argtypes = []
        lib.parseq_attention_max_len.restype = ctypes.c_int
        lib.parseq_attention_error_string.argtypes = [ctypes.c_int]
        lib.parseq_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_operand(op, name, t, q):
    """q, k and v: one shape, one device and one type, bf16 or f32; unit
    channel stride, strides that are multiples of 8, a 16-byte aligned start."""
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f'{op}: the kernel takes bf16 or f32 operands, got {q.dtype}')
    if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
        raise ValueError(f'{op}: {name} must be a {tuple(q.shape)} {q.dtype} tensor on '
                         f'{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}')
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f'{op}: {name} needs unit channel stride, batch and '
                         f'row strides that are multiples of 8 and a 16-byte aligned start, got '
                         f'strides {t.stride()} at offset {t.storage_offset()}')


def _on_cpu(*tensors):
    return all(t.device.type == 'cpu' for t in tensors)


def _launch(op, entry, q, k, v, scale, head_ok, *dims):
    """Checks CUDA operands q, k, v of one (B, L, D) shape, launches the
    library's `entry` on them and returns o (B, L, D) in their type.
    `head_ok` is the caller's test of the head width."""
    if q.device.type != 'cuda':
        raise ValueError(f'{op}: unsupported device {q.device}')
    if q.dim() != 3:
        raise ValueError(f'{op}: q must be 3-d, got {tuple(q.shape)}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_operand(op, name, t, q)
    lib = library()
    max_len = lib.parseq_attention_max_len()
    if not (head_ok and q.shape[1] <= max_len and scale > 0):
        raise ValueError(f'{op}: the kernel needs D == {HEAD_DIM} * heads, L <= {max_len} and '
                         f'scale > 0 (shape {tuple(q.shape)}, dims {dims}, scale {scale})')
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                             v.stride(1), *dims, scale, q.dtype == torch.float32, stream)
    if rc != 0:
        raise RuntimeError(f'attention kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_attention_error_string(rc).decode()})')
    return out


def _attention_nosplit(q, k, v, num_heads, scale):
    """Kernel B2's forward: the plain version on CPU tensors; a CUDA tensor
    launches the kernel or raises."""
    global launches
    if _on_cpu(q, k, v):
        return fused_attention_nosplit_reference(q, k, v, num_heads, scale)
    out = _launch('fused_attention_nosplit', 'parseq_attention_nosplit', q, k, v, scale,
                  q.shape[-1] == num_heads * HEAD_DIM, *q.shape, num_heads)
    launches += 1
    return out


class _FusedAttentionNosplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _attention_nosplit(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, grad):
        return (*_plain_vjp(fused_attention_nosplit_reference, ctx.saved_tensors, grad,
                            ctx.num_heads, ctx.scale), None, None)


def fused_attention_nosplit(q, k, v, num_heads, scale):
    """Fused multi-head self-attention on (B, L, D), no mask (kernel B2).

    q, k, v may be strided views (e.g. column slices of a packed (B, L, 3D)
    projection). Returns o (B, L, D) contiguous. On CPU tensors the forward
    is the plain version; a CUDA tensor launches the kernel or raises. Under
    autograd the backward recomputes through the plain version."""
    return _FusedAttentionNosplit.apply(q, k, v, num_heads, scale)


def _attention_split(q, k, v, scale):
    """Kernel B3's forward: the plain version on CPU tensors; a CUDA tensor
    launches the kernel or raises."""
    global split_launches
    if _on_cpu(q, k, v):
        return fused_attention_reference(q, k, v, scale)
    out = _launch('fused_attention', 'parseq_attention_split', q, k, v, scale,
                  q.shape[-1] == HEAD_DIM, *q.shape[:2])
    split_launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attention_split(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        return (*_plain_vjp(fused_attention_reference, ctx.saved_tensors, grad, ctx.scale), None)


def fused_attention(q, k, v, scale):
    """Fused attention on the head-split layout, no mask (kernel B3). q, k, v:
    (BH, L, dh) with unit channel stride; returns (BH, L, dh) contiguous. On
    CPU tensors the forward is the plain version; a CUDA tensor launches the
    kernel (bf16 or f32, dh = 64, L <= 416) or raises. Under autograd the backward
    recomputes through the plain version."""
    return _FusedAttention.apply(q, k, v, scale)


def encoder_self_attention(x, in_weight, in_bias, out_weight, out_bias, num_heads, *,
                           dropout_rate=0.0, rng=None):
    """layers.mha(x, x, x) with no mask, on one packed q|k|v projection
    (one int8 product where the weights are int8, ops/quant.py). Unless
    kernels.plain() is open, L >= KERNEL_MIN_LEN feeds kernel B2 through
    strided views of it (no copies), and a shorter sequence under autograd
    feeds attention_flashbwd (kernel B4 in the backward) where that kernel
    takes the shape; anything else is layers.packed_self_attention. With
    attention-probability dropout (dropout_rate > 0 and a generator `rng`)
    it is layers.mha with that dropout: no kernel drops probabilities."""
    if dropout_rate > 0.0 and rng is not None:
        return layers.mha(x, x, x, in_weight, in_bias, out_weight, out_bias, num_heads=num_heads,
                          dropout_rate=dropout_rate, rng=rng)
    B, L, D = x.shape
    scale = 1.0 / math.sqrt(D // num_heads)
    qkv = layers.linear(x, in_weight, in_bias)
    if kernels.enabled() and L >= KERNEL_MIN_LEN:
        o = fused_attention_nosplit(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], num_heads,
                                    scale)
    elif kernels.enabled() and qkv.requires_grad and flash_bwd.kernel_takes(L, D // num_heads):
        o = flash_bwd.attention_flashbwd(qkv, num_heads, scale)
    else:
        o = layers.packed_self_attention(qkv, num_heads)
    return layers.linear(o, out_weight, out_bias)
