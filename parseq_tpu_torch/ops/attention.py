"""Encoder self-attention, the fused no-split attention kernel B2 and the
head-split attention kernel B3 (port of parseq_tpu/ops/attention.py:
encoder_self_attention, fused_attention_nosplit, _reference_nosplit,
fused_attention, _reference_attention, force_einsum, _mha_flashbwd).

`encoder_self_attention` routes as the JAX package does: sequences shorter
than KERNEL_MIN_LEN go through plain einsum attention (`layers.mha`);
longer ones take the packed q|k|v projection and go to
`fused_attention_nosplit`, which launches the hand-written CUDA kernel
`csrc/attention.cu` on a CUDA tensor (or raises) and computes its plain
PyTorch version, `fused_attention_nosplit_reference`, on a CPU tensor.
Under autograd (training), a sequence shorter than KERNEL_MIN_LEN whose
shape the backward kernel takes (L a multiple of 8, dh 32 or 64) sends the
packed projection to `flash_bwd.attention_flashbwd`, the counterpart of the
JAX package's `_mha_flashbwd`: einsum forward, kernel-B4 backward.

`fused_attention` (B3) is the same computation on the head-split (BH, L, dh)
layout; the JAX package calls it from no model, only from its tests. Both
are autograd Functions, as the JAX package's custom VJPs are: the forward
is the kernel (its plain version on a CPU tensor), the backward recomputes
through autograd of the plain version from the saved q, k, v.

Numerics of both versions (those of the TPU kernels): scores are f32 sums of
bf16 products times `scale`; softmax in f32, normalised before the
probabilities are cast to v's dtype; PV in v's dtype with f32 accumulation.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from parseq_tpu_torch.kernels.build import CSRC, load_library
from parseq_tpu_torch.ops import flash_bwd, layers

# Kernel gate, as in the JAX package (its value was measured on a TPU; the
# port keeps it until its own gate is measured on the H100).
KERNEL_MIN_LEN = 192
HEAD_DIM = 64  # the kernel's head width (dh of every L >= 192 user)

# Kernel launches made in this process by fused_attention_nosplit (B2) and
# by fused_attention (B3).
launches = 0
split_launches = 0

# Training attention below KERNEL_MIN_LEN takes the kernel-B4 backward unless
# plain_backward() is open.
_FLASH_BWD = True


@contextlib.contextmanager
def force_einsum():
    """Route every encoder_self_attention through the plain einsum path while
    the context is open (for comparisons; nothing on the main path uses it)."""
    global KERNEL_MIN_LEN
    old = KERNEL_MIN_LEN
    KERNEL_MIN_LEN = 10 ** 9
    try:
        yield
    finally:
        KERNEL_MIN_LEN = old


@contextlib.contextmanager
def plain_backward():
    """Route training encoder self-attention through plain autograd of
    layers.mha while the context is open (for comparisons; nothing on the
    main path uses it)."""
    global _FLASH_BWD
    old = _FLASH_BWD
    _FLASH_BWD = False
    try:
        yield
    finally:
        _FLASH_BWD = old


def fused_attention_nosplit_reference(q, k, v, num_heads, scale):
    """Plain PyTorch version of kernel B2. q, k, v: (B, L, D), any strides.
    Returns (B, L, D) in v's dtype."""
    B, L, D = q.shape
    dh = D // num_heads

    def split(x):
        return x.reshape(B, L, num_heads, dh).transpose(1, 2)

    s = (split(q).float() @ split(k).float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype) @ split(v)
    return o.transpose(1, 2).reshape(B, L, D)


def fused_attention_reference(q, k, v, scale):
    """Plain PyTorch version of kernel B3 (`_reference_attention`). q, k, v:
    (BH, L, dh), any strides. Returns (BH, L, dh) in v's dtype."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)
    return p.to(v.dtype) @ v


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
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.parseq_attention_split.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 7
                                               + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        lib.parseq_attention_split.restype = ctypes.c_int
        lib.parseq_attention_max_len.argtypes = []
        lib.parseq_attention_max_len.restype = ctypes.c_int
        lib.parseq_attention_error_string.argtypes = [ctypes.c_int]
        lib.parseq_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_operand(op, name, t, shape, device):
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
        raise ValueError(f'{op}: {name} must be a {shape} bf16 tensor on '
                         f'{device}, got {tuple(t.shape)} {t.dtype} on {t.device}')
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f'{op}: {name} needs unit channel stride, batch and '
                         f'row strides that are multiples of 8 and a 16-byte aligned start, got '
                         f'strides {t.stride()} at offset {t.storage_offset()}')


def _on_cpu(*tensors):
    return all(t.device.type == 'cpu' for t in tensors)


def _attention_nosplit(q, k, v, num_heads, scale):
    """Kernel B2's forward: the plain version on CPU tensors; a CUDA tensor
    launches the kernel or raises."""
    global launches
    if _on_cpu(q, k, v):
        return fused_attention_nosplit_reference(q, k, v, num_heads, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention_nosplit: unsupported device {q.device}')
    if q.dim() != 3:
        raise ValueError(f'fused_attention_nosplit: q must be (B, L, D), got {tuple(q.shape)}')
    B, L, D = q.shape
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_operand('fused_attention_nosplit', name, t, (B, L, D), q.device)
    lib = library()
    if D != num_heads * HEAD_DIM or L > lib.parseq_attention_max_len():
        raise ValueError(f'fused_attention_nosplit: the kernel needs D == {HEAD_DIM} * heads and '
                         f'L <= {lib.parseq_attention_max_len()} (B={B}, L={L}, D={D}, '
                         f'heads={num_heads})')
    out = torch.empty(B, L, D, dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.parseq_attention_nosplit(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                      v.stride(0), v.stride(1), B, L, D, num_heads, scale, stream)
    if rc != 0:
        raise RuntimeError(f'attention kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_attention_error_string(rc).decode()})')
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
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention: unsupported device {q.device}')
    if q.dim() != 3:
        raise ValueError(f'fused_attention: q must be (BH, L, dh), got {tuple(q.shape)}')
    BH, L, dh = q.shape
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_operand('fused_attention', name, t, (BH, L, dh), q.device)
    lib = library()
    if dh != HEAD_DIM or L > lib.parseq_attention_max_len():
        raise ValueError(f'fused_attention: the kernel needs dh == {HEAD_DIM} and '
                         f'L <= {lib.parseq_attention_max_len()} (BH={BH}, L={L}, dh={dh})')
    out = torch.empty(BH, L, dh, dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.parseq_attention_split(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                    v.stride(0), v.stride(1), BH, L, scale, stream)
    if rc != 0:
        raise RuntimeError(f'attention kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_attention_error_string(rc).decode()})')
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
    kernel (bf16, dh = 64) or raises. Under autograd the backward
    recomputes through the plain version."""
    return _FusedAttention.apply(q, k, v, scale)


def encoder_self_attention(x, in_weight, in_bias, out_weight, out_bias, num_heads):
    """layers.mha(x, x, x) with no mask. At L >= KERNEL_MIN_LEN the packed
    q|k|v projection feeds kernel B2 through strided views (no copies);
    below it, under autograd, it feeds attention_flashbwd (kernel B4 in the
    backward) when the kernel takes the shape."""
    B, L, D = x.shape
    if L < KERNEL_MIN_LEN:
        training = torch.is_grad_enabled() and (x.requires_grad or in_weight.requires_grad)
        if training and _FLASH_BWD and flash_bwd.kernel_takes(L, D // num_heads):
            qkv = layers.linear(x, in_weight, in_bias)
            o = flash_bwd.attention_flashbwd(qkv, num_heads, 1.0 / math.sqrt(D // num_heads))
            return layers.linear(o, out_weight, out_bias)
        return layers.mha(x, x, x, in_weight, in_bias, out_weight, out_bias, num_heads=num_heads)
    qkv = layers.linear(x, in_weight, in_bias)
    o = fused_attention_nosplit(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], num_heads,
                                1.0 / math.sqrt(D // num_heads))
    return layers.linear(o, out_weight, out_bias)
