"""All pre-LN ViT blocks of an encoder in one kernel: kernel B5 (port of
parseq_tpu/ops/encoder_kernel.py: stack_block_params, fused_encoder_blocks,
_encoder_kernel).

`stack_block_params(blocks)` turns the port's `VisionTransformer.blocks`
into the kernel's operands: depth-stacked weights in the compute dtype in
torch's (out, in) layout (the packed q|k|v projection as timm keeps it),
biases in the compute dtype, LayerNorm scales and biases in f32.
`fused_encoder_blocks(op, x, num_heads=...)` applies every block to x
(B, L, D): on a CUDA tensor it launches the hand-written CUDA kernel
`csrc/encoder_blocks.cu` (bf16, or raises), on a CPU tensor it computes
the plain PyTorch version, `fused_encoder_blocks_reference`. Patch and
position embedding and the final LayerNorm stay outside, as in the JAX
package. The JAX package runs it only from its encoder microbench; the
port's counterpart is experiments/torch_encoder_kernel_bench.py.

Numerics of both versions (those of the TPU kernel), per layer in x's
dtype: h = LN1(x) with f32 statistics; every product takes f32 sums and is
rounded to x's dtype before its bias is added in that dtype; per-head f32
scores times 1/sqrt(dh) and f32 softmax, normalised before the
probabilities are rounded; per-head PV sums in f32; x1 = x + proj; h2 =
LN2(x1); exact-erf GELU in f32 on the rounded fc1 output; out = x1 + fc2.
The TPU kernel's head-masked full-width attention gives the same sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re

import torch
import torch.nn.functional as F

from parseq_tpu_torch.kernels.build import CSRC, load_library

# Kernel launches made by fused_encoder_blocks in this process.
launches = 0

_NAMES = ('ln1_s', 'ln1_b', 'wqkv', 'bqkv', 'wo', 'bo', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2', 'b2')
_F32 = ('ln1_s', 'ln1_b', 'ln2_s', 'ln2_b')


def stack_block_params(blocks, dtype=torch.bfloat16):
    """Depth-stacked operands of the kernel from a sequence of the port's
    `models.vit.Block`s: wqkv (depth, 3D, D), wo (depth, D, D), w1 (depth,
    F, D), w2 (depth, D, F) and their biases (depth, out) in `dtype`;
    ln1_s, ln1_b, ln2_s, ln2_b (depth, D) in f32. JAX's stack_block_params
    holds the same values with the weights transposed to (depth, in, out)
    and the vectors as (depth, 1, n)."""
    def stack(get, dt):
        return torch.stack([get(b).detach() for b in blocks]).to(dt).contiguous()

    return {
        'ln1_s': stack(lambda b: b.norm1.weight, torch.float32),
        'ln1_b': stack(lambda b: b.norm1.bias, torch.float32),
        'wqkv': stack(lambda b: b.attn.qkv.weight, dtype),
        'bqkv': stack(lambda b: b.attn.qkv.bias, dtype),
        'wo': stack(lambda b: b.attn.proj.weight, dtype),
        'bo': stack(lambda b: b.attn.proj.bias, dtype),
        'ln2_s': stack(lambda b: b.norm2.weight, torch.float32),
        'ln2_b': stack(lambda b: b.norm2.bias, torch.float32),
        'w1': stack(lambda b: b.mlp.fc1.weight, dtype),
        'b1': stack(lambda b: b.mlp.fc1.bias, dtype),
        'w2': stack(lambda b: b.mlp.fc2.weight, dtype),
        'b2': stack(lambda b: b.mlp.fc2.bias, dtype),
    }


def _ln(x32, scale, bias, eps=1e-5):
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale + bias


def _dense(a, w, b):
    """a w^T + b in a's dtype: f32 sums rounded to that dtype, then the bias
    added in it."""
    return (a.float() @ w.float().t()).to(a.dtype) + b.to(a.dtype)


def _attention(q, k, v, scale):
    """Per-head attention on (B, h, L, dh) in their dtype: f32 scores and
    softmax, probabilities rounded, f32 PV sums, rounded."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def fused_encoder_blocks_reference(op, x, num_heads):
    """Plain PyTorch version of kernel B5: every block of `op` on x (B, L, D)
    in x's dtype, with the kernel's rounding points."""
    B, L, D = x.shape
    dt = x.dtype
    dh = D // num_heads
    scale = 1.0 / math.sqrt(dh)

    def heads(t):  # (B, L, D) -> (B, h, L, dh)
        return t.reshape(B, L, num_heads, dh).transpose(1, 2)

    for i in range(op['wqkv'].shape[0]):
        h = _ln(x.float(), op['ln1_s'][i], op['ln1_b'][i]).to(dt)
        q, k, v = (heads(t) for t in _dense(h, op['wqkv'][i], op['bqkv'][i]).split(D, dim=-1))
        o = _attention(q, k, v, scale).transpose(1, 2).reshape(B, L, D)
        x = x + _dense(o, op['wo'][i], op['bo'][i])
        h = _ln(x.float(), op['ln2_s'][i], op['ln2_b'][i]).to(dt)
        hid = F.gelu(_dense(h, op['w1'][i], op['b1'][i]).float()).to(dt)
        x = x + _dense(hid, op['w2'][i], op['b2'][i])
    return x


def library():
    """Build (first use) and load the kernel library with its ctypes signatures."""
    lib = load_library('encoder_blocks', (CSRC / 'encoder_blocks.cu',))
    fn = lib.parseq_encoder_blocks
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.parseq_encoder_blocks_max_len.argtypes = []
        lib.parseq_encoder_blocks_max_len.restype = ctypes.c_int
        lib.parseq_encoder_blocks_error_string.argtypes = [ctypes.c_int]
        lib.parseq_encoder_blocks_error_string.restype = ctypes.c_char_p
    return lib


def _check(op, x, num_heads):
    """Raise unless the kernel takes x and op; returns (depth, F)."""
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f'fused_encoder_blocks: x must be a (B, L, D) bf16 tensor, got '
                         f'{tuple(x.shape)} {x.dtype}')
    B, L, D = x.shape
    depth, F_ = op['w1'].shape[:2]
    shapes = {'ln1_s': (D,), 'ln1_b': (D,), 'wqkv': (3 * D, D), 'bqkv': (3 * D,), 'wo': (D, D),
              'bo': (D,), 'ln2_s': (D,), 'ln2_b': (D,), 'w1': (F_, D), 'b1': (F_,),
              'w2': (D, F_), 'b2': (D,)}
    for name in _NAMES:
        t, dt = op[name], torch.float32 if name in _F32 else torch.bfloat16
        if (tuple(t.shape) != (depth, *shapes[name]) or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f'fused_encoder_blocks: {name} must be a contiguous '
                             f'{(depth, *shapes[name])} {dt} tensor on {x.device}, got '
                             f'{tuple(t.shape)} {t.dtype} on {t.device}')
    if not takes(L, D, num_heads, F_):
        raise ValueError(f'fused_encoder_blocks: the kernel needs L <= {max_len()}, D == 64 * '
                         f'heads, D <= 512 and D, F multiples of 128 (L={L}, D={D}, '
                         f'heads={num_heads}, F={F_})')
    return depth, F_


@functools.cache
def max_len():
    """The longest sequence the kernel takes: kMaxL of csrc/encoder_blocks.cu,
    read from the source the library is built from (what the library's
    parseq_encoder_blocks_max_len returns), so that asking does not build or
    load it."""
    text = (CSRC / 'encoder_blocks.cu').read_text()
    return int(re.search(r'^constexpr int kMaxL = (\d+);', text, re.M).group(1))


def takes(L, D, num_heads, F_):
    """Whether the kernel takes L tokens of width D in `num_heads` heads with
    MLP width F_: the shape conditions on which _check raises."""
    return (D == 64 * num_heads and D % 128 == 0 and D <= 512 and F_ % 128 == 0
            and L <= max_len())


def fused_encoder_blocks(op, x, *, num_heads):
    """Every transformer block of `op` (stack_block_params) on x (B, L, D) ->
    (B, L, D), in one launch of kernel B5 on a CUDA tensor (bf16; anything
    else raises) or by the plain version on a CPU tensor. Any B. Not
    differentiable on CUDA (as the JAX kernel is not)."""
    global launches
    if x.device.type == 'cpu':
        return fused_encoder_blocks_reference(op, x, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_encoder_blocks: unsupported device {x.device}')
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError('fused_encoder_blocks: the CUDA kernel has no backward; run it under '
                         'torch.no_grad() or torch.inference_mode()')
    depth, F_ = _check(op, x, num_heads)
    B, L, D = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    big = torch.empty(B, L, max(3 * D, F_), dtype=x.dtype, device=x.device)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.parseq_encoder_blocks(x.data_ptr(), out.data_ptr(), h.data_ptr(), big.data_ptr(),
                                   *(op[n].data_ptr() for n in _NAMES), B, L, D, num_heads, F_,
                                   depth, 1.0 / math.sqrt(D // num_heads), stream)
    if rc != 0:
        raise RuntimeError(f'encoder blocks kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_encoder_blocks_error_string(rc).decode()})')
    launches += 1
    return out
