"""Fused greedy AR decode for dec_depth == 1 (port of parseq_tpu/ops/ar_kernel.py).

`ar_decode_fused(model, memory)` runs all num_steps greedy decode steps in
one launch of the hand-written CUDA kernel `csrc/ar_decode.cu` (kernel B1
in ROADMAP.md). `ar_decode_fused_reference` is the same computation in
plain PyTorch, step by step; the wrapper uses it only for a tensor on the
CPU. A CUDA tensor goes to the kernel or raises.

Numerics are those of the JAX kernel, which both versions follow:
  1. the embedding row is bf16(sqrt(D) * w); the f32 positional row is
     added and norm_c applied in f32, then cast to bf16;
  2. new K/V rows: bf16 x bf16 with f32 accumulation + f32 bias, stored bf16;
  3. self-attention scores: f32 products of the bf16 cache with the
     unrounded f32 q_proj, times 1/sqrt(dh), f32 softmax over keys <= i;
     sum(p * v) stays f32 and is cast to bf16 only before the out projection;
  4. the residual stream is f32 and starts from pos_queries[i];
  5. cross-attention: the f32 (unrounded) query against bf16 memory keys;
  6. the MLP uses the exact-erf GELU in f32;
  7. final LN, then the head (bf16 inputs, f32 accumulation, f32 bias);
     argmax takes the lowest index on ties.
"""

from __future__ import annotations

import ctypes
import math

import torch

from parseq_tpu_torch.kernels.build import CSRC, load_library
from parseq_tpu_torch.ops import layers

# Kernel launches made by ar_decode_fused in this process (one per launch).
launches = 0

_ROWS_PER_BLOCK = (1, 2, 4, 8)


def _dot(a, w):
    """bf16 inputs, f32 accumulation: a (..., K) @ w (N, K)^T -> f32."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()


def prepare(model, memory):
    """What the JAX wrapper computes outside its kernel, in torch.

    Returns a dict of contiguous tensors on memory's device: the
    cross-attention K/V of memory (bf16), the bf16 sqrt(D)-scaled embedding
    table, pos_add / pos_q / q_proj (f32), decoder weights in bf16 (torch
    (out, in) layout) with f32 biases, and the LN parameters stacked (8, D)."""
    cfg = model.cfg
    lp = model.decoder.layers[0]
    D, n = cfg.embed_dim, cfg.num_steps
    bf16, f32 = torch.bfloat16, torch.float32
    mem = memory.to(bf16)
    ca_w, ca_b = lp.cross_attn.in_proj_weight, lp.cross_attn.in_proj_bias
    sa_w, sa_b = lp.self_attn.in_proj_weight, lp.self_attn.in_proj_bias

    pos_q = model.pos_queries[0, :n].to(f32)
    pos_add = torch.zeros_like(pos_q)
    pos_add[1:] = pos_q[: n - 1]
    qn = layers.layer_norm(pos_q, lp.norm_q.weight, lp.norm_q.bias)
    q_proj = qn @ sa_w[:D].to(f32).t() + sa_b[:D].to(f32)

    def w(t):
        return t.detach().to(bf16).contiguous()

    def b(t):
        return t.detach().to(f32).contiguous()

    ln = torch.stack([lp.norm_c.weight, lp.norm_c.bias, lp.norm1.weight, lp.norm1.bias,
                      lp.norm2.weight, lp.norm2.bias,
                      model.decoder.norm.weight, model.decoder.norm.bias])
    return {
        'mem_k': layers.linear(mem, ca_w[D:2 * D], ca_b[D:2 * D]).to(bf16).contiguous(),
        'mem_v': layers.linear(mem, ca_w[2 * D:], ca_b[2 * D:]).to(bf16).contiguous(),
        'emb': w(math.sqrt(D) * model.text_embed.embedding.weight),
        'pos_add': b(pos_add), 'pos_q': b(pos_q), 'q_proj': b(q_proj),
        'w_kv': w(sa_w[D:]), 'b_kv': b(sa_b[D:]),
        'w_o': w(lp.self_attn.out_proj.weight), 'b_o': b(lp.self_attn.out_proj.bias),
        'w_cq': w(ca_w[:D]), 'b_cq': b(ca_b[:D]),
        'w_co': w(lp.cross_attn.out_proj.weight), 'b_co': b(lp.cross_attn.out_proj.bias),
        'w_1': w(lp.linear1.weight), 'b_1': b(lp.linear1.bias),
        'w_2': w(lp.linear2.weight), 'b_2': b(lp.linear2.bias),
        'w_h': w(model.head.weight), 'b_h': b(model.head.bias),
        'ln': b(ln),
    }


def _ln(x, ln, k):
    return layers.layer_norm(x, ln[2 * k], ln[2 * k + 1])


@torch.no_grad()
def ar_decode_fused_reference(model, memory, tokens=None):
    """Plain PyTorch version of the fused kernel. memory: (B, M, D).
    Returns logits (B, num_steps, num_classes) f32.

    With `tokens` (B, num_steps) the token entering step i > 0 is
    tokens[:, i-1] instead of the greedy pick (teacher forcing, so kernel
    and plain version can be compared on one prefix without near-tie picks
    forking the sequence)."""
    cfg = model.cfg
    c = prepare(model, memory)
    B, M, D = memory.shape
    n, h = cfg.num_steps, cfg.dec_num_heads
    dh = D // h
    inv_sqrt_dh = 1.0 / math.sqrt(dh)
    ln = c['ln']
    mem_k = c['mem_k'].float().view(B, M, h, dh)
    mem_v = c['mem_v'].float().view(B, M, h, dh)
    k_cache = torch.zeros(B, n, D, dtype=torch.bfloat16, device=memory.device)
    v_cache = torch.zeros_like(k_cache)
    logits = torch.empty(B, n, cfg.num_classes, device=memory.device)
    tok = torch.full((B,), cfg.bos_id, dtype=torch.long, device=memory.device)
    for i in range(n):
        x = c['emb'][tok].float() + c['pos_add'][i]
        cn = _ln(x, ln, 0).to(torch.bfloat16)
        kv = _dot(cn, c['w_kv']) + c['b_kv']
        k_cache[:, i] = kv[:, :D].to(torch.bfloat16)
        v_cache[:, i] = kv[:, D:].to(torch.bfloat16)

        kk = k_cache[:, : i + 1].float().view(B, i + 1, h, dh)
        vv = v_cache[:, : i + 1].float().view(B, i + 1, h, dh)
        s = torch.einsum('bkhd,hd->bhk', kk, c['q_proj'][i].view(h, dh)) * inv_sqrt_dh
        sa = torch.einsum('bhk,bkhd->bhd', torch.softmax(s, -1), vv).reshape(B, D)
        tgt = c['pos_q'][i] + (_dot(sa, c['w_o']) + c['b_o'])

        cq = _dot(_ln(tgt, ln, 1), c['w_cq']) + c['b_cq']
        s2 = torch.einsum('bmhd,bhd->bhm', mem_k, cq.view(B, h, dh)) * inv_sqrt_dh
        ca = torch.einsum('bhm,bmhd->bhd', torch.softmax(s2, -1), mem_v).reshape(B, D)
        tgt = tgt + (_dot(ca, c['w_co']) + c['b_co'])

        hdn = _dot(_ln(tgt, ln, 2), c['w_1']) + c['b_1']
        hdn = 0.5 * hdn * (1.0 + torch.erf(hdn * 0.7071067811865476))
        tgt = tgt + (_dot(hdn, c['w_2']) + c['b_2'])

        logits_i = _dot(_ln(tgt, ln, 3), c['w_h']) + c['b_h']
        logits[:, i] = logits_i
        tok = logits_i.argmax(-1) if tokens is None else tokens[:, i].long()
    return logits


def rows_per_block(batch, sm_count):
    """Smallest rows-per-block that keeps the grid within one wave of SMs
    (each block streams all decoder weights once per step for its rows)."""
    for r in _ROWS_PER_BLOCK:
        if -(-batch // r) <= sm_count:
            return r
    return _ROWS_PER_BLOCK[-1]


def library():
    """Build (first use) and load the kernel library with its ctypes signatures."""
    lib = load_library('ar_decode', (CSRC / 'ar_decode.cu',))
    fn = lib.parseq_ar_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.parseq_cuda_error_string.argtypes = [ctypes.c_int]
        lib.parseq_cuda_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def ar_decode_fused(model, memory):
    """Greedy AR decode of a one-layer PARSeq decoder in one kernel launch.

    memory: (B, M, D) bf16, contiguous. Returns logits (B, num_steps,
    num_classes) f32. On a CPU tensor this is the plain version."""
    global launches
    cfg = model.cfg
    if memory.device.type == 'cpu':
        return ar_decode_fused_reference(model, memory)
    if memory.device.type != 'cuda':
        raise ValueError(f'ar_decode_fused: unsupported device {memory.device}')
    if cfg.dec_depth != 1:
        raise ValueError(f'ar_decode_fused needs dec_depth == 1, got {cfg.dec_depth}')
    if memory.dtype != torch.bfloat16 or memory.dim() != 3 or not memory.is_contiguous():
        raise ValueError('ar_decode_fused: memory must be a contiguous (B, M, D) bf16 tensor, '
                         f'got {tuple(memory.shape)} {memory.dtype}')
    B, M, D = memory.shape
    h, n, C = cfg.dec_num_heads, cfg.num_steps, cfg.num_classes
    F = model.decoder.layers[0].linear1.out_features
    if D != cfg.embed_dim or D != 32 * h or F % 8:
        raise ValueError(f'ar_decode_fused: kernel needs D == 32 * heads and dff % 8 == 0 '
                         f'(D={D}, heads={h}, dff={F}, embed_dim={cfg.embed_dim})')
    c = prepare(model, memory)
    for k, t in c.items():
        if t.device != memory.device or not t.is_contiguous():
            raise ValueError(f'ar_decode_fused: {k} must be contiguous on {memory.device}')

    R = rows_per_block(B, torch.cuda.get_device_properties(memory.device).multi_processor_count)
    rows = -(-B // R) * R
    logits = torch.empty(B, n, C, dtype=torch.float32, device=memory.device)
    k_cache = torch.empty(rows, n, D, dtype=torch.bfloat16, device=memory.device)
    v_cache = torch.empty_like(k_cache)
    lib = library()
    order = ('mem_k', 'mem_v', 'emb', 'pos_add', 'pos_q', 'q_proj', 'w_kv', 'b_kv', 'w_o', 'b_o',
             'w_cq', 'b_cq', 'w_co', 'b_co', 'w_1', 'b_1', 'w_2', 'b_2', 'w_h', 'b_h', 'ln')
    ptrs = [c[k].data_ptr() for k in order]
    ptrs += [logits.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    rc = lib.parseq_ar_decode(*ptrs, B, M, D, h, n, C, F, cfg.bos_id, R, stream)
    if rc != 0:
        raise RuntimeError(f'ar_decode kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_cuda_error_string(rc).decode()})')
    launches += 1
    return logits
