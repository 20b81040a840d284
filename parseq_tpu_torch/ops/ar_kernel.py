"""Fused greedy AR decode for dec_depth == 1 (port of parseq_tpu/ops/ar_kernel.py).

`ar_decode_fused(model, memory)` runs all num_steps greedy decode steps in
one launch of the hand-written CUDA kernel `csrc/ar_decode.cu` (kernel B1
in ROADMAP.md); `takes` is its gate in PARSeq.forward.
`ar_decode_fused_reference` is the same computation in plain PyTorch, step
by step; the wrapper uses it only for a tensor on the CPU. A CUDA tensor
goes to the kernel or raises. check_model, check_run and CHECK_LIMITS are
the kernel's card check, shared by chip_smoke.py and the gpu tests.

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

import numpy as np
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.kernels.build import CSRC, load_library
from parseq_tpu_torch.ops import layers
from parseq_tpu_torch.utils import trace

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


def _linear(x, c, name):
    """bf16 x (..., K) times w_<name> (N, K) with f32 accumulation, plus the
    f32 bias b_<name>: one of the step's seven products (kv, o, cq, co, 1, 2, h)."""
    return _dot(x, c['w_' + name]) + c['b_' + name]


def _attend(q, k, v, inv_sqrt_dh):
    """q (B, h, dh) f32 against k, v (B, keys, h, dh): softmax(q k / sqrt(dh)) v."""
    s = torch.einsum('bkhd,bhd->bhk', k, q) * inv_sqrt_dh
    return torch.einsum('bhk,bkhd->bhd', torch.softmax(s, -1), v)


def _self_attention(q, k_cache, v_cache, i, inv_sqrt_dh):
    """Step i's query against the cached keys and values 0..i."""
    B, _, h, dh = k_cache.shape
    return _attend(q.expand(B, h, dh), k_cache[:, :i + 1].float(), v_cache[:, :i + 1].float(),
                   inv_sqrt_dh)


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
    k_cache = torch.zeros(B, n, h, dh, dtype=torch.bfloat16, device=memory.device)
    v_cache = torch.zeros_like(k_cache)
    logits = torch.empty(B, n, cfg.num_classes, device=memory.device)
    tok = torch.full((B,), cfg.bos_id, dtype=torch.long, device=memory.device)
    for i in range(n):
        x = c['emb'][tok].float() + c['pos_add'][i]
        kv = _linear(_ln(x, ln, 0).to(torch.bfloat16), c, 'kv')
        k_cache[:, i] = kv[:, :D].to(torch.bfloat16).view(B, h, dh)
        v_cache[:, i] = kv[:, D:].to(torch.bfloat16).view(B, h, dh)

        sa = _self_attention(c['q_proj'][i].view(1, h, dh), k_cache, v_cache, i, inv_sqrt_dh)
        tgt = c['pos_q'][i] + _linear(sa.reshape(B, D), c, 'o')

        cq = _linear(_ln(tgt, ln, 1), c, 'cq')
        ca = _attend(cq.view(B, h, dh), mem_k, mem_v, inv_sqrt_dh)
        tgt = tgt + _linear(ca.reshape(B, D), c, 'co')

        hdn = _linear(_ln(tgt, ln, 2), c, '1')
        hdn = 0.5 * hdn * (1.0 + torch.erf(hdn * 0.7071067811865476))
        tgt = tgt + _linear(hdn, c, '2')

        logits_i = _linear(_ln(tgt, ln, 3), c, 'h')
        logits[:, i] = logits_i
        tok = logits_i.argmax(-1) if tokens is None else tokens[:, i].long()
    return logits


# The card check of B1, shared by chip_smoke.py and the gpu tests: a model
# whose every decoder parameter (biases and LayerNorm parameters included)
# is drawn with numpy from a seed, so that the two hosts' torch builds hold
# the same weights and a fault in a bias shows; memory drawn likewise. The
# kernel's logits, teacher-forced on its own picks, against the plain
# version's: |kernel - plain| relative to max|plain| within CHECK_LIMITS
# (max, mean), and the greedy picks equal wherever the plain top-2 margin
# exceeds twice the max limit (there no error within the limit can flip it).
# On the H100 the kernel's worst over the smoke's shapes is ~2.6e-3 / 1.1e-4
# (a block-wide-ring variant reached 2.3e-4 mean: the sums' order moves it);
# every fault planted in tests/test_torch_ar_kernel.py exceeds both limits
# more than tenfold (PERF.md §6).
CHECK_LIMITS = (2.0 ** -7, 2.0 ** -10)


def check_model(cfg, seed=0):
    """PARSeq(cfg) in eval mode with every parameter outside the encoder
    drawn from numpy's generator at `seed`: products N(0, 1/fan_in), biases
    N(0, 0.2^2), LayerNorm scales 1 + N(0, 0.2^2), the embedding table
    N(0, 1/D) (the kernel scales it by sqrt(D)), the position queries N(0, 1).
    The encoder keeps torch's default init: the check feeds memory directly."""
    from parseq_tpu_torch.models.parseq import PARSeq

    model = PARSeq(cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith('encoder.'):
                continue
            shape = tuple(p.shape)
            if name == 'pos_queries':
                v = rng.standard_normal(shape)
            elif name == 'text_embed.embedding.weight':
                v = rng.standard_normal(shape) / math.sqrt(shape[1])
            elif p.dim() == 2:
                v = rng.standard_normal(shape) / math.sqrt(shape[1])
            elif 'norm' in name and name.endswith('weight'):
                v = 1.0 + 0.2 * rng.standard_normal(shape)
            else:
                v = 0.2 * rng.standard_normal(shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def check_memory(B, M, D, seed=0, device='cpu'):
    """(B, M, D) bf16 memory of N(0, 1) entries (an encoder's LayerNormed
    output), drawn with numpy."""
    x = np.random.default_rng(seed).standard_normal((B, M, D), dtype=np.float32)
    return torch.from_numpy(x).to(device, torch.bfloat16)


def check_errors(got, want):
    """(max, mean) of |got - want| over max|want|."""
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    return float(diff.max() / top), float(diff.mean() / top)


def check_greedy(got, want):
    """(agree, positions): whether got's picks equal want's wherever want's
    top-2 margin exceeds twice the max limit (relative to max|want|), and
    how many positions that is."""
    top2 = want.float().topk(2, dim=-1).values
    margin = 2 * CHECK_LIMITS[0] * float(want.float().abs().max())
    confident = (top2[..., 0] - top2[..., 1]) > margin
    agree = bool((got.argmax(-1) == want.argmax(-1))[confident].all())
    return agree, int(confident.sum())


def check_passes(got, want):
    """True when got is finite, of want's shape, within CHECK_LIMITS of want
    and agrees with its confident greedy picks."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        return False
    rel_max, rel_mean = check_errors(got, want)
    return (rel_max <= CHECK_LIMITS[0] and rel_mean <= CHECK_LIMITS[1]
            and check_greedy(got, want)[0])


def check_run(model, memory, rows=None):
    """The wrapper's logits (rows forced when given) and the plain version's,
    teacher-forced on the wrapper's picks: (got, want, rel_max, rel_mean,
    passes)."""
    got = ar_decode_fused(model, memory, rows=rows)
    want = ar_decode_fused_reference(model, memory, tokens=got.argmax(-1))
    return (got, want, *check_errors(got, want), check_passes(got, want))


def rows_per_block(batch, sm_count):
    """Smallest rows-per-block that keeps the grid within one wave of SMs.

    The card's table (PERF.md §6: kernel ms over B in {1, 7, 64, 132, 256,
    512} x R in {1, 2, 4, 8}, experiments/torch_ar_decode_phase_trace.py)
    picks this R at every B: a block's products cost the same at any R <= 8
    but its cross-attention grows with R, and a second wave of blocks costs
    more than that growth."""
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


def takes(cfg, device):
    """Whether PARSeq.forward decodes with kernel B1 for a config `cfg`
    (PARSeqConfig) and memory on `device`: greedy AR decoding, a one-layer
    decoder, a CUDA device and kernels.enabled(). Elsewhere the scan
    (PARSeq.ar_decode) decodes."""
    return (cfg.decode_ar and cfg.dec_depth == 1 and torch.device(device).type == 'cuda'
            and kernels.enabled())


@torch.no_grad()
def ar_decode_fused(model, memory, rows=None):
    """Greedy AR decode of a one-layer PARSeq decoder in one kernel launch.

    memory: (B, M, D) bf16, contiguous. Returns logits (B, num_steps,
    num_classes) f32. On a CPU tensor this is the plain version. `rows`
    forces the batch rows a block decodes (1, 2, 4 or 8; default
    rows_per_block)."""
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
    h = cfg.dec_num_heads
    F = model.decoder.layers[0].linear1.out_features
    if D != cfg.embed_dim or D != 32 * h or F % 8:
        raise ValueError(f'ar_decode_fused: kernel needs D == 32 * heads and dff % 8 == 0 '
                         f'(D={D}, heads={h}, dff={F}, embed_dim={cfg.embed_dim})')
    if rows is None:
        sms = torch.cuda.get_device_properties(memory.device).multi_processor_count
        rows = rows_per_block(B, sms)
    if rows not in _ROWS_PER_BLOCK:
        raise ValueError(f'ar_decode_fused: rows must be one of {_ROWS_PER_BLOCK}, got {rows}')
    with trace.span('ar.prepare', device=True, rows=B):
        c = prepare(model, memory)
    for k, t in c.items():
        if t.device != memory.device or not t.is_contiguous():
            raise ValueError(f'ar_decode_fused: {k} must be contiguous on {memory.device}')
    with trace.span('ar.kernel', rows=B):
        return decode_prepared(c, cfg, B, M, D, F, rows)


def decode_prepared(c, cfg, B, M, D, F, rows):
    """The kernel launch of ar_decode_fused on prepare()'s tensors `c`, with
    `rows` batch rows a block; counts the launch."""
    global launches
    n, C = cfg.num_steps, cfg.num_classes
    dev = c['mem_k'].device
    logits = torch.empty(B, n, C, dtype=torch.float32, device=dev)
    k_cache = torch.empty(-(-B // rows) * rows, n, D, dtype=torch.bfloat16, device=dev)
    v_cache = torch.empty_like(k_cache)
    lib = library()
    order = ('mem_k', 'mem_v', 'emb', 'pos_add', 'pos_q', 'q_proj', 'w_kv', 'b_kv', 'w_o', 'b_o',
             'w_cq', 'b_cq', 'w_co', 'b_co', 'w_1', 'b_1', 'w_2', 'b_2', 'w_h', 'b_h', 'ln')
    ptrs = [c[k].data_ptr() for k in order]
    ptrs += [logits.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.parseq_ar_decode(*ptrs, B, M, D, cfg.dec_num_heads, n, C, F, cfg.bos_id, rows,
                              stream)
    if rc != 0:
        raise RuntimeError(f'ar_decode kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_cuda_error_string(rc).decode()})')
    launches += 1
    return logits
