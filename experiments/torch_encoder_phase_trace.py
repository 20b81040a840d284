#!/usr/bin/env python
"""Where kernel B5 (csrc/encoder_blocks.cu) spends its cycles, phase by phase.

    python experiments/torch_encoder_phase_trace.py

Builds a copy of the kernel with clock64() marks inserted around the seven
phases of its layer loop (the source in the checkout is not changed; the
copy compiles to build/kernels/), runs it once on the encoder bench's
PARSeq-S geometry (B = 256, L = 128, D = 384, 6 heads, MLP 1536, depth 12,
bf16, make_blocks weights from seed 0) and prints the mean SM cycles one
block (one image) spends per layer in each phase, as thread 0 sees them
(every phase ends in a block barrier):

  ln1   LayerNorm 1 and its barrier
  qkv   h Wqkv^T + bqkv into the scratch
  attn  attention, one head at a time
  proj  o Wo^T + bo added to the residual stream
  ln2   LayerNorm 2 and its barrier
  mlp1  GELU(h2 W1^T + b1) into the scratch
  mlp2  hid W2^T + b2 added to the residual stream

with each phase's share of the block's cycles. The untraced kernel's time
(CUDA events around one call, median of 10) is printed beside, and from it
each phase's share of that time and the rate its FLOPs make in it (all 256
blocks are resident at once, two an SM, so a phase's share of a block's
cycles is its share of the kernel's time). A second copy, with marks inside
the product routine instead, splits each product's cycles per layer, as
thread 0 sees them, into

  wait     its slice's copies landing, the proxy fence and the block barrier
  issue    issuing the next slice's cp.async copies
  wgmma    the warpgroup's products on the slice, issued and waited for
  epilogue the tiles' sums through shared memory and out to global memory

The marks cost a few percent. Needs a CUDA card and nvcc; the last line is
one JSON object with the numbers.
"""

import ctypes
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import numpy as np
import torch

from experiments.torch_encoder_kernel_bench import (D, HEADS, L, MLP, SEED, card_line,
                                                    cuda_median_ms, make_blocks)
from experiments.torch_trace_build import build
from parseq_tpu_torch.ops import encoder_kernel

PHASES = ('ln1', 'qkv', 'attn', 'proj', 'ln2', 'mlp1', 'mlp2')
BATCH, DEPTH = 256, 12
MAX_BLOCKS = 1024

# FLOPs of each phase for one image and layer (products: 2 L K N).
PHASE_FLOPS = {'qkv': 2 * L * D * 3 * D, 'attn': 2 * 2 * L * L * D, 'proj': 2 * L * D * D,
               'mlp1': 2 * L * D * MLP, 'mlp2': 2 * L * MLP * D}


def _mark(k):
    """Close the open phase of thread 0 and open phase k (-1: none)."""
    return ('if (threadIdx.x == 0) { const long long t_ = clock64(); if (ph_ >= 0) '
            f'tp_[ph_] += t_ - tl_; tl_ = t_; ph_ = {k}; }}\n')


# (anchor in csrc/encoder_blocks.cu, where, text inserted):
# torch_trace_build.traced_source
EDITS = (
    ('struct Params {', 'before', '__device__ long long g_trace[8 * %d];\n\n' % MAX_BLOCKS),
    ('  bf16* big = p.big + b * L * ldb;\n', 'after',
     '  const long long t0_ = clock64();\n'
     '  long long tp_[7] = {0, 0, 0, 0, 0, 0, 0};\n  long long tl_ = 0;\n  int ph_ = -1;\n'),
    ('layer_norm(x, h, p.ln1_s', 'line', '    ' + _mark(0)),
    ('p.wqkv + (size_t)l', 'line', '    ' + _mark(1)),
    ('attention(smem, big, ldb', 'line', '    ' + _mark(2)),
    ('p.wo + (size_t)l', 'line', '    ' + _mark(3)),
    ('layer_norm(x, h, p.ln2_s', 'line', '    ' + _mark(4)),
    ('p.w1 + (size_t)l', 'line', '    ' + _mark(5)),
    ('p.w2 + (size_t)l', 'line', '    ' + _mark(6)),
    ('  }\n}\n\ninline bool aligned16', None,
     '    ' + _mark(-1) + '  }\n'
     '  if (threadIdx.x == 0 && blockIdx.x < %d) {\n'
     '    long long* t = g_trace + (size_t)blockIdx.x * 8;\n'
     '    for (int i = 0; i < 7; ++i) t[i] = tp_[i];\n'
     '    t[7] = clock64() - t0_;\n  }\n}\n\ninline bool aligned16' % MAX_BLOCKS),
    ('int parseq_encoder_blocks_max_len()', 'before',
     'int parseq_encoder_blocks_trace_copy(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n\n'),
)


STEPS = ('wait', 'issue', 'wgmma', 'epilogue')
PRODUCTS = ('qkv', 'proj', 'mlp1', 'mlp2')


def _step_mark(k):
    return f'{{ const long long t_ = clock64(); st_[{k}] += t_ - ts_; ts_ = t_; }}\n'


# Marks inside gemm (csrc/encoder_blocks.cu), summed per block and product.
STEP_EDITS = (
    ('struct Params {', 'before',
     '__device__ unsigned long long g_steps[%d * 16];\n\n' % MAX_BLOCKS),
    ('  float acc[kBN / 2];\n', 'after',
     '  long long st_[4] = {0, 0, 0, 0};\n  long long ts_ = 0;\n'
     '  const int product_ = E == Epilogue::kStore ? 0 : E == Epilogue::kGelu ? 2 : K == N ? 1 : 3;\n'),
    ('    cp_async_wait<kStages - 2>();', 'line', '    ts_ = clock64();\n'),
    ('    if (s + kStages - 1 < steps) load(s + kStages - 1);', 'line', '    ' + _step_mark(0)),
    ('    if (active) {\n      const bf16* sa = slot(s)', 'line', '    ' + _step_mark(1)),
    ('      wgmma_commit_and_wait();\n    }\n  };\n', None,
     '      wgmma_commit_and_wait();\n    }\n    ' + _step_mark(2) + '  };\n'),
    ('    __syncthreads();  // both warpgroups', 'line', '    ts_ = clock64();\n'),
    ('        store8(o, t);\n      }\n    }\n  }\n', None,
     '        store8(o, t);\n      }\n    }\n    ' + _step_mark(3) + '  }\n'
     '  if (threadIdx.x == 0 && blockIdx.x < %d)\n'
     '    for (int k = 0; k < 4; ++k)\n'
     '      atomicAdd(g_steps + blockIdx.x * 16 + product_ * 4 + k, (unsigned long long)st_[k]);\n'
     % MAX_BLOCKS),
    ('int parseq_encoder_blocks_max_len()', 'before',
     'int parseq_encoder_blocks_trace_copy(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_steps, sizeof(g_steps));\n}\n\n'),
)


def run_traced(lib, run, n):
    """One call through `lib`; its trace buffer of n 64-bit words."""
    plain_library = encoder_kernel.library
    encoder_kernel.library = lambda: lib
    try:
        run()
        torch.cuda.synchronize()
    finally:
        encoder_kernel.library = plain_library
    buf = (ctypes.c_longlong * n)()
    if lib.parseq_encoder_blocks_trace_copy(ctypes.byref(buf)):
        raise RuntimeError('reading the trace failed')
    return buf


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('torch_encoder_phase_trace: needs a CUDA card')
    card = card_line()
    libs = build('encoder_blocks.cu', {'trace': EDITS, 'steps': STEP_EDITS},
                 encoder_kernel.library(),
                 ('parseq_encoder_blocks', 'parseq_encoder_blocks_max_len',
                  'parseq_encoder_blocks_error_string'),
                 ('parseq_encoder_blocks_trace_copy',))
    dev = torch.device('cuda')
    op = encoder_kernel.stack_block_params(make_blocks(DEPTH, SEED).to(dev))
    x = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (BATCH, L, D), dtype=np.float32)).to(dev, torch.bfloat16)
    run = lambda: encoder_kernel.fused_encoder_blocks(op, x, num_heads=HEADS)  # noqa: E731
    with torch.inference_mode():
        ms = cuda_median_ms(run, runs=10)
        buf = run_traced(libs['trace'], run, 8 * MAX_BLOCKS)
        step_buf = run_traced(libs['steps'], run, 16 * MAX_BLOCKS)
    rows = [buf[i * 8:(i + 1) * 8] for i in range(BATCH)]
    per_layer = {name: statistics.mean(r[i] for r in rows) / DEPTH
                 for i, name in enumerate(PHASES)}
    block = statistics.mean(r[7] for r in rows)
    phases = sum(per_layer.values())
    table = {}
    for name, cyc in per_layer.items():
        share = cyc / phases
        phase_ms = ms * share
        flops = PHASE_FLOPS.get(name, 0) * BATCH * DEPTH
        table[name] = {'cycles_per_layer': cyc, 'share': share, 'ms': phase_ms,
                       'tflops': flops / phase_ms / 1e9 if flops else None}
    prod_share = sum(table[n]['share'] for n in PRODUCTS)
    prod_flops = sum(PHASE_FLOPS[n] for n in PRODUCTS) * BATCH * DEPTH
    result = {'card': card, 'batch': BATCH, 'depth': DEPTH, 'ms': ms, 'phases': table,
              'block_cycles': block, 'sm_ghz': block / ms / 1e6,
              'products_share': prod_share,
              'products_tflops': prod_flops / (ms * prod_share) / 1e9}
    print(f'B5 B={BATCH} depth {DEPTH} (L, D, heads, MLP)=({L}, {D}, {HEADS}, {MLP}) bf16 '
          f'[{card}]: kernel {ms:.4f} ms untraced; a block {block:.0f} cycles in all '
          f'({result["sm_ghz"]:.3f} GHz over the kernel time)')
    print(f'{"phase":6s} {"cycles/layer":>13s} {"share":>7s} {"ms":>8s} {"TF/s":>7s}')
    for name, row in table.items():
        tf = f'{row["tflops"]:7.1f}' if row['tflops'] else '      -'
        print(f'{name:6s} {row["cycles_per_layer"]:13.0f} {row["share"]:7.2%} '
              f'{row["ms"]:8.4f} {tf}')
    print(f'products {prod_share:.2%} of the cycles at {result["products_tflops"]:.1f} TF/s',
          flush=True)
    result['steps'] = {
        p: {k: statistics.mean(step_buf[b * 16 + i * 4 + j] for b in range(BATCH)) / DEPTH
            for j, k in enumerate(STEPS)} for i, p in enumerate(PRODUCTS)}
    print(f'{"product":8s}' + ''.join(f'{k:>10s}' for k in STEPS) + '   (cycles/layer)')
    for p, row in result['steps'].items():
        print(f'{p:8s}' + ''.join(f'{row[k]:10.0f}' for k in STEPS))
    print(card)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
