#!/usr/bin/env python
"""Where kernel B1 (csrc/ar_decode.cu) spends its cycles, phase by phase.

    python experiments/torch_ar_decode_phase_trace.py

Builds a copy of the kernel with clock64() marks inserted around the ten
phases of a decode step (the source in the checkout is not changed; the
copy compiles to build/kernels/), runs it on PARSeq-S's decoder (D = 384,
12 heads, MLP 1536, 95 classes, 26 steps; every parameter drawn by
ar_kernel.check_model from seed 0) against M = 128 memory rows, and prints
the mean SM cycles a block spends per step in each phase, as thread 0 sees
them (every phase ends in a block barrier):

  embed   embedding row + position, norm_c
  kv      the K|V product and the cache write
  self    self-attention over the cache
  out     the out projection + residual
  cq      norm1 + the cross-attention query product
  cross   cross-attention over memory
  co      the cross-attention out projection + residual
  mlp1    norm2 + the MLP1 product + GELU
  mlp2    the MLP2 product + residual
  head    final norm + the head product + logits store + argmax

with each phase's share of the block's cycles, for B = 256 at the wrapper's
rows per block and for one block alone at R = 1, 2, 4 and 8 rows (B = R).
Beside each: the untraced kernel's ms (CUDA events around the launch on
prepared tensors, median of 10), prepare()'s ms alone and the wrapper's.
A second copy with marks inside the product routine splits the products'
cycles per step into

  wait      the warp's slab landing (its copies, then a __syncwarp)
  issue     issuing the copies of the slab kStages - 1 ahead
  mma       the warp's ldmatrix loads and mma.sync on the slab
  epilogue  bias and stores of a finished tile

as warp 0 sees them

Last, the untraced kernel's ms over B in {1, 7, 64, 132, 256, 512} and each
R in {1, 2, 4, 8} (the table rows_per_block encodes). The marks cost a few
percent. Needs a CUDA card and nvcc; the last line is one JSON object with
the numbers.
"""

import ctypes
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import torch

from experiments.torch_encoder_kernel_bench import card_line, cuda_median_ms
from experiments.torch_trace_build import build
from parseq_tpu_torch.models.parseq import PARSeqConfig
from parseq_tpu_torch.ops import ar_kernel

PHASES = ('embed', 'kv', 'self', 'out', 'cq', 'cross', 'co', 'mlp1', 'mlp2', 'head')
STEPS = ('wait', 'issue', 'mma', 'epilogue')
SEED = 0
M = 128
BATCH = 256
SWEEP_BATCHES = (1, 7, 64, 132, 256, 512)
MAX_BLOCKS = 1024
WORDS = 12  # trace words a block: the ten phases, the block's cycles, one spare


def _mark(k):
    """Close the open phase of thread 0 and open phase k (-1: none)."""
    return ('if (threadIdx.x == 0) { const long long t_ = clock64(); if (ph_ >= 0) '
            f'tp_[ph_] += t_ - tl_; tl_ = t_; ph_ = {k}; }}\n')


# Where each phase starts: an anchor on the line that opens it.
PHASE_ANCHORS = (
    '    // ---- content row: embed the entering token',
    'product<R>(p, kKV,',
    'attend<R>(s_q, 0',
    'product<R>(p, kO,',
    'layer_norm_rows<R>(s_tgt, D, ln + 2 * D',
    'attend<R>(s_cq, D',
    'product<R>(p, kCO,',
    'layer_norm_rows<R>(s_tgt, D, ln + 4 * D',
    'product<R>(p, kM2,',
    'layer_norm_rows<R>(s_tgt, D, ln + 6 * D',
)

# Reads the trace buffer into dst and zeroes it for the next call.
TRACE_COPY = ('const char* parseq_cuda_error_string(int code) {', 'before',
              'int parseq_ar_decode_trace_copy(void* dst) {\n'
              '  cudaError_t e = cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n'
              '  void* at = nullptr;\n'
              '  if (e == cudaSuccess) e = cudaGetSymbolAddress(&at, g_trace);\n'
              '  if (e == cudaSuccess) e = cudaMemset(at, 0, sizeof(g_trace));\n'
              '  return (int)e;\n}\n\n')

# (anchor in csrc/ar_decode.cu, where, text inserted): torch_trace_build.traced_source
EDITS = (
    ('struct Params {', 'before', f'__device__ long long g_trace[{WORDS} * {MAX_BLOCKS}];\n\n'),
    ('  if (tid < R) s_tok[tid] = p.bos_id;\n', 'after',
     '  const long long t0_ = clock64();\n'
     '  long long tp_[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n  long long tl_ = 0;\n'
     '  int ph_ = -1;\n'),
    *((anchor, 'line', '    ' + _mark(k)) for k, anchor in enumerate(PHASE_ANCHORS)),
    ('    __syncthreads();\n  }\n}\n\ntemplate <int R>\ncudaError_t launch', None,
     '    __syncthreads();\n    ' + _mark(-1) + '  }\n'
     f'  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n'
     f'    long long* t = g_trace + (size_t)blockIdx.x * {WORDS};\n'
     '    for (int k = 0; k < 10; ++k) t[k] = tp_[k];\n'
     '    t[10] = clock64() - t0_;\n  }\n}\n\ntemplate <int R>\ncudaError_t launch'),
    TRACE_COPY,
)


def _step_mark(k):
    return (f'if (threadIdx.x == 0) {{ const long long t_ = clock64(); st_[{k}] += t_ - ts_; '
            'ts_ = t_; }\n')


EPILOGUE_END = ('      if (re < R && je < N) out[re * os + je] = acc[0][e] + acc[1][e] + '
                '(e >> 1 ? bias_j8 : bias_j);\n    }\n  }\n}\n')

# Marks inside the product routine (warp 0's thread 0), summed per block
# over the decode.
STEP_EDITS = (
    ('struct Params {', 'before', f'__device__ long long g_trace[4 * {MAX_BLOCKS}];\n\n'),
    ('  const int arow = lane & 15, achunk = lane >> 4;\n', 'after',
     '  long long st_[4] = {0, 0, 0, 0};\n  long long ts_ = clock64();\n'),
    ('      cp_async_wait<kStages - 2>();\n      __syncwarp();\n      issue_slab(p, g);\n', None,
     '      ts_ = clock64();\n      cp_async_wait<kStages - 2>();\n      __syncwarp();\n'
     '      ' + _step_mark(0) + '      issue_slab(p, g);\n      ' + _step_mark(1)),
    ('      g.take = (g.take + 1) & (kStages - 1);\n', 'before', '      ' + _step_mark(2)),
    ('#pragma unroll\n    for (int e = 0; e < 4; ++e) {\n      const int je', 'before',
     '    ts_ = clock64();\n'),
    (EPILOGUE_END, None, EPILOGUE_END[:-6] + '    ' + _step_mark(3) + '  }\n'
     f'  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS})\n'
     '    for (int k = 0; k < 4; ++k)\n'
     '      atomicAdd(reinterpret_cast<unsigned long long*>(g_trace) + blockIdx.x * 4 + k,\n'
     '                (unsigned long long)st_[k]);\n}\n'),
    TRACE_COPY,
)


def run_traced(lib, run, words):
    """One call through `lib`; its trace buffer of `words` 64-bit words."""
    plain_library = ar_kernel.library
    ar_kernel.library = lambda: lib
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ar_kernel.library = plain_library
    buf = (ctypes.c_longlong * words)()
    if lib.parseq_ar_decode_trace_copy(ctypes.byref(buf)):
        raise RuntimeError('reading the trace failed')
    return buf


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('torch_ar_decode_phase_trace: needs a CUDA card')
    card = card_line()
    libs = build('ar_decode.cu', {'phases': EDITS, 'steps': STEP_EDITS}, ar_kernel.library(),
                 ('parseq_ar_decode', 'parseq_cuda_error_string'),
                 ('parseq_ar_decode_trace_copy',))
    dev = torch.device('cuda')
    cfg = PARSeqConfig()
    D, n = cfg.embed_dim, cfg.num_steps
    F = int(D * cfg.dec_mlp_ratio)
    model = ar_kernel.check_model(cfg, SEED).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {'card': card, 'M': M, 'runs': {}, 'sweep_ms': {}}
    print(f'B1 phase trace, PARSeq-S decoder (D={D}, heads {cfg.dec_num_heads}, MLP {F}, '
          f'C={cfg.num_classes}, {n} steps), M={M}, bf16 [{card}]')
    runs = [(BATCH, ar_kernel.rows_per_block(BATCH, sms))] + [(r, r) for r in (1, 2, 4, 8)]
    with torch.inference_mode():
        for B, R in runs:
            memory = ar_kernel.check_memory(B, M, D, SEED + 1, dev)
            c = ar_kernel.prepare(model, memory)
            kernel = lambda: ar_kernel.decode_prepared(c, cfg, B, M, D, F, R)  # noqa: E731
            ms = cuda_median_ms(kernel, runs=10)
            prep_ms = cuda_median_ms(lambda: ar_kernel.prepare(model, memory), runs=10)
            wrap_ms = cuda_median_ms(lambda: ar_kernel.ar_decode_fused(model, memory, rows=R),
                                     runs=10)
            blocks = min(-(-B // R), MAX_BLOCKS)
            buf = run_traced(libs['phases'], kernel, WORDS * MAX_BLOCKS)
            rows = [buf[b * WORDS:(b + 1) * WORDS] for b in range(blocks)]
            per_step = {name: statistics.mean(r[i] for r in rows) / n
                        for i, name in enumerate(PHASES)}
            block = statistics.mean(r[10] for r in rows)
            total = sum(per_step.values())
            run = {'B': B, 'R': R, 'blocks': -(-B // R), 'kernel_ms': ms, 'prepare_ms': prep_ms,
                   'wrapper_ms': wrap_ms, 'block_cycles': block, 'sm_ghz': block / ms / 1e6,
                   'phases': {k: {'cycles_per_step': v, 'share': v / total}
                              for k, v in per_step.items()}}
            sbuf = run_traced(libs['steps'], kernel, 4 * MAX_BLOCKS)
            run['products'] = {k: statistics.mean(sbuf[b * 4 + j] for b in range(blocks)) / n
                               for j, k in enumerate(STEPS)}
            result['runs'][f'B={B} R={R}'] = run
            print(f'-- B={B} R={R} ({run["blocks"]} blocks): kernel {ms:.4f} ms untraced, '
                  f'prepare {prep_ms:.4f} ms, wrapper {wrap_ms:.4f} ms; a block '
                  f'{block:.0f} cycles ({run["sm_ghz"]:.3f} GHz over the kernel time), '
                  f'{total:.0f} a step')
            print(f'   {"phase":6s} {"cycles/step":>12s} {"share":>7s}')
            for k, v in run['phases'].items():
                print(f'   {k:6s} {v["cycles_per_step"]:12.0f} {v["share"]:7.2%}')
            print('   products (warp 0), cycles/step: ' + ', '.join(
                f'{k} {v:.0f}' for k, v in run['products'].items()), flush=True)
        print(f'kernel ms over B (rows) x R at M={M} [{card}]')
        print(f'{"B":>5s}' + ''.join(f'{"R=" + str(r):>10s}' for r in (1, 2, 4, 8))
              + f'{"policy":>8s}')
        for B in SWEEP_BATCHES:
            memory = ar_kernel.check_memory(B, M, D, SEED + 1, dev)
            c = ar_kernel.prepare(model, memory)
            row = {R: cuda_median_ms(lambda: ar_kernel.decode_prepared(c, cfg, B, M, D, F, R),
                                     runs=5) for R in (1, 2, 4, 8)}
            result['sweep_ms'][str(B)] = row
            print(f'{B:5d}' + ''.join(f'{row[r]:10.4f}' for r in (1, 2, 4, 8))
                  + f'{ar_kernel.rows_per_block(B, sms):8d}', flush=True)
    print(card)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
