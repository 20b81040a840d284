#!/usr/bin/env python
"""Where kernel B4 (csrc/flash_bwd.cu, bf16) spends its cycles, phase by phase.

    python experiments/torch_flash_bwd_phase_trace.py

Builds a copy of the kernel with clock64() marks inserted (the source in
the checkout is not changed; the copy compiles to build/kernels/), runs B4
at PARSeq-S training's (B, h, L, dh) = (48, 6, 128, 64) and (384, 6, 128,
64) in bf16, and prints the mean SM cycles a warpgroup (64 query rows of a
head; a block holds two at L = 128 and walks over heads) spends on one head
in each phase:

  staging  cp.async of its Q rows and the head's K, landed (for the heads
           after a block's first, staged ahead during the previous head)
  s_dp     S = Q K^T, dO and V landing, dP = dO V^T (wgmma, waited for)
  softmax  row max, exp, sum, delta, dS, and P / dS split into bf16 hi + lo
           tiles in shared memory, up to the block barrier
  dq       dQ = dS K (two wgmmas a step) and its store
  dk_dv    the partial dK and dV of every key tile, the other query
           blocks' tiles left in shared memory
  exchange waiting for the other query blocks' partials (a named barrier
           between the two warpgroups of a block at L = 128, cluster
           barriers above) and their sum over the keys this one finishes
  store    dK and dV of the block's own keys

and the cycles of the busiest warpgroup in all. The marks cost a few percent; the
untraced kernel's time (CUDA events, 10 back-to-back calls behind a GPU
spin) is printed beside. Needs a CUDA card and nvcc; the last line is one
JSON object with the numbers.
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
from parseq_tpu_torch.ops import flash_bwd

PHASES = ('staging', 's_dp', 'softmax', 'dq', 'dk_dv', 'exchange', 'store')
MAX_BLOCKS = 8192
SHAPES = ((48, 6, 128, 64), (384, 6, 128, 64))

# (anchor in csrc/flash_bwd.cu, where, text inserted): torch_trace_build.traced_source
MARK = '{{ long long t_ = clock64(); tp_[{}] += t_ - tl_; tl_ = t_; }}\n'
EDITS = (
    ('template <int DH, int C>\n__global__', None,
     '__device__ long long g_trace[9 * %d];\n\ntemplate <int DH, int C>\n__global__' % MAX_BLOCKS),
    ('  const int L = p.L, qb = rank * WG + wg, q0 = qb * kTile;', 'after',
     '\n  const long long t0_ = clock64();\n'
     '  long long tl_ = t0_, tp_[7] = {0, 0, 0, 0, 0, 0, 0}, n_ = 0;'),
    ('      cp_async_wait<0>();\n    }\n    fence_proxy_async();\n    __syncthreads();\n', 'after',
     '    ' + MARK.format(0)),
    ('      for (int t = 0; t < C; ++t) dp_tile(dp[t], t);\n    }\n    wgmma_commit_and_wait();\n',
     'after', '    ' + MARK.format(1)),
    ('    // dQ = scale * dS K: A = dS', 'before', '    ' + MARK.format(2)),
    ('    // Partial dV = P^T dO', 'before', '    ' + MARK.format(3)),
    ('    key_tile(qb);\n', 'after', '    ' + MARK.format(4)),
    ("    // The own key tile's P and dS are no longer read", 'before', '    ' + MARK.format(5)),
    ('    store_rows(p.dv + at(bh, 6), p.st[6][2], out + kTile * kOutRow, q0);\n', 'after',
     '    ' + MARK.format(6)
     + '    ++n_;\n    if (wtid == 0 && blockIdx.x * WG + wg < %d) {\n'
       '      long long* t = g_trace + ((size_t)blockIdx.x * WG + wg) * 9;\n'
       '      for (int i = 0; i < 7; ++i) t[i] = tp_[i];\n'
       '      t[7] = clock64() - t0_;\n      t[8] = n_;\n    }\n' % MAX_BLOCKS),
    ('int parseq_flash_bwd_max_len()', None,
     'int parseq_flash_bwd_trace_copy(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n\n'
     'int parseq_flash_bwd_trace_clear(const void* zeros) {\n'
     '  return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));\n}\n\n'
     'int parseq_flash_bwd_max_len()'),
)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('torch_flash_bwd_phase_trace: needs a CUDA card')
    card = card_line()
    traced = build('flash_bwd.cu', {'trace': EDITS}, flash_bwd.library(),
                   ('parseq_flash_bwd', 'parseq_flash_bwd_max_len',
                    'parseq_flash_bwd_error_string'),
                   ('parseq_flash_bwd_trace_copy', 'parseq_flash_bwd_trace_clear'))['trace']
    plain_library = flash_bwd.library
    gen = torch.Generator(device='cuda').manual_seed(0)
    results = {}
    for B, h, L, dh in SHAPES:
        q, k, v, do, dq, dk, dv, scale = flash_bwd.check_operands(B, h, L, dh, gen)

        def run():
            flash_bwd.attention_flashbwd_backward(q, k, v, do, scale, dq, dk, dv)

        with torch.inference_mode():
            ms = cuda_median_ms(run, calls=10)
            flash_bwd.library = lambda: traced
            zeros = (ctypes.c_longlong * (9 * MAX_BLOCKS))()
            if traced.parseq_flash_bwd_trace_clear(ctypes.byref(zeros)):
                raise RuntimeError('clearing the trace failed')
            try:
                run()
                torch.cuda.synchronize()
            finally:
                flash_bwd.library = plain_library
        buf = (ctypes.c_longlong * (9 * MAX_BLOCKS))()
        if traced.parseq_flash_bwd_trace_copy(ctypes.byref(buf)):
            raise RuntimeError('reading the trace failed')
        rows = [r for r in (buf[i * 9:(i + 1) * 9] for i in range(MAX_BLOCKS)) if r[8]]
        heads = sum(r[8] for r in rows)  # (head, warpgroup) pairs
        per_head = {name: sum(r[i] for r in rows) / heads for i, name in enumerate(PHASES)}
        busiest = max(r[7] for r in rows)
        most = max(r[8] for r in rows)
        key = f'B4 (B, h, L, dh)=({B}, {h}, {L}, {dh})'
        results[key] = {'ms': ms, 'warpgroups': len(rows), 'heads_per_warpgroup_max': most,
                        'cycles_per_head': per_head, 'busiest_warpgroup_cycles': busiest}
        print(f'{key} bf16 [{card}]: kernel {ms:.4f} ms; {len(rows)} warpgroups, up to {most} '
              f'heads each; mean cycles per head and warpgroup: '
              + ', '.join(f'{n} {c:.0f}' for n, c in per_head.items())
              + f'; the busiest warpgroup {busiest} cycles in all', flush=True)
    print(card)
    print(json.dumps({'card': card, 'results': results}))
    return results


if __name__ == '__main__':
    main()
