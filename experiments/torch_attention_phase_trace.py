#!/usr/bin/env python
"""Where kernel B2 (csrc/attention.cu) spends its cycles, phase by phase.

    python experiments/torch_attention_phase_trace.py

Builds a copy of the kernel with clock64() marks inserted (the source in
the checkout is not changed; the copy compiles to build/kernels/), runs B2
at ViTSTR's (B, L, h, D) = (256, 197, 6, 384), ABINet's (256, 256, 8, 512)
and PARSeq-S's (256, 128, 6, 384) and B3 at (1536, 128, 64), all bf16, and
prints for each the mean SM cycles a warp spends per round (one 16-row
query slice) in each phase:

  q        wait for its Q slice, its fragments, the copy of the next slice
  qk       the scores S = Q K^T (wgmma, waited for)
  softmax  row max, exp and row sum, with their quad shuffles
  v_wait   round 0 only: V landing and the block barrier
  pv       packing p and O = P V (wgmma, waited for)
  store    o to global memory (warps with a slice)

and per block the cycles before the first round (K landing) and in all.
The marks cost a few percent; the untraced kernel's time (CUDA events, 10
back-to-back calls behind a GPU spin) is printed beside. Needs a CUDA card
and nvcc; the last line is one JSON object with the numbers.
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
from parseq_tpu_torch.ops import attention

PHASES = ('q', 'qk', 'softmax', 'v_wait', 'pv', 'store')
MAX_BLOCKS = 8192
SHAPES = (('B2', 256, 197, 6), ('B2', 256, 256, 8), ('B2', 256, 128, 6), ('B3', 1536, 128, 1))

# (anchor in csrc/attention.cu, where, text inserted): torch_trace_build.traced_source
MARK = '{{ long long t_ = clock64(); tp[{}] += t_ - tl; tl = t_; }}\n'
EDITS = (
    ('struct Params {', None,
     '__device__ long long g_trace[8 * kWarps * %d];\n\nstruct Params {' % MAX_BLOCKS),
    ('  const int L = p.L, Lp = (L + 15) / 16 * 16, Lk = staged_keys<T, KT>(L);\n', 'after',
     '  const long long t_start = clock64();\n'),
    ('  const int c_end = single ? 1 : Lp;\n', 'after',
     '  const long long t_k = clock64() - t_start;\n'
     '  long long tp[6] = {0, 0, 0, 0, 0, 0};\n  long long tl = clock64();\n'),
    ('      cp_async_commit();\n    }\n    // Exact softmax', None,
     '      cp_async_commit();\n    }\n    ' + MARK.format(0) + '    // Exact softmax'),
    ('    if (single) fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, 0, Lp, L);\n', 'after',
     '    ' + MARK.format(1)),
    ('    sumb = quad_sum(sumb);\n', 'after', '    ' + MARK.format(2)),
    ('    const float ia = 1.f / suma, ib = 1.f / sumb;\n', 'before', '    ' + MARK.format(3)),
    ('        pv<KT>(o, s, ia, ib, s_v, c0, Lp);\n      }\n      if (!active) continue;\n'
     '      bf16* o16', None,
     '        pv<KT>(o, s, ia, ib, s_v, c0, Lp);\n      }\n      ' + MARK.format(4)
     + '      if (!active) continue;\n      bf16* o16'),
    ('              __floats2bfloat162_rn(o[nt][2], o[nt][3]);\n      }\n    } else {', None,
     '              __floats2bfloat162_rn(o[nt][2], o[nt][3]);\n      }\n      '
     + MARK.format(5) + '    } else {'),
    ('    }\n  }\n}\n\ntemplate <typename T, int KT, bool kChunked = false>', None,
     '    }\n  }\n  if (lane == 0 && blockIdx.x < %d) {\n'
     '    long long* t = g_trace + ((size_t)blockIdx.x * kWarps + warp) * 8;\n'
     '    for (int i = 0; i < 6; ++i) t[i] = tp[i];\n'
     '    t[6] = clock64() - t_start;\n    t[7] = t_k;\n  }\n}\n\n'
     'template <typename T, int KT, bool kChunked = false>' % MAX_BLOCKS),
    ('int parseq_attention_max_len()', None,
     'int parseq_attention_trace_copy(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n\n'
     'int parseq_attention_max_len()'),
)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('torch_attention_phase_trace: needs a CUDA card')
    card = card_line()
    traced = build('attention.cu', {'trace': EDITS}, attention.library(),
                   ('parseq_attention_nosplit', 'parseq_attention_split',
                    'parseq_attention_max_len', 'parseq_attention_error_string'),
                   ('parseq_attention_trace_copy',))['trace']
    plain_library = attention.library
    gen = torch.Generator(device='cuda').manual_seed(0)
    results = {}
    for kernel, B, L, h in SHAPES:
        q, k, v = attention.check_operands(B, L, 64 * h, 64, 0.125, gen)
        if kernel == 'B2':
            run = lambda: attention.fused_attention_nosplit(q, k, v, h, 0.125)  # noqa: E731
        else:
            run = lambda: attention.fused_attention(q, k, v, 0.125)  # noqa: E731
        with torch.inference_mode():
            ms = cuda_median_ms(run, calls=10)
            attention.library = lambda: traced
            try:
                run()
                torch.cuda.synchronize()
            finally:
                attention.library = plain_library
        buf = (ctypes.c_longlong * (8 * 4 * MAX_BLOCKS))()
        if traced.parseq_attention_trace_copy(ctypes.byref(buf)):
            raise RuntimeError('reading the trace failed')
        blocks = min(MAX_BLOCKS, B * h)  # one block per head at these sizes
        rows = [buf[i * 8:(i + 1) * 8] for i in range(blocks * 4)]
        rounds = ((L + 15) // 16 + 3) // 4
        per_round = {name: statistics.mean(r[i] for r in rows) / rounds
                     for i, name in enumerate(PHASES)}
        per_round['v_wait'] *= rounds  # round 0 only: per block
        block = statistics.mean(r[6] for r in rows[::4])
        k_wait = statistics.mean(r[7] for r in rows[::4])
        key = f'{kernel} B={B} L={L} h={h}'
        results[key] = {'ms': ms, 'rounds': rounds, 'cycles_per_round': per_round,
                        'block_cycles': block, 'k_wait_cycles': k_wait}
        print(f'{key} bf16 [{card}]: kernel {ms:.4f} ms; per warp and round (cycles): '
              + ', '.join(f'{n} {c:.0f}' for n, c in per_round.items())
              + f'; per block: K landing {k_wait:.0f}, all {block:.0f} ({rounds} rounds)',
              flush=True)
    print(card)
    print(json.dumps({'card': card, 'results': results}))
    return results


if __name__ == '__main__':
    main()
