#!/usr/bin/env python
"""Phase 10 of chip_smoke.py alone on one CUDA card, and the spread of the
served rate over repeated runs of the same server.

    python experiments/torch_serve_phase.py [--repeats 6] [--no-tune]

Builds kernels B1 and B4, makes PARSeq-S as chip_smoke.py's phase 4 does
(hub.parseq(seed=0), bf16, the EOS bias raised), runs chip_smoke.serve_phase
(its checks included) and, unless --no-tune, chip_smoke.tune_phase. Then
one warmed-up server (max_batch 32, wait 2 ms) serves the same 1,024 crops
from 8 clients with 4 requests in flight each `--repeats` times; each run
prints its img/s, request latency p50 / p99, batches, mean fill and padded
share, with the card's name and power limit. The last line is one JSON
object with every run's numbers.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import torch

import chip_smoke as smoke
from experiments.torch_encoder_kernel_bench import card_line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--repeats', type=int, default=6)
    ap.add_argument('--no-tune', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('torch_serve_phase: no CUDA device available')
    from parseq_tpu_torch import hub
    from parseq_tpu_torch.ops import ar_kernel, flash_bwd
    from parseq_tpu_torch.serve import InferenceServer

    card = card_line()
    t0 = time.perf_counter()
    ar_kernel.library()
    flash_bwd.library()
    print(f'{card}; torch {torch.__version__} cuda {torch.version.cuda}; '
          f'B1 and B4 built in {time.perf_counter() - t0:.1f} s', flush=True)
    bundle = hub.parseq(seed=smoke.SEED)
    with torch.no_grad():
        bundle.module.head.bias[bundle.tokenizer.eos_id] += smoke.EOS_BIAS
    out = {'card': card, 'serve_phase': smoke.serve_phase(bundle, card)['runs']}
    if not args.no_tune:
        out['tune_phase'] = smoke.tune_phase(card)

    _, crops = smoke.serve_crops(bundle.img_size)
    server = InferenceServer(bundle, max_batch=smoke.SERVE_MAX_BATCH,
                             max_wait_ms=smoke.SERVE_WAIT_MS).start()
    out['repeats'] = []
    try:
        server.warmup()
        for i in range(args.repeats):
            _, r = smoke.drive(server, crops, smoke.SERVE_CLIENTS, smoke.SERVE_WINDOW)
            out['repeats'].append(r)
            print(f'repeat {i} [{card}]: {r["img_per_s"]:.1f} img/s; latency p50 '
                  f'{r["latency_ms_p50"]:.3f} ms, p99 {r["latency_ms_p99"]:.3f} ms; '
                  f'{r["batches"]} batches, mean fill {r["mean_fill"]:.2f}, padded share '
                  f'{r["padded_share"]:.3f}', flush=True)
    finally:
        server.stop()
    print(json.dumps(out))


if __name__ == '__main__':
    main()
