#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py

Drives the port's main path once, at the full width and depth of PARSeq-S
(random weights from a seed), in phases, each printing its result:

  1. environment: versions, nvcc, optional modules, card name and power limit;
  2. build: kernel B1 (csrc/ar_decode.cu) with nvcc for sm_90a;
  3. kernel vs plain: fused AR decode against its plain PyTorch version,
     teacher-forced on the kernel's picks, at B = 1, 7, 256;
  4. main path: hub.parseq() on cuda in bf16 reads batches of 1, 7 and 256
     NHWC images; the kernel's launch count must rise;
  5. times at B = 256 (CUDA events, median of 20 after warm-up): kernel vs
     plain version, and the whole forward in images/s.

Any failure raises and exits non-zero. Without a CUDA device, or without
the repository beside it, it fails and prints no result. The last lines
are the kernel table, the card line of nvidia-smi, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCHES = (1, 7, 256)
TIMED_BATCH = 256
TIMED_RUNS = 20
# Kernel vs plain: the same f32/bf16 roundings, f32 sums in another order.
KERNEL_ATOL = 1e-2
# Greedy picks must agree wherever the top-2 margin exceeds bf16 noise.
KERNEL_MARGIN = 0.05
# Random weights give near-uniform logits (p ~ 1/95 per class), so greedy
# text rarely ends with EOS inside max_label_length and its confidence
# product underflows float32. The smoke raises the head's EOS bias so every
# read ends inside the limit with a representable confidence (with +2.0 on
# the seed-0 weights every row decodes to '' at conf ~0.04 on the H100).
EOS_BIAS = 2.0
# bf16 main path vs the f32 scan path: the bf16 encoder moves logits by
# ~1e-2; greedy picks must agree where the f32 top-2 margin exceeds 0.1.
MAIN_ATOL = 5e-2
MAIN_MARGIN = 0.1


def phase(name):
    print(f'== {name}', flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def importable(name):
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def cuda_median_ms(fn, runs=TIMED_RUNS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want):
    """Max abs difference; raises unless within KERNEL_ATOL and the greedy
    picks agree wherever the margin exceeds KERNEL_MARGIN."""
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > KERNEL_MARGIN
    agree = bool((got.argmax(-1) == want.argmax(-1))[confident].all())
    if not (err <= KERNEL_ATOL and agree):
        raise AssertionError(f'kernel disagrees with plain version: max_abs_err={err} '
                             f'(limit {KERNEL_ATOL}), confident argmax equal={agree}')
    return err


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    from parseq_tpu_torch import hub
    from parseq_tpu_torch.kernels.build import find_nvcc
    from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
    from parseq_tpu_torch.ops import ar_kernel

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase('1 environment')
    card = card_line()
    print(f'python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}')
    print(f'nvcc {find_nvcc()}; nvidia-smi {shutil.which("nvidia-smi")}')
    print('importable: ' + ', '.join(f'{m}={importable(m)}' for m in ('triton', 'yaml', 'PIL')))
    print(f'card: {card}; devices {torch.cuda.device_count()}; '
          f'SMs {torch.cuda.get_device_properties(dev).multi_processor_count}')

    phase('2 build')
    t0 = time.perf_counter()
    lib = ar_kernel.library()
    print(f'built {lib._name} in {time.perf_counter() - t0:.1f} s')

    phase('3 kernel vs plain (full PARSeq-S geometry)')
    cfg = PARSeqConfig()
    model = PARSeq(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    memories = {}
    with torch.inference_mode():
        for B in BATCHES:
            images = torch.from_numpy(
                rng.uniform(-1, 1, (B, *cfg.img_size, 3)).astype(np.float32)).to(dev)
            memory = model.encode(images.to(torch.bfloat16)).contiguous()
            memories[B] = memory
            got = ar_kernel.ar_decode_fused(model, memory)
            torch.cuda.synchronize()
            want = ar_kernel.ar_decode_fused_reference(model, memory, tokens=got.argmax(-1))
            torch.cuda.synchronize()
            if got.shape != (B, cfg.num_steps, cfg.num_classes) or not torch.isfinite(got).all():
                raise AssertionError(f'kernel output {tuple(got.shape)} not finite or misshapen')
            err = compare(got, want)
            max_err = max(max_err, err)
            print(f'B={B}: memory {tuple(memory.shape)} max_abs_err={err:.3e} ok')

    phase('4 main path: hub.parseq().read on cuda, bf16')
    bundle = hub.parseq(seed=SEED)
    with torch.no_grad():
        bundle.module.head.bias[cfg.eos_id] += EOS_BIAS
    charset = set(bundle.tokenizer.charset)
    batches = {B: rng.uniform(-1, 1, (B, *cfg.img_size, 3)).astype(np.float32) for B in BATCHES}
    ar_kernel.launches = 0
    results = {B: bundle.read(images) for B, images in batches.items()}
    launches = ar_kernel.launches
    if launches < 1:
        raise AssertionError('the main path did not launch the fused AR kernel')
    for B, (labels, confs) in results.items():
        if not len(labels) == len(confs) == B:
            raise AssertionError(f'read returned {len(labels)} labels for {B} images')
        for text, conf in zip(labels, confs):
            if not (isinstance(text, str) and len(text) <= cfg.max_label_length
                    and set(text) <= charset and 0.0 < conf <= 1.0):
                raise AssertionError(f'bad read at B={B}: {text!r} conf={conf}')
        print(f'B={B}: {labels[:3]} conf {[f"{c:.3g}" for c in confs[:3]]}')
    print(f'ar_decode_fused launches during the main path: {launches}')
    # The same images through the port's f32 scan path on the card.
    with torch.inference_mode():
        x = torch.from_numpy(batches[7]).to(dev)
        main = bundle.module(x, dtype=torch.bfloat16)
        ref = bundle.module(x, dtype=torch.float32, use_fused_ar=False)
    top2 = ref.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > MAIN_MARGIN
    agree = bool((main.argmax(-1) == ref.argmax(-1))[confident].all())
    diff = float((main - ref).abs().max())
    print(f'B=7 bf16 main path vs f32 scan: max_abs_diff={diff:.3e}, argmax equal where the '
          f'f32 margin > {MAIN_MARGIN} ({int(confident.sum())} positions): {agree}')
    if not (main.shape == ref.shape and torch.isfinite(main).all() and diff <= MAIN_ATOL and agree):
        raise AssertionError('main path disagrees with the f32 scan path')

    phase('5 times at B=256')
    memory = memories[TIMED_BATCH]
    with torch.inference_mode():
        kernel_ms = cuda_median_ms(lambda: ar_kernel.ar_decode_fused(model, memory))
        plain_ms = cuda_median_ms(lambda: ar_kernel.ar_decode_fused_reference(model, memory))
        x = torch.from_numpy(batches[TIMED_BATCH]).to(dev)
        fwd_ms = cuda_median_ms(lambda: bundle(x))
    print(f'ar_decode_fused kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; '
          f'forward {fwd_ms:.4f} ms = {TIMED_BATCH / fwd_ms * 1e3:.1f} img/s [{card}]')

    print(json.dumps({'kernels': [{
        'name': 'ar_decode_fused', 'route': 'cuda',
        'source': 'parseq_tpu_torch/csrc/ar_decode.cu',
        'replaces': 'parseq_tpu/ops/ar_kernel.py:158',
        'launches': launches, 'max_abs_err': max_err, 'ms': kernel_ms, 'plain_ms': plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
