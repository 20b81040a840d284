"""Model benchmarking CLI of the PyTorch port (counterpart of
parseq_tpu/cli/bench.py; reference bench.py).

Prints one JSON line per run with the parameter count, the static FLOPs per
image (utils/flops.py, fvcore's MAC convention) and the forward latency:
the median and interquartile range over `--trials` trials, each the mean
time per batch over `--iters` distinct device-resident batches, timed with
CUDA events on the card (the host clock on the CPU). `--sweep` sweeps the
max label length 1..25 in steps of 4, as the reference's `+range=true`.
Defaults come from configs/bench.yaml. On the card it first prints the
card's name and power limit, as nvidia-smi reports them. `params_M` counts
the module's parameters, not its buffers: for the batch-norm families it is
below the JAX CLI's, which also counts the running statistics. With
`--int8` (the ViT encoder's products quantized, ops/quant.py) it counts the
int8 codes, scales and biases, as the JAX CLI counts its quantized tree;
the MACs of an int8 run equal the bf16 run's (utils/flops.py counts
`_int_mm`).

Usage:
    python -m parseq_tpu_torch.cli.bench --model parseq [--batch_size 1] [--sweep]
        [--int8] [--device cuda|cpu] [--dtype bfloat16|float32] [--profile DIR]
        [model_override:type=value ...]

The default device is cuda; with no GPU the command fails unless --device
cpu is given. This is the module CLI, not the repository's benchmark: it
fixes no batch size and writes no file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops.quant import Int8Linear, quantize_bundle
from parseq_tpu_torch.utils import trace
from parseq_tpu_torch.utils.config import CONFIG_ROOT, _load, parse_model_args
from parseq_tpu_torch.utils.flops import count_flops
from parseq_tpu_torch.utils.registry import create_model

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_forward(fwd, batches, trials, device):
    """Median and IQR (ms) over `trials` of the mean time per batch."""
    cuda = device.type == 'cuda'
    times = []
    for _ in range(trials):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for b in batches:
                fwd(b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(batches))
        else:
            t0 = time.perf_counter()
            for b in batches:
                fwd(b)
            times.append((time.perf_counter() - t0) * 1e3 / len(batches))
    qs = statistics.quantiles(times, n=4) if len(times) > 1 else (times[0],) * 3
    return statistics.median(times), qs[2] - qs[0]


def per_image_flops(model, images):
    """MACs per image through the plain paths (kernels.plain()): kernels are
    opaque to the counter. None when counting fails (the number is
    informational)."""
    try:
        with kernels.plain():
            macs = count_flops(model.module, images, dtype=model.dtype)
    except Exception:  # noqa: BLE001 - flops are informational
        return None
    return macs / images.shape[0]


def bench_model(name, batch_size=1, iters=8, trials=7, device='cuda', dtype=torch.bfloat16,
                int8=False, **kwargs):
    device = torch.device(device)
    model = create_model(name, device=device, dtype=dtype, **kwargs)
    if int8:
        model = quantize_bundle(model)
    h, w = model.img_size
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [torch.rand((batch_size, h, w, 3), generator=gen, device=device)
               for _ in range(iters + 1)]
    flops = per_image_flops(model, batches[0])

    model(batches[-1])  # warm-up: builds the kernels on the card
    if device.type == 'cuda':
        torch.cuda.synchronize()
    med, iqr = time_forward(model, batches[:iters], trials, device)
    n_params = sum(p.numel() for p in model.module.parameters()) + sum(
        b.numel() for m in model.module.modules() if isinstance(m, Int8Linear)
        for b in m.buffers(recurse=False))
    return {
        'model': model.name,
        'params_M': round(n_params / 1e6, 3),
        'flops_per_img_G': round(flops / 1e9, 3) if flops is not None else None,
        'batch_size': batch_size,
        'latency_ms_median': round(med, 3),
        'latency_ms_iqr': round(iqr, 3),
        'throughput_img_s': round(batch_size / med * 1e3, 1),
    }


def _bench_defaults():
    """Composable defaults from configs/bench.yaml (reference configs/bench.yaml)."""
    try:
        cfg = _load(CONFIG_ROOT / 'bench.yaml')
    except OSError:
        cfg = {}
    d = cfg.get('bench', {}) or {}
    d.setdefault('model', (cfg.get('defaults') or {}).get('model', 'parseq'))
    return d


def main(argv=None):
    d = _bench_defaults()
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--model', default=d.get('model', 'parseq'))
    ap.add_argument('--batch_size', type=int, default=d.get('batch_size', 1))
    ap.add_argument('--iters', type=int, default=d.get('iters', 8))
    ap.add_argument('--trials', type=int, default=d.get('trials', 7))
    ap.add_argument('--sweep', action='store_true', default=bool(d.get('sweep', False)),
                    help='sweep label length 1..25 step 4')
    ap.add_argument('--int8', action='store_true',
                    help='int8 encoder serving path (ViT-backed models)')
    ap.add_argument('--profile', default=None, metavar='DIR',
                    help='write a torch.profiler trace of the runs, with the program\'s '
                         'spans, to DIR/trace.json')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    ap.add_argument('--dtype', default='bfloat16', choices=sorted(DTYPES))
    args, unknown = ap.parse_known_args(argv)
    kwargs = parse_model_args(unknown)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')
    if device.type == 'cuda':
        print(card_line(), flush=True)

    lengths = range(1, 26, 4) if args.sweep else (None,)
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if device.type == 'cuda' else []))
    results = []
    with prof:
        for L in lengths:
            extra = {} if L is None else {'max_label_length': L}
            r = bench_model(args.model, args.batch_size, args.iters, args.trials, device,
                            DTYPES[args.dtype], args.int8, **extra, **kwargs)
            if L is not None:
                r['max_label_length'] = L
            print(json.dumps(r), flush=True)
            results.append(r)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, 'trace.json')
        prof.export_chrome_trace(path)
        trace.merge_chrome(path)  # the program's spans, a track of their own
        trace.clear()
    return results


if __name__ == '__main__':
    main()
