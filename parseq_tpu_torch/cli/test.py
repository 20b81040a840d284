"""Benchmark-suite evaluation with the PyTorch port (counterpart of
parseq_tpu/cli/test.py; reference test.py).

Usage:
    python -m parseq_tpu_torch.cli.test <checkpoint> [--data_root data]
        [--cased] [--punctuation] [--new] [--rotation N] [--int8] [--device cuda|cpu]
        [model_override:type=value ...]

`checkpoint` is what cli/read.py takes: a reference PyTorch .pt or .ckpt
file, a checkpoint the port's trainer wrote, a JAX package checkpoint, or
`pretrained=<experiment>`; `--int8` quantizes the ViT encoder after the
load (counted in the load time).
Prints the Benchmark (Subset) and Benchmark tables (and New with --new)
and writes them to `<checkpoint>.log.txt`; on stderr, the images read per
second over all sets, the time spent waiting on the loader (its first batch
of each set, which includes starting the decode pool, apart) and the
model's load. The default device is cuda; with no GPU the command fails
unless --device cpu is given.

The loader's decode pool forks its workers when each benchmark set is
iterated, after the model is on the card. The workers only decode images
(PIL and numpy) and never call CUDA; if one did, torch raises in the
forked child rather than share the parent's CUDA state.
"""

from __future__ import annotations

import argparse
import os
import string
import sys
import time

import torch

from parseq_tpu_torch.data import module as data_module
from parseq_tpu_torch.train.evaluate import eval_dataset, print_results_table
from parseq_tpu_torch.utils import trace
from parseq_tpu_torch.utils.config import parse_model_args
from parseq_tpu_torch.utils.registry import load_from_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('checkpoint')
    ap.add_argument('--data_root', default='data')
    ap.add_argument('--batch_size', type=int, default=512)
    ap.add_argument('--num_workers', type=int, default=4)
    ap.add_argument('--cased', action='store_true')
    ap.add_argument('--punctuation', action='store_true')
    ap.add_argument('--new', action='store_true', help='Include new benchmark datasets')
    ap.add_argument('--rotation', type=int, default=0)
    ap.add_argument('--int8', action='store_true',
                    help='int8 encoder serving path (ViT-backed models)')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args, unknown = ap.parse_known_args(argv)
    kwargs = parse_model_args(unknown)

    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')
    if (os.cpu_count() or 1) <= 1 and args.num_workers > 0:
        # one core: a decode pool adds IPC cost and no parallelism
        print('single-core host: running decode inline (num_workers=0)', file=sys.stderr)
        args.num_workers = 0

    charset_test = string.digits + string.ascii_lowercase
    if args.cased:
        charset_test += string.ascii_uppercase
    if args.punctuation:
        charset_test += string.punctuation
    kwargs['charset_test'] = charset_test
    print(f'Additional keyword arguments: {kwargs}')

    t0 = time.perf_counter()
    model = load_from_checkpoint(args.checkpoint, device=args.device, **kwargs)
    if args.int8:
        from parseq_tpu_torch.ops.quant import quantize_bundle

        model = quantize_bundle(model)
    load_s = time.perf_counter() - t0
    dm = data_module.SceneTextDataModule(
        args.data_root, '_unused_', model.img_size,
        model.raw_config.get('max_label_length', 25),
        model.raw_config['charset_train'], charset_test,
        args.batch_size, args.num_workers, augment=False, rotation=args.rotation,
    )

    test_set = data_module.TEST_BENCHMARK_SUB + data_module.TEST_BENCHMARK
    if args.new:
        test_set += data_module.TEST_NEW
    test_set = sorted(set(test_set))

    results = {}
    timing = {'load_s': load_s, 'loader_s': 0.0, 'first_batch_s': 0.0}
    t0 = time.perf_counter()
    for name, loader in dm.test_dataloaders(test_set).items():
        print(f'Evaluating {name}...', file=sys.stderr)
        trace.clear()
        with trace.recording():
            results[name] = eval_dataset(model, loader, name)
        # eval_dataset's eval.next spans: the time blocked on the loader
        waits = [s['end_ns'] - s['start_ns'] for s in trace.spans() if s['name'] == 'eval.next']
        timing['loader_s'] += sum(waits) * 1e-9
        timing['first_batch_s'] += waits[0] * 1e-9
    trace.clear()
    timing['eval_s'] = time.perf_counter() - t0
    timing['images'] = sum(r.num_samples for r in results.values())
    print(f"Read {timing['images']} images in {timing['eval_s']:.2f} s "
          f"({timing['images'] / timing['eval_s']:.1f} img/s), "
          f"{timing['loader_s']:.2f} s of it waiting on the loader "
          f"({timing['first_batch_s']:.2f} s for the first batch of each set); "
          f"model load {load_s:.2f} s apart", file=sys.stderr)

    result_groups = {
        'Benchmark (Subset)': data_module.TEST_BENCHMARK_SUB,
        'Benchmark': data_module.TEST_BENCHMARK,
    }
    if args.new:
        result_groups['New'] = data_module.TEST_NEW
    with open(args.checkpoint + '.log.txt', 'w') as f:
        for out in (f, sys.stdout):
            for group, subset in result_groups.items():
                print(f'{group} set:', file=out)
                print_results_table([results[s] for s in subset], out)
                print('\n', file=out)
    return results, timing


if __name__ == '__main__':
    main()
