#!/usr/bin/env python
"""The full-workflow accuracy protocol of experiments/e2e_full_workflow.py,
run on the PyTorch port (parseq_tpu_torch) on one CUDA card.

    python3 experiments/torch_e2e_workflow.py [--root build/e2e] [--steps 1500]

1. Renders words of a fixed 64-word vocabulary (2-5 chars of the 36-char
   charset, random position and colours, PIL's default font) into LMDBs
   with the port's writer: 6,144 train, 512 val, 128 for each benchmark
   test set.
2. Trains PARSeq-S through `parseq_tpu_torch.cli.train` with the protocol's
   settings: `--charset 36_lowercase`, batch 128, augment off,
   `trainer.max_steps` 1500, validation every 250 steps, the configured
   `trainer.microbatches`, on cuda.
3. Scores `last.ckpt` on the test sets as the JAX package's `cli.test` does
   (lowercase alphanumeric charset, bf16 forward, accuracy / 1 - NED per
   set) and prints both Combined rows (Benchmark subset and Benchmark).

The JAX package's runs of this protocol scored 96.09-98.83% combined on a
TPU (PERF.md TPU history). The last line of the output is one JSON object
with the per-set and combined accuracies, the wall time and the card.
Imports nothing of the JAX package.
"""

import argparse
import io
import json
import os
import string
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import numpy as np
import PIL
import torch
from PIL import Image, ImageDraw

from parseq_tpu_torch.data import module as data_module
from parseq_tpu_torch.data.lmdb import LmdbWriter
from parseq_tpu_torch.train.evaluate import BatchResult, score_decoded, summarize
from parseq_tpu_torch.train.steps import normalize_u8

CHARSET_36 = string.digits + string.ascii_lowercase
H, W = 32, 128


def render(word, rng):
    """experiments/convergence_tpu.py:render: light background, dark text at
    a random offset, as float32 in [-1, 1]."""
    img = Image.new('RGB', (W, H), tuple(int(c) for c in rng.integers(200, 256, 3)))
    d = ImageDraw.Draw(img)
    x = int(rng.integers(2, 20))
    y = int(rng.integers(2, 12))
    d.text((x, y), word, fill=tuple(int(c) for c in rng.integers(0, 80, 3)))
    return np.asarray(img, np.float32) / 127.5 - 1.0


def png(img_float):
    arr = np.clip((img_float * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(arr).save(b, 'PNG')
    return b.getvalue()


def write_db(path, samples):
    with LmdbWriter(path) as w:
        w.put(b'num-samples', str(len(samples)).encode())
        for i, (img, label) in enumerate(samples, start=1):
            w.put(f'image-{i:09d}'.encode(), img)
            w.put(f'label-{i:09d}'.encode(), label.encode())


def make_split(rng, vocab, n):
    out = []
    for _ in range(n):
        word = vocab[int(rng.integers(len(vocab)))]
        out.append((png(render(word, rng)), word))
    return out


def evaluate(bundle, loader, name, device):
    """One test set through the bf16 forward; cli.test's scoring."""
    total = BatchResult()
    with torch.inference_mode():
        for images, labels, valid in loader:
            x = normalize_u8(torch.from_numpy(images).to(device))
            probs = torch.softmax(bundle.module(x, dtype=bundle.dtype), -1)
            ids = probs.argmax(-1)
            conf = torch.gather(probs, -1, ids[..., None])[..., 0]
            preds, pred_probs = bundle.tokenizer.decode_ids(ids.cpu().numpy(),
                                                            conf.cpu().numpy())
            total.add(score_decoded(bundle.charset_adapter, preds, pred_probs, labels, valid))
    return summarize(name, total)


def combined(results):
    n = sum(r.num_samples for r in results)
    return {'num_samples': n,
            'accuracy': sum(r.accuracy * r.num_samples for r in results) / max(n, 1),
            'ned': sum(r.ned * r.num_samples for r in results) / max(n, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default='build/e2e')
    ap.add_argument('--steps', type=int, default=1500)
    ap.add_argument('--batch_size', type=int, default=128)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--vocab_size', type=int, default=64)
    ap.add_argument('--train_size', type=int, default=6144)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--overrides', nargs='*', default=[],
                    help='extra dotted train-CLI overrides')
    args = ap.parse_args(argv)
    root = args.root
    rng = np.random.default_rng(0)
    vocab = [''.join(rng.choice(list(CHARSET_36), int(rng.integers(2, 6))))
             for _ in range(args.vocab_size)]

    t0 = time.time()
    write_db(f'{root}/data/train/real/syn', make_split(rng, vocab, args.train_size))
    write_db(f'{root}/data/val/syn', make_split(rng, vocab, 512))
    test_sets = sorted(set(data_module.TEST_BENCHMARK + data_module.TEST_BENCHMARK_SUB))
    for name in test_sets:
        write_db(f'{root}/data/test/{name}', make_split(rng, vocab, 128))
    print(f'[{time.time() - t0:5.0f}s] LMDBs written', flush=True)

    from parseq_tpu_torch.cli.train import main as train_main
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    work = f'{root}/run'
    train_main(['--charset', '36_lowercase', '--work_dir', work, '--seed', str(args.seed),
                '--device', args.device,
                f'data.root_dir={root}/data', 'data.num_workers=0', 'data.augment=false',
                f'model.batch_size={args.batch_size}', f'trainer.max_steps={args.steps}',
                'trainer.val_check_interval=250', 'trainer.devices=1'] + list(args.overrides))
    print(f'[{time.time() - t0:5.0f}s] training done', flush=True)

    charset_test = string.digits + string.ascii_lowercase
    bundle = load_from_checkpoint(f'{work}/checkpoints/last.ckpt', device=args.device,
                                  charset_test=charset_test)
    dm = data_module.SceneTextDataModule(
        f'{root}/data', '_unused_', bundle.img_size, bundle.cfg.max_label_length,
        bundle.raw_config['charset_train'], charset_test, 256, 0, augment=False)
    results = {name: evaluate(bundle, loader, name, args.device)
               for name, loader in dm.test_dataloaders(test_sets).items()}
    for name, r in results.items():
        print(f'{name}: {r.num_samples} samples, accuracy {r.accuracy:.2f}, 1 - NED {r.ned:.2f}')
    metrics = [json.loads(line) for line in open(f'{work}/metrics.jsonl')]
    card = 'cpu'
    if args.device.startswith('cuda'):
        card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    subset = combined([results[s] for s in data_module.TEST_BENCHMARK_SUB])
    print(json.dumps({
        'combined_benchmark_subset': subset,
        'combined_benchmark': combined([results[s] for s in data_module.TEST_BENCHMARK]),
        'per_set_accuracy': {k: r.accuracy for k, r in results.items()},
        'val': [m for m in metrics if 'val_accuracy' in m],
        'steps': args.steps, 'wall_s': round(time.time() - t0, 1), 'card': card,
        'pillow': PIL.__version__}))


if __name__ == '__main__':
    main()
