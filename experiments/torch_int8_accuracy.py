#!/usr/bin/env python
"""Int8-encoder accuracy against bf16 at PARSeq-S geometry, on the card
(the port's counterpart of experiments/int8_accuracy.py).

    python experiments/torch_int8_accuracy.py [--steps 1500] [--batch 128] [--device cuda]
        [model_override:type=value ...]

Trains a PARSeq-S-shaped model (12 encoder blocks of 384, the 94-character
charset) from scratch on synthetic rendered words through the port's
training step (train/steps.py, bf16, dropout on), then reads held-out
renderings of the same words twice: the bf16 model, and the same model with
its encoder's 4 products a block quantized to int8 (ops/quant.py:
quantize_bundle, per-output-channel weights, dynamic per-token
activations). Prints each path's word accuracy, the share of val strings
on which the two agree, the card's name and power limit, and one JSON line.
The bar for making int8 a default: accuracy within noise of bf16 and high
agreement. The data is the JAX experiment's (a copy of
experiments/convergence_tpu.py's render and make_data: a fixed 64-word
vocabulary of 2-5 characters at random positions and colours).
"""

import argparse
import json
import os
import string
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import numpy as np
import torch
from PIL import Image, ImageDraw

from parseq_tpu_torch.data.charset import CHARSET_36
from parseq_tpu_torch.ops.quant import quantize_bundle
from parseq_tpu_torch.train.evaluate import score_batch
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.optim import OptimConfig
from parseq_tpu_torch.train.steps import init_state, make_train_step
from parseq_tpu_torch.utils.config import parse_model_args
from parseq_tpu_torch.utils.registry import create_model

H, W = 32, 128


def render(word, rng):
    img = Image.new('RGB', (W, H), tuple(int(c) for c in rng.integers(200, 256, 3)))
    d = ImageDraw.Draw(img)
    x = int(rng.integers(2, 20))
    y = int(rng.integers(2, 12))
    d.text((x, y), word, fill=tuple(int(c) for c in rng.integers(0, 80, 3)))
    return np.asarray(img, np.float32) / 127.5 - 1.0


def make_data(n, rng, vocab=None):
    """n renderings of words of a fixed 64-word vocabulary (drawn from `rng`
    unless given): the model must learn character recognition, as words
    come at random positions and colours, and ~1k steps suffice."""
    if vocab is None:
        vocab = [''.join(rng.choice(list(CHARSET_36), int(rng.integers(2, 6))))
                 for _ in range(64)]
    words = []
    imgs = np.zeros((n, H, W, 3), np.float32)
    for i in range(n):
        w = vocab[int(rng.integers(len(vocab)))]
        words.append(w)
        imgs[i] = render(w, rng)
    return imgs, words, vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=1500)
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('model_args', nargs='*', help='Model overrides key:type=value (a smaller '
                    'model for a CPU rehearsal)')
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')

    rng = np.random.default_rng(0)
    charset = string.digits + string.ascii_lowercase + string.ascii_uppercase + string.punctuation
    bundle = create_model('parseq', seed=0, device=device, charset_train=charset,
                          charset_test=charset, **parse_model_args(args.model_args))
    tok, cfg, model = bundle.tokenizer, bundle.cfg, bundle.module
    train_imgs, train_words, vocab = make_data(4096, rng)
    val_imgs, val_words, _ = make_data(512, rng, vocab)

    family = get_family('parseq')
    step = make_train_step(family, cfg, torch.bfloat16)
    state = init_state(model.train(), OptimConfig(lr=7e-4, batch_size=args.batch,
                                                  total_steps=args.steps, warmup_pct=0.1,
                                                  swa=False))
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    for s in range(1, args.steps + 1):
        idx = rng.integers(0, len(train_words), args.batch)
        labels = [train_words[i] for i in idx]
        batch = {'images': torch.from_numpy(train_imgs[idx]).to(device),
                 **{k: torch.from_numpy(v).to(device)
                    for k, v in family.prepare(tok, labels, cfg, rng).items()}}
        metrics = step(state, batch, gen)
        if s % 250 == 0 or s == args.steps:
            print(f'step {s:4d}: loss={float(metrics["loss"]):.3f} ({time.time() - t0:.0f} s)',
                  flush=True)
    model.eval()

    def run_eval(b):
        correct = total = 0
        strings = []
        for i in range(0, len(val_words), args.batch):
            labels = val_words[i:i + args.batch]
            probs = torch.softmax(b(val_imgs[i:i + args.batch]), -1).cpu().numpy()
            r = score_batch(tok, bundle.charset_adapter, probs, labels)
            strings.extend(tok.decode(probs)[0])
            correct += r.correct
            total += r.num_samples
        return 100.0 * correct / total, strings

    results, strings = {'steps': args.steps, 'batch': args.batch, 'device': str(device)}, {}
    for name, b in (('bf16', bundle), ('int8_encoder', quantize_bundle(bundle))):
        acc, strings[name] = run_eval(b)
        results[f'{name}_val_acc'] = acc
        print(f'{name}: val_acc={acc:.2f}%', flush=True)
    results['string_agreement'] = float(np.mean(
        [x == y for x, y in zip(strings['bf16'], strings['int8_encoder'])]))
    results['wall_s'] = time.time() - t0  # training and both evaluations
    print(f'string agreement bf16 vs int8: {results["string_agreement"]:.4f}', flush=True)
    if device.type == 'cuda':
        from parseq_tpu_torch.cli.bench import card_line

        results['card'] = card_line()
        print(results['card'])
    print(json.dumps(results))
    return results


if __name__ == '__main__':
    main()
