"""Faults planted under the timed path, for the checks that `correct`
catches them (benchmark/calibrate.py on the card, benchmark/tests on the
CPU). Each takes the cell and is a context manager that patches the
program and restores it.

- read_half_batch: the second half of every batch gets the first half's
  logits (half the batch left out, answered from the rest);
- read_token: one position of every read gets the next id where the ids
  are produced (the argmax handed to decode_ids);
- train_half_batch: every step's loss is the mean over the first half of
  its rows;
- train_unchanged: AdamW returns the gradient's norm and leaves the
  parameters and its moments as they were.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def read_half_batch(cell):
    from parseq_tpu_torch.utils.registry import ModelBundle

    orig = ModelBundle.__call__

    def call(self, images):
        logits = orig(self, images).clone()
        h = logits.shape[0] // 2
        logits[logits.shape[0] - h:] = logits[:h]
        return logits

    return _patched(ModelBundle, '__call__', call)


def read_token(cell, position=3):
    from parseq_tpu_torch.train import evaluate

    orig = evaluate._device_post

    def post(logits):
        ids, conf = orig(logits)
        ids = ids.clone()
        ids[:, position] = (ids[:, position] + 1) % logits.shape[-1]
        return ids, conf

    return _patched(evaluate, '_device_post', post)


def train_half_batch(cell):
    from parseq_tpu_torch.train import families

    fam = families.get_family(cell.config['experiment'])
    orig = fam.loss

    def loss(model, cfg, batch, rng, dtype, **static):
        h = batch['images'].shape[0] // 2
        half = {k: v[:h] if v.dim() > 0 and v.shape[0] == 2 * h else v for k, v in batch.items()}
        return orig(model, cfg, half, rng, dtype, **static)

    return _patched(fam, 'loss', loss)


def train_unchanged(cell):
    import torch

    from parseq_tpu_torch.train import optim

    def step(self, params, grads):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    return _patched(optim.AdamW, 'step', step)


FAULTS = {'read_half_batch': read_half_batch, 'read_token': read_token,
          'train_half_batch': train_half_batch, 'train_unchanged': train_unchanged}
