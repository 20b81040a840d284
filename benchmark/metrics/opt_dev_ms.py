"""Device ms a training step between the CUDA events of the program's span
train.optimizer: the optimizer step (AdamW), device idle inside included
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'train', 'train.optimizer', kind='device')
