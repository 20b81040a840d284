"""Device ms a training step between the CUDA events of the program's span
train.backward: the backward, device idle inside included (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'train', 'train.backward', kind='device')
