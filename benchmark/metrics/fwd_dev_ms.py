"""Device ms a training step between the CUDA events of the program's span
train.forward: the forward and loss, device idle inside included
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'train', 'train.forward', kind='device')
