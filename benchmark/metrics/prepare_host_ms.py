"""Host ms a training step in the program's span train.prepare: the
family's host preparation of the labels (encoding, permutations)
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'train', 'train.prepare')
