"""The share of the traced span in which the device was idle while the main
thread was in train.step or a span beneath it; with the other idle parts of its
domain it sums to device_idle_pct.train (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.idle_part(outcome, ctx, 'train', 'step')
