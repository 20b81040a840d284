"""The share of the traced span in which the device was idle while the main
thread was in none of the training loop's spans (the batch's copy, the loop's
Python); with the other idle parts of its domain it sums to
device_idle_pct.train (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.idle_part(outcome, ctx, 'train', 'other')
