"""The share of the traced span in which the device was idle while the main
thread was in eval.wait, eval.decode or eval.score (the batch in flight
awaited, decoded, scored); with the other idle parts of its domain it sums to
device_idle_pct.read (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.idle_part(outcome, ctx, 'read', 'post')
