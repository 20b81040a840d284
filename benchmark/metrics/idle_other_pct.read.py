"""The share of the traced span in which the device was idle while the main
thread was in none of the read loop's spans; with the other idle parts of its
domain it sums to device_idle_pct.read (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.idle_part(outcome, ctx, 'read', 'other')
