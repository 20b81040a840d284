"""The share of the traced span in which no kernel, copy or memset ran on
the device: 1 - (the union of the profiler's device intervals) / (the
span's length), both from the trace (harness/readers.py)."""

from harness.readers import idle_pct


def read(outcome, ctx):
    return idle_pct(outcome)
