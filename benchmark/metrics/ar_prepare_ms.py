"""Device ms a read batch between the CUDA events of the program's span
ar.prepare: B1's prepare() (the cross-attention K/V of the memory and the
decoder weights cast), device idle inside included (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'ar.prepare', kind='device')
