"""Device ms a read batch between the CUDA events of the program's span
abinet.transformer: the positional table and ABINet's vision transformer
layers (kernel B2 in each), device idle inside included
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'abinet.transformer', kind='device')
