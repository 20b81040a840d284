"""Device ms a read batch between the CUDA events of the program's spans
abinet.iteration, summed over the iterations (iter_size a batch): each a
language pass and its alignment, device idle inside included
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'abinet.iteration', kind='device')
