"""Device ms a read batch between the CUDA events of the program's span
vit.encoder: patch embedding, positions, the blocks (eager, or one launch
of kernel B5) and the final LayerNorm, device idle inside included
(harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'vit.encoder', kind='device')
