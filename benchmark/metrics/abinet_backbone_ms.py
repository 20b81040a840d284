"""Device ms a read batch between the CUDA events of the program's span
abinet.backbone: ABINet's ResNet45 (convolutions and batch norms), device
idle inside included (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'abinet.backbone', kind='device')
