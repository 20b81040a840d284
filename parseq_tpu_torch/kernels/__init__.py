"""Build and load the port's hand-written CUDA kernels (see build.py), and the
one switch that turns them all off.

Every kernel's gate (B1: ops/ar_kernel.py:takes; B2 and B4:
ops/attention.py:encoder_self_attention; B5: models/vit.py:takes_encoder_kernel;
the batch-norm pass csrc/bn_act.cu: ops/cnn.py:takes_kernel) asks `enabled()`.
Inside `plain()` each answers no, and the model runs its plain PyTorch path:
for comparisons with the kernels, and for the FLOP count, which sees no
product inside a kernel. Nothing else turns a kernel
off, and nothing on the main path opens `plain()`.
"""

from __future__ import annotations

import contextlib

_plain_depth = 0  # plain() contexts open


def enabled():
    """False while any plain() is open."""
    return _plain_depth == 0


@contextlib.contextmanager
def plain():
    """Run every model on its plain path, no hand-written kernel, while the
    context is open. Nests; leaving it, by return or by an exception,
    restores what was before."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1
