"""What the per-layer metric readers (benchmark/metrics/<metric>.py) share.
A reader takes the run's Outcome and Context and returns a number, or None
when the run has nothing for it to read. Every share below is read from the
profiler's trace of the traced span alone (harness/trace.py)."""

from __future__ import annotations

from harness import spec
from reference.tokenizer import Ids
from roofline import bounds


def mean(values):
    return sum(values) / len(values) if values else None


def mfu_pct(outcome, ctx, formula):
    """The FLOPs of the traced span's images (the formula's FLOPs an image
    times the span's iterations times the batch) over the span's length,
    as a share of the bf16 peak."""
    t = outcome.trace
    if t is None or not t.iters:
        return None
    m = ctx.cell.config['model']
    per_image = spec.flops(formula)(m, Ids(m['charset_train']))
    rate = t.iters * outcome.layer['batch'] / t.window_s
    return 100.0 * per_image * rate / bounds.PEAKS['bf16_flops_per_s']


def roofline_pct(outcome, kernel, bound):
    """The kernel's least time (bound: the kernel module -> (ms, what
    binds)) over its mean device time a call in the traced span, or None
    when the trace has no call of it."""
    if outcome.trace is None:
        return None
    k = spec.kernel(kernel)
    rows = outcome.trace.kernels(k.PATTERN)
    calls = sum(n for _, n, _ in rows)
    if not calls:
        return None
    return 100.0 * bound(k)[0] / (1e3 * sum(t for _, _, t in rows) / calls)


def idle_pct(outcome):
    """The share of the traced span in which no kernel, copy or memset ran
    on the device: 1 - busy_s / window_s of the result line."""
    t = outcome.trace
    if t is None or not t.iters:
        return None
    idle = 100.0 * (1.0 - t.busy_s / t.window_s)
    assert 0.0 <= idle <= 100.0, f'device idle share {idle} outside [0, 100]'
    return idle
