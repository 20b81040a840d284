"""Kernels the device ran a step in the traced span (profiler)."""


def read(outcome, ctx):
    t = outcome.trace
    if t is None or not t.iters:
        return None
    return sum(n for _, n, _ in t.kernels()) / t.iters
