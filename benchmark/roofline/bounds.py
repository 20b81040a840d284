"""Least time of a kernel call on the card: the larger of its bytes over the
HBM rate and its operations over the peak rate of their type. Each kernel's
operations and bytes are in roofline/kernels/<kernel>.py, counting what the
inputs need: each input byte read once, each output byte written once,
whatever the kernel reads again."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name('peaks.json')).read_text())


def bound(bytes_moved, bf16_flops=0.0, f32_flops=0.0):
    """(ms, 'bytes' | 'operations'): the least time and what binds it."""
    t_bytes = bytes_moved / PEAKS['hbm_bytes_per_s']
    t_ops = bf16_flops / PEAKS['bf16_flops_per_s'] + f32_flops / PEAKS['f32_flops_per_s']
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'
