"""What a driver is given: the cell, the run's arguments, the device, and
where it may write."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from harness.spec import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = 'cuda'
    out_dir: object = None
    t_process: float = field(default_factory=time.perf_counter)
    # after the window: keep what the control and limit calibration read
    keep: dict = field(default_factory=dict)


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict  # end-to-end: name -> (value, unit)
    readings: dict  # compared numbers: name -> value
    layer: dict = field(default_factory=dict)  # what per-layer readers read
    trace: object = None
    memory_peak_bytes: int = 0
    notes: list = field(default_factory=list)  # lines printed before the result
