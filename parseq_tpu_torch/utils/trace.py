"""Spans: named, nested intervals of the program's host time, kept in memory
so that a profiler trace can be read layer by layer.

    with trace.span('eval.h2d', batch=i) as s:
        ...
        s.set(rows=n)    # an attribute known only inside the block

A span records its name, start and end, the span open around it on the
same thread (its parent), the thread, and its keyword attributes. With
`device=True` it also records a pair of timing CUDA events on the current
stream, whose elapsed time `spans()` reads after a synchronize: the device
time between the span's start and end, idle included.

Recording is on while a torch profiler runs (the flag `profile.start()`
and `stop()` set) and inside `recording()`. Off, `span` tests that flag
and returns a shared object that does nothing: no record, no clock read, no
CUDA call.

Stamps are `time.perf_counter_ns()`, put on the epoch's clock through one
(`time.time_ns()`, `perf_counter_ns()`) pair taken when the first span is
recorded (after import or `clear()`). A profiler's Chrome trace writes its
events on the same clock, less its `baseTimeNanoseconds`, so a span lands
on the timeline of the kernels and CUDA runtime calls it issued;
`merge_chrome` adds the spans to such a trace as a track of their own.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

_records: list = []
_local = threading.local()
_pair = None  # (time_ns, perf_counter_ns) taken at the first recorded span
_forced = 0  # depth of open recording() blocks


class _Off:
    """The span returned while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ('name', 'attrs', 'start', 'end', 'parent', 'thread', 'events', 'device_ms')

    def __init__(self, name, device, attrs):
        global _pair
        if _pair is None:
            _pair = (time.time_ns(), time.perf_counter_ns())
        self.name, self.attrs = name, attrs
        self.end = self.device_ms = None
        self.events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                       if device and torch.cuda.is_initialized() else None)

    def __enter__(self):
        stack = _local.__dict__.setdefault('stack', [])
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        _records.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _local.stack.pop()
        return False

    def set(self, **attrs):
        """Add attributes known only inside the block."""
        self.attrs.update(attrs)


def span(name, device=False, **attrs):
    """A context manager that records one span while recording is on."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


@contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans():
    """The spans recorded since import or `clear()`, in the order they
    opened: dicts of name, start_ns and end_ns (epoch; end None while
    open), parent (an index into this list, or None), thread, attrs and
    device_ms (None without device events)."""
    if any(s.events is not None and s.end is not None for s in _records):
        torch.cuda.synchronize()
        for s in _records:
            if s.events is not None and s.end is not None:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
    index = {id(s): i for i, s in enumerate(_records)}
    base = _pair[0] - _pair[1] if _pair else 0
    return [{'name': s.name, 'start_ns': base + s.start,
             'end_ns': None if s.end is None else base + s.end,
             'parent': None if s.parent is None else index.get(id(s.parent)),
             'thread': s.thread, 'attrs': dict(s.attrs), 'device_ms': s.device_ms}
            for s in _records]


def clear():
    """Drop every recorded span; the next one takes a fresh clock pair."""
    global _pair
    _records.clear()
    _pair = None


def merge_chrome(path):
    """Add the recorded spans to the Chrome trace at `path` (as a profiler's
    `export_chrome_trace` wrote it) as the process track "program", a row
    per thread, on the trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get('baseTimeNanoseconds', 0))
    rows = {}
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 'program',
               'args': {'name': 'program'}}]
    for s in spans():
        if s['end_ns'] is None:
            continue
        tid = rows.setdefault(s['thread'], len(rows))
        args = dict(s['attrs'])
        if s['device_ms'] is not None:
            args['device_ms'] = s['device_ms']
        events.append({'ph': 'X', 'cat': 'program', 'name': s['name'], 'pid': 'program',
                       'tid': tid, 'ts': (s['start_ns'] - base) / 1e3,
                       'dur': (s['end_ns'] - s['start_ns']) / 1e3, 'args': args})
    doc['traceEvents'] = doc.get('traceEvents', []) + events
    with open(path, 'w') as f:
        json.dump(doc, f)
