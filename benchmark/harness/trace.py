"""The device trace of a run: torch.profiler, recording the card's activity
alone (kernels, copies, memsets, and the CUDA runtime calls that issued
them; no host operator events, whose cost on the host would stretch every
iteration that the host paces), over a fixed span of the window's
iterations, read back from the profiler's Chrome trace. The device is
drained before the span opens and before it closes, so the span holds the
device work of exactly its iterations.

From it: the span's length (the first device operation's start to the last
one's end), the time in which any kernel, copy or memset ran (the union of
their intervals), each kernel's count and summed time by name, and the idle
gaps between device intervals, each named by the CUDA runtime call under
way at its middle."""

from __future__ import annotations

import json
import re
from bisect import bisect_right

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cuda_runtime', 'cuda_driver')
NO_CALL = 'host (no CUDA call under way)'


def _profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


class Tracer:
    """Profiles iterations [start, start + count) of a window: `tick(i)` at the
    start of each iteration i, `finish()` once the window has closed."""

    def __init__(self, enabled, start, count):
        self.enabled, self.start, self.count = enabled, start, count
        self.prof = None
        self.done = False
        self.iters = 0

    def warm(self):
        """Start and stop the profiler once around a small device operation,
        so that its first start (CUPTI's set-up, seconds) falls before the
        window."""
        if not self.enabled:
            return
        import torch

        with _profiler():
            torch.ones(8, device='cuda').sum().item()
        torch.cuda.synchronize()

    def _stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        self.done = True

    def tick(self, i):
        if not self.enabled or self.done:
            return
        import torch

        if i == self.start:
            torch.cuda.synchronize()
            self.prof = _profiler()
            self.prof.start()
        if self.prof is None:
            return
        if i >= self.start + self.count:
            self._stop()
            return
        self.iters += 1

    def finish(self):
        if self.enabled and self.prof is not None and not self.done:
            self._stop()

    def read(self, path):
        """Export the trace to `path`, parse it, delete it; a Trace or None."""
        if self.prof is None:
            return None
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            path.unlink(missing_ok=True)
        return Trace(events, self.iters)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, events, iters):
        self.iters = iters
        xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        self.device = [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'], e['cat'])
                       for e in xs if e.get('cat') in DEVICE_CATS]
        if not self.device:
            raise ValueError('trace: no device operation in the traced span')
        self.t0 = min(s for s, _, _, _ in self.device)
        self.t1 = max(e for _, e, _, _ in self.device)
        self.host = sorted((float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
                           for e in xs if e.get('cat') in HOST_CATS)

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _union([(s, e) for s, e, _, _ in self.device])

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self, pattern=None):
        """[(name, count, seconds)] of kernels (all, or those whose name
        matches the regular expression), most time first."""
        rx = re.compile(pattern) if pattern else None
        acc = {}
        for s, e, name, cat in self.device:
            if cat != 'kernel' or (rx and not rx.search(name)):
                continue
            n, t = acc.get(name, (0, 0.0))
            acc[name] = (n + 1, t + (e - s) * 1e-6)
        return sorted(((k, n, t) for k, (n, t) in acc.items()), key=lambda r: -r[2])

    def device_ops(self):
        """[(name, seconds)] of every device operation (kernels, copies,
        memsets), most time first."""
        acc = {}
        for s, e, name, _ in self.device:
            acc[name] = acc.get(name, 0.0) + (e - s) * 1e-6
        return sorted(acc.items(), key=lambda r: -r[1])

    def _host_at(self, t):
        """The CUDA runtime call under way at time t (the one that started
        last among those still running), or NO_CALL."""
        i = bisect_right(self.host, (t, float('inf'), ''))
        best = None
        for s, e, name in reversed(self.host[max(0, i - 4000):i]):
            if e >= t and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else NO_CALL

    def idle_gaps(self):
        """[(host call, seconds)] of every idle gap in the span, longest first."""
        busy = self.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self._host_at((s + e) / 2), (e - s) * 1e-6) for s, e in gaps]

    def breakdown(self, n=10):
        return {'device_ops': [[k[:200], t] for k, t in self.device_ops()[:n]],
                'idle_gaps': [[k[:200], t] for k, t in self.idle_gaps()[:n]]}
