"""The program's spans (`parseq_tpu_torch/utils/trace.py`) read against the
profiler trace of the traced span (harness/trace.py).

The program records its spans while a torch profiler runs, so a traced run
holds the spans of exactly the traced iterations. Here they are:

- placed on the trace's timeline: the spans' epoch stamps less the
  profiler's Chrome-trace time base, which a second, empty CPU profile of
  the same process exports. The placement is checked against anchors: each
  `eval.wait` must contain a `cudaEventSynchronize` of the trace, each
  `eval.h2d` a `cudaMemcpyAsync`, each `train.optimizer` a kernel launch,
  to within SLACK_US. Below 99% of anchors contained, nothing here is
  read: every span-reading metric is None;
- used to attribute each instant of device idle in the span (the gaps
  between the trace's busy intervals) to the innermost span open on the
  main thread at that instant, and so to a part of the loop (PARTS);
- summed by name: host ms and device ms (the span's CUDA events) an
  iteration.

A program without the recorder (a checkout from before it) gives None
everywhere. The placement and the idle split of a run are also written to
bench_out/<cell>/seed<n>-spans.json.
"""

from __future__ import annotations

import itertools
import json
import statistics
import tempfile
import threading
from bisect import bisect_left
from pathlib import Path

ANCHORS = {'eval.wait': ('cudaEventSynchronize',), 'eval.h2d': ('cudaMemcpyAsync',),
           'train.optimizer': ('cudaLaunchKernel', 'cuLaunchKernel')}
MIN_CONTAINED = 0.99
# how far a call may lie outside the span around it: the two clocks agree to
# within a few microseconds (a cudaEventSynchronize's CUPTI end stamp lay up
# to 4.5 us past the end of the span that encloses it in Python, H100, torch
# 2.11); a misplacement shows as tens of microseconds or more
SLACK_US = 10.0
# a domain's parts of the loop: the spans each is made of (and what lies
# beneath them); idle while the main thread is in none of them is 'other'
PARTS = {
    'read': {'input': ('eval.next', 'eval.h2d'), 'forward': ('eval.forward',),
             'post': ('eval.wait', 'eval.decode', 'eval.score')},
    'train': {'prepare': ('train.prepare',), 'step': ('train.step',)},
}
# the span that counts a domain's iterations
ITERATION = {'read': 'eval.h2d', 'train': 'train.step'}


def chrome_base_ns(out_dir=None):
    """The time base (ns since the epoch) of this process's profiler Chrome
    traces: exported by an empty CPU profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(1)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        path = Path(d) / 'base.json'
        prof.export_chrome_trace(str(path))
        return int(json.loads(path.read_text())['baseTimeNanoseconds'])


class Placed:
    """Spans on a trace's timeline (microseconds, as the trace's events)."""

    def __init__(self, trace, recorded, base_ns, main_thread):
        self.trace = trace
        closed = [i for i, s in enumerate(recorded) if s['end_ns'] is not None]
        index = {i: j for j, i in enumerate(closed)}  # parents, as indices of self.spans
        self.spans = [dict(recorded[i], parent=index.get(recorded[i]['parent']),
                           ts=(recorded[i]['start_ns'] - base_ns) / 1e3,
                           te=(recorded[i]['end_ns'] - base_ns) / 1e3) for i in closed]
        self.main = [i for i, s in enumerate(self.spans) if s['thread'] == main_thread]
        self.contained, self.anchors, self.offsets = self._anchor()

    def _anchor(self):
        """(share of anchor spans that contain their call, their count, and
        per anchor name the (lead, tail) in us of the nearest such call:
        call start - span start, span end - call end; both >= 0 inside)."""
        calls = {}
        for hs, he, name in self.trace.host:
            for anchor, names in ANCHORS.items():
                if name.startswith(names):
                    calls.setdefault(anchor, []).append((hs, he))
        n = hit = 0
        offsets = {}
        for s in self.spans:
            if s['name'] not in ANCHORS:
                continue
            n += 1
            found = calls.get(s['name'], [])
            if not found:
                continue
            i = bisect_left(found, (s['ts'] - SLACK_US,))
            near = [found[j] for j in (i - 1, i) if 0 <= j < len(found)]
            starting = itertools.takewhile(lambda c: c[0] <= s['te'], found[i:])
            inside = next((c for c in starting if c[1] <= s['te'] + SLACK_US), None)
            hs, he = inside or min(near, key=lambda c: abs(c[0] - s['ts']))
            hit += inside is not None
            offsets.setdefault(s['name'], []).append((hs - s['ts'], s['te'] - he))
        return (hit / n if n else 0.0), n, offsets

    @property
    def ok(self):
        return self.anchors > 0 and self.contained >= MIN_CONTAINED

    def count(self, name):
        return sum(1 for s in self.spans if s['name'] == name)

    def host_ms(self, name):
        """[host ms] of the spans of that name."""
        return [(s['te'] - s['ts']) * 1e-3 for s in self.spans if s['name'] == name]

    def device_ms(self, name):
        return [s['device_ms'] for s in self.spans
                if s['name'] == name and s['device_ms'] is not None]

    def _segments(self):
        """[(start, end, span index or None)]: the span's timeline cut where
        the innermost span open on the main thread changes."""
        out, stack, cursor = [], [], float('-inf')
        for i in sorted(self.main, key=lambda k: (self.spans[k]['ts'], -self.spans[k]['te'])):
            s = self.spans[i]
            while stack and self.spans[stack[-1]]['te'] <= s['ts']:
                end = self.spans[stack[-1]]['te']
                out.append((cursor, end, stack.pop()))
                cursor = end
            out.append((cursor, s['ts'], stack[-1] if stack else None))
            stack.append(i)
            cursor = s['ts']
        while stack:
            end = self.spans[stack[-1]]['te']
            out.append((cursor, end, stack.pop()))
            cursor = end
        out.append((cursor, float('inf'), None))
        return [(a, b, k) for a, b, k in out if b > a]

    def _part(self, k, parts):
        while k is not None:
            for part, names in parts.items():
                if self.spans[k]['name'] in names:
                    return part
            k = self.spans[k]['parent']
        return 'other'

    def _idle(self):
        """[(us, segment)]: the device idle in each segment of the timeline."""
        busy = self.trace.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        segs = self._segments()
        out, j = [], 0
        for gs, ge in gaps:
            while segs[j][1] <= gs:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < ge:
                a, b, _ = segs[k]
                out.append((min(b, ge) - max(a, gs), segs[k]))
                k += 1
        return out

    def idle_parts(self, domain):
        """{part: % of the span} of device idle, by the part of the loop the
        main thread was in; the parts sum to the span's idle share."""
        parts = PARTS[domain]
        out = dict.fromkeys([*parts, 'other'], 0.0)
        for us, (_, _, span) in self._idle():
            out[self._part(span, parts)] += us
        window = self.trace.t1 - self.trace.t0
        return {p: 100.0 * t / window for p, t in out.items()}

    def idle_outside_spans(self):
        """{name: us} of device idle while the main thread was in no span,
        by the span that had closed just before."""
        ended = {self.spans[i]['te']: self.spans[i]['name'] for i in self.main}
        out = {}
        for us, (a, _, span) in self._idle():
            if span is None:
                name = ended.get(a, '(before the first span)')
                out[name] = out.get(name, 0.0) + us
        return out

    def summary(self, layer):
        """What a run's spans-json holds; beside the spans' medians, those of
        the harness's own per-batch readings (`layer`) that measure the same
        work from outside."""
        names = sorted({s['name'] for s in self.spans})
        median = {n: statistics.median(v) for n, v in
                  [('eval.decode host', self.host_ms('eval.decode')),
                   ('vit.encoder device', self.device_ms('vit.encoder')),
                   *[(k, layer.get(k)) for k in ('host_decode_ms', 'encoder_ms')]] if v}
        return {'anchors': self.anchors, 'contained': self.contained,
                'anchor_offsets_us': {
                    a: {'n': len(o), 'lead_median': statistics.median(x for x, _ in o),
                        'tail_median': statistics.median(y for _, y in o),
                        'lead_min': min(x for x, _ in o), 'tail_min': min(y for _, y in o)}
                    for a, o in self.offsets.items()},
                'spans': {n: {'count': self.count(n), 'host_ms': sum(self.host_ms(n)),
                              'device_ms': sum(self.device_ms(n)) or None} for n in names},
                'idle_parts': {d: self.idle_parts(d) for d in PARTS
                               if any(s['name'] == ITERATION[d] for s in self.spans)},
                'idle_outside_spans_us': self.idle_outside_spans(),
                'medians_ms': median}


def placed(outcome, ctx):
    """The run's spans placed on its trace, or None (no trace, no spans, a
    program without the recorder, or fewer anchors contained than
    MIN_CONTAINED). Computed once a run."""
    if 'spans' in ctx.keep:
        return ctx.keep['spans']
    ctx.keep['spans'] = None
    if outcome.trace is None:
        return None
    try:
        from parseq_tpu_torch.utils import trace as program_trace
    except ImportError:
        return None
    recorded = program_trace.spans()
    if not recorded:
        return None
    p = Placed(outcome.trace, recorded, chrome_base_ns(ctx.out_dir),
               threading.main_thread().ident)
    if ctx.out_dir is not None:
        (Path(ctx.out_dir) / f'seed{ctx.seed}-spans.json').write_text(
            json.dumps(p.summary(outcome.layer), indent=1))
    if p.ok:
        ctx.keep['spans'] = p
    return ctx.keep['spans']


def per_iteration(outcome, ctx, domain, name, kind='host'):
    """Host (or device) ms in the spans of that name, an iteration of the
    domain (a read batch, a train step)."""
    p = placed(outcome, ctx)
    if p is None:
        return None
    n = p.count(ITERATION[domain])
    values = p.host_ms(name) if kind == 'host' else p.device_ms(name)
    if not n or not values:
        return None
    return sum(values) / n


def idle_part(outcome, ctx, domain, part):
    p = placed(outcome, ctx)
    if p is None or not p.count(ITERATION[domain]):
        return None
    return p.idle_parts(domain)[part]
