"""The program's spans against a synthetic profiler trace (harness/spans.py):
placement checked by anchors, device idle split by the part of the loop the
main thread was in (the parts summing to the idle share), and None where
the spans do not sit on the trace."""

import pytest

from conftest import tiny_cell
from harness import spans as hspans
from harness import spec
from harness.context import Context, Outcome
from harness.trace import Trace

BASE = 1_700_000_000_000_000_000  # ns since the epoch
MAIN, OTHER = 1, 2


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


# device busy 10-30 (the copy), 40-60, 100-120: 60 us of a 110 us span
EVENTS = [
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 10, 20),
    _x('gemm', 'kernel', 40, 20),
    _x('gemm', 'kernel', 100, 20),
    _x('cudaMemcpyAsync', 'cuda_runtime', 12, 8),
    _x('cudaLaunchKernel', 'cuda_runtime', 30, 2),
    _x('cudaEventSynchronize', 'cuda_runtime', 70, 10),
]


def _span(name, ts, te, parent=None, thread=MAIN, device_ms=None, shift=0.0):
    return {'name': name, 'start_ns': BASE + int((ts + shift) * 1e3),
            'end_ns': BASE + int((te + shift) * 1e3), 'parent': parent, 'thread': thread,
            'attrs': {}, 'device_ms': device_ms}


def _spans(shift=0.0):
    return [
        _span('eval.h2d', 5, 25, shift=shift),  # 0
        _span('eval.forward', 25, 65, shift=shift),  # 1
        _span('vit.encoder', 26, 60, parent=1, device_ms=30.0, shift=shift),  # 2
        _span('eval.wait', 65, 85, shift=shift),  # 3
        _span('eval.decode', 85, 95, shift=shift),  # 4
        _span('eval.next', 98, 105, shift=shift),  # 5; 95-98 in no span
        _span('elsewhere', 0, 200, thread=OTHER, shift=shift),  # not the main thread
    ]


def test_idle_parts_sum_to_the_idle_share():
    p = hspans.Placed(Trace(EVENTS, iters=1), _spans(), BASE, MAIN)
    assert (p.anchors, p.contained) == (2, 1.0) and p.ok
    # call start - span start, span end - call end
    assert p.offsets == {'eval.h2d': [(7.0, 5.0)], 'eval.wait': [(5.0, 5.0)]}
    parts = p.idle_parts('read')
    # idle: 30-40 beneath eval.forward, 60-65 in it, 65-95 awaiting and
    # decoding, 95-98 in no span, 98-100 fetching the next batch
    want = {'input': 2, 'forward': 15, 'post': 30, 'other': 3}
    assert parts == {k: pytest.approx(100 * v / 110) for k, v in want.items()}
    assert sum(parts.values()) == pytest.approx(100 * (1 - 60 / 110))
    assert p.host_ms('eval.wait') == [pytest.approx(0.02)]
    assert p.device_ms('vit.encoder') == [30.0]


def _run(monkeypatch, recorded):
    from parseq_tpu_torch.utils import trace as program_trace

    monkeypatch.setattr(program_trace, 'spans', lambda: recorded)
    monkeypatch.setattr(hspans, 'chrome_base_ns', lambda out_dir=None: BASE)
    monkeypatch.setattr(hspans.threading, 'main_thread',
                        lambda: type('T', (), {'ident': MAIN})())
    ctx = Context(cell=tiny_cell('parseq-s.read-b512'), seed=0, seconds=1, trace=True,
                  device='cpu')
    out = Outcome(attempted=1, failed=0, metrics={}, readings={}, layer={'batch': 4},
                  trace=Trace(EVENTS, iters=1))
    return {name: spec.reader(name).read(out, ctx) for name in
            ('h2d_block_ms', 'sync_wait_ms', 'idle_input_pct.read', 'idle_forward_pct.read',
             'idle_post_pct.read', 'idle_other_pct.read', 'device_idle_pct.read')}


def test_readers_read_placed_spans(monkeypatch):
    got = _run(monkeypatch, _spans())
    assert got['h2d_block_ms'] == pytest.approx(0.02)  # one batch, 20 us
    assert got['sync_wait_ms'] == pytest.approx(0.02)
    parts = [got[f'idle_{p}_pct.read'] for p in ('input', 'forward', 'post', 'other')]
    assert sum(parts) == pytest.approx(got['device_idle_pct.read'])


def test_a_call_a_few_microseconds_past_its_span_still_counts_as_inside():
    late = [dict(s, end_ns=s['end_ns'] - 8000) if s['name'] == 'eval.wait' else s
            for s in _spans()]  # the wait's call now ends 3 us after the span
    p = hspans.Placed(Trace(EVENTS, iters=1), late, BASE, MAIN)
    assert p.contained == 1.0 and p.offsets['eval.wait'] == [(5.0, -3.0)]


@pytest.mark.parametrize('shift', [-30.0, 500.0])
def test_misplaced_spans_read_nothing(monkeypatch, shift):
    got = _run(monkeypatch, _spans(shift))
    assert got.pop('device_idle_pct.read') is not None  # the trace alone still reads
    assert got == dict.fromkeys(got)


def test_no_spans_read_nothing(monkeypatch):
    got = _run(monkeypatch, [])
    got.pop('device_idle_pct.read')
    assert got == dict.fromkeys(got)
