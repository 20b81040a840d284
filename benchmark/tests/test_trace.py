"""The trace reduction and the per-layer readers on a synthetic profiler
trace: the union of device intervals, kernels by name, idle gaps named by
the CUDA call under way, and the shares the readers make of them."""

import pytest

from conftest import tiny_cell
from harness import spec
from harness.context import Context, Outcome
from harness.trace import NO_CALL, Trace


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


EVENTS = [
    _x('void (anonymous namespace)::ar_decode_kernel<4>(P)', 'kernel', 10, 30),
    _x('void (anonymous namespace)::ar_decode_kernel<4>(P)', 'kernel', 110, 30),
    _x('gemm', 'kernel', 30, 20),  # overlaps the first: counted once
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 150, 10),
    _x('cudaMemcpyAsync', 'cuda_runtime', 65, 20),
    _x('late', 'kernel', 200, 10),
]


def test_trace_reduction():
    t = Trace(EVENTS, iters=2)
    assert t.window_s == pytest.approx(200e-6)  # 10 to 210
    assert t.busy_s == pytest.approx((40 + 30 + 10 + 10) * 1e-6)
    assert t.kernels(r'\bar_decode_kernel\b')[0][1:] == (2, pytest.approx(60e-6))
    gaps = t.idle_gaps()
    assert gaps[0] == ('cudaMemcpyAsync', pytest.approx(60e-6))  # 50-110: at 80 the runtime call
    assert gaps[1] == (NO_CALL, pytest.approx(40e-6))  # 160-200
    assert len(t.breakdown()['device_ops']) == 4
    with pytest.raises(ValueError):
        Trace([_x('cudaMemcpyAsync', 'cuda_runtime', 65, 20)], iters=1)


def test_readers_on_a_trace():
    cell = tiny_cell('parseq-s.read-b512')
    ctx = Context(cell=cell, seed=0, seconds=1, trace=True, device='cpu')
    out = Outcome(attempted=8, failed=0, metrics={}, readings={}, layer={'batch': 4},
                  trace=Trace(EVENTS, iters=2))
    # busy 90 us of the span's 200
    assert spec.reader('device_idle_pct.read').read(out, ctx) == pytest.approx(55.0)
    assert spec.reader('b1_roofline').read(out, ctx) > 0
    assert spec.reader('b2_roofline').read(out, ctx) is None  # nothing to read
    assert spec.reader('launches_per_step').read(out, ctx) == pytest.approx(2.0)
    assert spec.reader('read_mfu_pct').read(out, ctx) > 0
    out.trace = None
    for name in ('device_idle_pct.read', 'read_mfu_pct', 'b1_roofline'):
        assert spec.reader(name).read(out, ctx) is None
