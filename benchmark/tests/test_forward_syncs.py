"""forward_syncs (metrics/forward_syncs.py) on a synthetic trace: the host's
blocking CUDA calls that start inside eval.forward on the main thread, a
read batch; calls outside it (the batch's own wait, the decode, another
thread's span) do not count, and nothing is read without placed spans."""

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


EVENTS = [
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 10, 20),
    _x('gemm', 'kernel', 40, 20),
    _x('gemm', 'kernel', 125, 30),
    # batch 0: the input copy, two syncs in the forward (one beneath a
    # nested span), the batch's wait, a sync while decoding
    _x('cudaMemcpyAsync', 'cuda_runtime', 12, 8),
    _x('cudaStreamSynchronize', 'cuda_runtime', 30, 4),
    _x('cudaLaunchKernel', 'cuda_runtime', 36, 2),
    _x('cudaStreamSynchronize', 'cuda_runtime', 50, 5),
    _x('cudaEventSynchronize', 'cuda_runtime', 70, 10),
    _x('cudaStreamSynchronize', 'cuda_runtime', 90, 2),
    # batch 1: the input copy, a stream and a device sync in the forward
    # beside a call of another name, the batch's wait
    _x('cudaMemcpyAsync', 'cuda_runtime', 105, 5),
    _x('cudaStreamSynchronize', 'cuda_runtime', 130, 3),
    _x('cuCtxSynchronize', 'cuda_driver', 135, 1),  # not one of the three names
    _x('cudaDeviceSynchronize', 'cuda_runtime', 140, 6),
    _x('cudaEventSynchronize', 'cuda_runtime', 165, 10),
]


def _span(name, ts, te, parent=None, thread=MAIN, shift=0.0):
    return {'name': name, 'start_ns': BASE + int((ts + shift) * 1e3),
            'end_ns': BASE + int((te + shift) * 1e3), 'parent': parent, 'thread': thread,
            'attrs': {}, 'device_ms': None}


def _spans(shift=0.0):
    return [
        _span('eval.h2d', 5, 25, shift=shift),  # 0
        _span('eval.forward', 25, 65, shift=shift),  # 1
        _span('parseq.refine', 45, 60, parent=1, shift=shift),  # 2
        _span('eval.wait', 65, 85, shift=shift),  # 3
        _span('eval.decode', 85, 95, shift=shift),  # 4
        _span('eval.h2d', 100, 120, shift=shift),  # 5
        _span('eval.forward', 120, 160, shift=shift),  # 6
        _span('eval.wait', 160, 180, shift=shift),  # 7
        _span('eval.forward', 0, 200, thread=OTHER, shift=shift),  # not the main thread
    ]


def _read(monkeypatch, recorded, trace=True):
    from parseq_tpu_torch.utils import trace as program_trace

    monkeypatch.setattr(program_trace, 'spans', lambda: recorded)
    monkeypatch.setattr(hspans, 'chrome_base_ns', lambda out_dir=None: BASE)
    monkeypatch.setattr(hspans.threading, 'main_thread',
                        lambda: type('T', (), {'ident': MAIN})())
    ctx = Context(cell=tiny_cell('parseq-s.read-b512'), seed=0, seconds=1, trace=True,
                  device='cpu')
    out = Outcome(attempted=1, failed=0, metrics={}, readings={}, layer={'batch': 4},
                  trace=Trace(EVENTS, iters=2) if trace else None)
    return spec.reader('forward_syncs').read(out, ctx)


def test_counts_the_syncs_inside_the_forward_a_batch(monkeypatch):
    # 2 in batch 0's forward, 2 in batch 1's; 2 read batches
    assert _read(monkeypatch, _spans()) == pytest.approx(2.0)


def test_a_forward_without_syncs_reads_zero(monkeypatch):
    quiet = [s for s in _spans()
             if s['thread'] != MAIN or s['name'] not in ('eval.forward', 'parseq.refine')]
    assert _read(monkeypatch, quiet) == 0.0


@pytest.mark.parametrize('case', ['no spans', 'misplaced', 'no trace'])
def test_nothing_is_read_without_placed_spans(monkeypatch, case):
    recorded = {'no spans': [], 'misplaced': _spans(500.0), 'no trace': _spans()}[case]
    assert _read(monkeypatch, recorded, trace=case != 'no trace') is None
