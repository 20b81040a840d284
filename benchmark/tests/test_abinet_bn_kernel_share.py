"""abinet_bn_kernel_share (metrics/abinet_bn_kernel_share.py) on a synthetic
trace: the share of placed abinet.backbone spans whose attribute
`bn_kernel` (the kernel's launches counted in the span) is above 0; None where no such span carries it (a program from
before the kernel) and where nothing is placed."""

import pytest

from conftest import tiny_cell
from harness import spans as hspans
from harness import spec
from harness.context import Context, Outcome
from harness.trace import Trace

BASE = 1_700_000_000_000_000_000  # ns since the epoch
MAIN = 1


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


# two read batches: each its input copy, its forward's kernel, its wait
EVENTS = [
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 10, 10),
    _x('conv', 'kernel', 30, 20),
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 110, 10),
    _x('conv', 'kernel', 130, 20),
    _x('cudaMemcpyAsync', 'cuda_runtime', 12, 5),
    _x('cudaEventSynchronize', 'cuda_runtime', 70, 10),
    _x('cudaMemcpyAsync', 'cuda_runtime', 112, 5),
    _x('cudaEventSynchronize', 'cuda_runtime', 170, 10),
]


def _span(name, ts, te, parent=None, shift=0.0, **attrs):
    return {'name': name, 'start_ns': BASE + int((ts + shift) * 1e3),
            'end_ns': BASE + int((te + shift) * 1e3), 'parent': parent, 'thread': MAIN,
            'attrs': attrs, 'device_ms': None}


def _spans(first, second, shift=0.0):
    """The backbones' attributes: a dict each, {} where it carries none."""
    return [
        _span('eval.h2d', 5, 25, shift=shift),  # 0
        _span('eval.forward', 25, 65, shift=shift),  # 1
        _span('abinet.backbone', 28, 55, parent=1, shift=shift, rows=4, **first),  # 2
        _span('eval.wait', 65, 85, shift=shift),  # 3
        _span('eval.h2d', 105, 125, shift=shift),  # 4
        _span('eval.forward', 125, 165, shift=shift),  # 5
        _span('abinet.backbone', 128, 155, parent=5, shift=shift, rows=4, **second),  # 6
        _span('eval.wait', 165, 185, shift=shift),  # 7
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
    return spec.reader('abinet_bn_kernel_share').read(out, ctx)


@pytest.mark.parametrize('first, second, share', [
    ({'bn_kernel': 45}, {'bn_kernel': 45}, 1.0),
    ({'bn_kernel': 45}, {'bn_kernel': 0}, 0.5),
    ({'bn_kernel': 0}, {'bn_kernel': 0}, 0.0),
    ({'bn_kernel': 45}, {}, 1.0),  # a span without the attribute does not count
], ids=['all', 'half', 'none', 'one-carries-it'])
def test_the_share_of_backbones_that_ran_the_kernel(monkeypatch, first, second, share):
    assert _read(monkeypatch, _spans(first, second)) == pytest.approx(share)


@pytest.mark.parametrize('case', ['no attribute', 'no spans', 'misplaced', 'no trace'])
def test_nothing_is_read_without_the_attribute_or_placed_spans(monkeypatch, case):
    recorded = {'no attribute': _spans({}, {}), 'no spans': [],
                'misplaced': _spans({'bn_kernel': 45}, {'bn_kernel': 45}, 500.0),
                'no trace': _spans({'bn_kernel': 45}, {'bn_kernel': 45})}[case]
    assert _read(monkeypatch, recorded, trace=case != 'no trace') is None
