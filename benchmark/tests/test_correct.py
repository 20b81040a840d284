"""`correct` of a whole run, driven on the CPU at tiny widths with the look
for a card skipped: true for the program as it is, false with each fault
that the cell can have planted under the timed path (harness/faults.py),
and false for the control (the reference with float8 products in the
program's place), judged by the same comparison and limits."""

import pytest

from conftest import SHALLOW, run_cpu, tiny_cell
from harness import control, faults, report
from harness.context import Context

READS = ['parseq-s.read-b512', 'vitstr-s.read-b512']
TRAIN = 'parseq-s.train-b384'
# the faults each cell can have (one chip: no exchange between chips to leave out)
CASES = [(c, f) for c in READS for f in ('read_half_batch', 'read_token')] + [
    (TRAIN, 'train_half_batch'), (TRAIN, 'train_unchanged')]


def _correct(outcome, cell):
    return report.judge(outcome.readings, cell.checks['limits'])[1]


@pytest.mark.parametrize('name', READS + [TRAIN])
def test_sound_run_is_correct(name):
    cell = tiny_cell(name)
    outcome, _ = run_cpu(cell, seed=2 ** 33 + 11, seconds=0.3)
    assert outcome.attempted > 0 and outcome.failed == 0
    assert _correct(outcome, cell), outcome.readings


@pytest.mark.parametrize('name,fault', CASES)
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault](cell):
        outcome, _ = run_cpu(cell, seed=5, seconds=0.3)
    assert not _correct(outcome, cell), outcome.readings


@pytest.mark.parametrize('name', READS + [TRAIN])
def test_control_is_not_correct(name):
    cell = tiny_cell(name, SHALLOW)
    if name == TRAIN:
        got = control.fp8_training(Context(cell=cell, seed=9, seconds=0.3, trace=False,
                                           device='cpu'))[0]
    else:
        _, ctx = run_cpu(cell, seed=9, seconds=0.3)
        got = control.fp8_reading(ctx)
    assert not report.judge(got, cell.checks['limits'])[1], got


def test_an_ar_pass_not_seen_is_named(monkeypatch):
    """Where the read driver's wrappers no longer see the AR pass (an entry
    renamed or inlined), the run stops and names the entries it wraps."""
    from harness import spec

    real = spec.adapter

    def unwrapped(cell):
        a = real(cell)
        a.wrap_ar = lambda bundle, on_logits: []
        return a

    monkeypatch.setattr(spec, 'adapter', unwrapped)
    with pytest.raises(RuntimeError, match='ar_decode_fused'):
        run_cpu(tiny_cell('parseq-s.read-b512'), seed=3, seconds=0.3)
