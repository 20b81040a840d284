"""The yardstick's arithmetic: the FLOP formulas against FlopCounterMode on
the reference, and the kernels' bounds against the readings of the
repository's chip smoke test at its shapes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_cell
from harness import spec, weights
from reference.tokenizer import Ids


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _model(cell):
    m = cell.config['model']
    ref, ids = spec.reference(cell), Ids(m['charset_train'])
    return m, ref, ids, weights.draw(ref.param_shapes(m, ids), 0, 'cpu', ref.init_kind)


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('name', ['parseq-s.read-b512', 'vitstr-s.read-b512'])
def test_read_flops(name, B):
    cell = tiny_cell(name)
    m, ref, ids, sd = _model(cell)
    x = torch.zeros(B, *m['img_size'], 3)
    picks = torch.ones(B, m['max_label_length'] + 1, dtype=torch.long) if ref.AR else None
    got = _count(lambda: ref.read(sd, m, ids, x, picks))
    assert got == B * spec.flops(cell.config['read_flops'])(m, ids)


def test_train_flops():
    """The reference decodes each permutation from the memory, so it
    projects the memory's keys and values K times where the formula (and the
    program) does it once."""
    cell = tiny_cell('parseq-s.train-b384')
    m, ref, ids, sd = _model(cell)
    sd = {k: v.requires_grad_() for k, v in sd.items()}
    B = 2
    extras = ref.train_extras(m, np.random.default_rng(0), B, torch.Generator().manual_seed(0))
    tgt = torch.as_tensor(ids.encode(['ab', 'cde'], m['max_label_length']))
    x = torch.zeros(B, *m['img_size'], 3)

    def step():
        loss = ref.train_loss(sd, m, ids, x, tgt, (extras[0], None))
        torch.autograd.grad(loss, list(sd.values()))

    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    T, D = (H // ph) * (W // pw), m['embed_dim']
    extra = 2 * 3 * (len(extras[0]) - 1) * T * D * 2 * D
    assert _count(step) == B * (spec.flops(cell.config['train_flops'])(m, ids) + extra)


@pytest.mark.parametrize('kernel,shape,ms,binds', [
    ('b1', (256, 128, 384, 12, 26, 95, 1536, 97), 0.0674, 'operations'),
    ('b2', (256, 197, 6, 384), 0.0462, 'bytes'),
    ('b4', (384, 6, 128, 64), 0.0789, 'bytes')])
def test_bounds_match_the_smoke_readings(kernel, shape, ms, binds):
    """chip_smoke.py's bounds at its shapes (PERF.md's kernel table)."""
    assert spec.kernel(kernel).bound_ms(*shape) == (pytest.approx(ms, abs=5e-5), binds)
