"""ABINet's plain reference (reference/abinet.py) against the port on the CPU,
and the cell abinet.read-b512 driven there: the port's float32 logits
against the reference's; the lengths the program's language passes took,
handed over as AR picks by the adapter, with weights biased so that they
are short (the padding mask and the clamp at work) and the reference
teacher-forced on them; a whole run that is correct, and not correct under
the faults and the control; the FLOP formula against FlopCounterMode; the
weight draw's dependence on the image.

d_model stays 512 (ResNet45's width) and the crops 32 x 64, the least the
position attention's U-Net takes (its keys are halved four times in width,
three in height); the rest is cut."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import run_cpu, tiny_cell
from harness import control, faults, report, spec, weights
from reference import abinet as rabinet
from reference.ops import Ops, normalize_u8
from reference.tokenizer import Ids

CELL = 'abinet.read-b512'
SIZES = {'abinet': {'img_size': [32, 64], 'nhead': 4, 'd_inner': 128, 'v_num_layers': 1,
                    'l_num_layers': 2, 'max_label_length': 7}}
QUANTILE, ALIGN_EOS = 0.25, 0.8
TOL = 1e-4  # float32 on both sides; only the order of sums differs


def _setup(seed):
    cell = tiny_cell(CELL, sizes=SIZES)
    m = cell.config['model']
    ids = Ids(m['charset_train'])
    return cell, m, ids, weights.draw(rabinet.param_shapes(m, ids), seed, 'cpu',
                                      rabinet.init_kind)


def _bundle(cell, sd):
    from parseq_tpu_torch.utils import registry

    return registry._bundle('abinet', dict(cell.config['model']), dtype=torch.float32,
                            device='cpu', state_dict=sd)


def _images(m, n, seed):
    g = torch.Generator().manual_seed(seed)
    return normalize_u8(torch.randint(0, 256, (n, *m['img_size'], 3), generator=g,
                                      dtype=torch.uint8))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _picks(cell, bundle, x):
    """The adapter's picks of one forward, and the forward's results."""
    got = []
    undo = spec.adapter(cell).wrap_ar(bundle, lambda onehot: got.append(onehot.argmax(-1)))
    try:
        with torch.no_grad():
            res = bundle.module.forward_iterations(x)
    finally:
        for u in undo:
            u()
    assert len(got) == 1 and 'forward_iterations' not in vars(bundle.module)
    return got[0], res


@pytest.mark.parametrize('seed', [0, 1])
def test_logits_match_the_reference(seed):
    cell, m, ids, sd = _setup(seed)
    bundle = _bundle(cell, sd)
    x = _images(m, 3, seed)
    picks, (all_a, _, v) = _picks(cell, bundle, x)
    with torch.no_grad():
        rows, fin = rabinet.read(sd, m, ids, x, picks)
        _, v_ref = rabinet.vision(Ops(), sd, m, x)
    assert _rel(v['logits'], v_ref) < TOL
    assert _rel(all_a[-1]['logits'], fin) < TOL
    assert torch.equal(rows.argmax(-1), picks)  # the reference takes the program's lengths


def _short(sd, m, ids):
    """The weights with the EOS biases raised, so that the lengths of every
    derivation are short and some are 1."""
    sd = dict(sd)
    with torch.no_grad():
        _, v = rabinet.vision(Ops(), sd, m, _images(m, 16, 5))
    for k, eos in (('vision.cls.bias', torch.quantile(v[..., 1:].max(-1).values - v[..., 0],
                                                       QUANTILE)),
                   ('alignment.cls.bias', ALIGN_EOS)):
        sd[k] = sd[k].clone()
        sd[k][0] = eos
    return sd


def test_short_lengths_are_packed_clamped_and_teacher_forced():
    cell, m, ids, sd = _setup(0)
    sd = _short(sd, m, ids)
    bundle = _bundle(cell, sd)
    x = _images(m, 16, 0)
    picks, (all_a, all_l, v) = _picks(cell, bundle, x)
    T, n = m['max_label_length'] + 1, m['iter_size']
    derived = torch.stack([v['pt_lengths']] + [a['pt_lengths'] for a in all_a[:n - 1]], 1)
    assert torch.equal(picks[:, :n], derived) and not picks[:, n:].any()
    assert (picks[:, :n] == 1).any()  # the clamp to 2 is taken
    assert ((picks[:, :n] > 1) & (picks[:, :n] < T)).sum() > n * len(x) // 2  # padding
    with torch.no_grad():
        rows, fin = rabinet.read(sd, m, ids, x, picks)
        # teacher-forced on other lengths, the reference reads otherwise
        _, other = rabinet.read(sd, m, ids, x, torch.full_like(picks, T))
    assert _rel(all_a[-1]['logits'], fin) < TOL
    assert torch.equal(rows.argmax(-1), picks)
    assert _rel(other, fin) > 100 * TOL
    # each row's value at the program's length is 0 (no change needed)
    assert float(rows.gather(-1, picks[..., None]).abs().max()) == 0.0


def test_length_costs_are_the_least_change():
    # argmaxes 2, 0, 1, 0 -> length 2; C = 3, T = 4
    logits = torch.tensor([[[0.0, 1.0, 3.0], [2.0, 1.5, 0.0], [0.0, 4.0, 1.0],
                            [5.0, 0.0, 0.0]]])
    want = [3.0, 0.0, 0.5 + 4.0, 0.5]  # lengths 1..4
    assert rabinet.length_costs(logits)[0].tolist() == want


@pytest.mark.parametrize('fault', [None, 'read_half_batch', 'read_token'])
def test_run_is_correct_and_faults_are_not(fault):
    cell = tiny_cell(CELL, sizes=SIZES)
    if fault is None:
        outcome, _ = run_cpu(cell, seed=2 ** 33 + 11, seconds=0.3)
        assert outcome.attempted > 0 and outcome.failed == 0
    else:
        with faults.FAULTS[fault](cell):
            outcome, _ = run_cpu(cell, seed=5, seconds=0.3)
    assert report.judge(outcome.readings, cell.checks['limits'])[1] == (fault is None), \
        outcome.readings


def test_control_is_not_correct():
    cell = tiny_cell(CELL, sizes=SIZES)
    _, ctx = run_cpu(cell, seed=9, seconds=0.3)
    got = control.fp8_reading(ctx)
    assert not report.judge(got, cell.checks['limits'])[1], got


@pytest.mark.parametrize('sizes', [SIZES, None], ids=['tiny', 'published'])
@pytest.mark.parametrize('B', [1, 3])
def test_read_flops(sizes, B):
    """On meta tensors: at the published widths 14.56 GFLOP an image."""
    cell = tiny_cell(CELL, sizes=sizes) if sizes else spec.load_cell(CELL)
    m = cell.config['model']
    ids = Ids(m['charset_train'])
    T = m['max_label_length'] + 1
    with torch.device('meta'):
        sd = {k: torch.zeros(s) for k, s in rabinet.param_shapes(m, ids).items()}
        x = torch.zeros(B, *m['img_size'], 3)
        with FlopCounterMode(display=False) as counter:
            rabinet.read(sd, m, ids, x, torch.full((B, T), T, dtype=torch.long))
    assert counter.get_total_flops() == B * spec.flops(cell.config['read_flops'])(m, ids)


def test_the_draw_keeps_the_logits_image_dependent_and_the_features_near_unit_scale():
    """Under init_kind: ResNet45's output near unit scale, and the vision
    logits' dependence on the image and on the position (the share of their
    spread that changes with either). Under the two draws it departs from:
    every convolution xavier (bound sqrt(3 / C_in), so a 3x3 one multiplies
    the variance by 9, compounded over the blocks' identity shortcuts), or
    every convolution truncated normal (std 0.02: the features all but
    vanish, and the logits are the same for every image)."""
    cell, m, ids, sd = _setup(3)
    shapes = rabinet.param_shapes(m, ids)

    def redrawn(kind):
        return weights.draw(shapes, 3, 'cpu', lambda k: kind if rabinet._CONV.search(k)
                            else rabinet.init_kind(k))

    def read(p):
        with torch.no_grad():
            a, b = (rabinet.vision(Ops(), p, m, _images(m, 4, s))[1] for s in (1, 2))
            feature = rabinet.resnet45(Ops(), p, _images(m, 4, 1).permute(0, 3, 1, 2))
        return (float((a - b).std() / a.std()), float(a.std(1).mean() / a.std()),
                float(feature.std()))

    image, position, scale = read(sd)
    assert image > 0.1 and position > 0.1 and 0.3 < scale < 3
    assert read(redrawn('xavier'))[2] > 1e4
    assert read(redrawn('tn'))[0] < 1e-3
