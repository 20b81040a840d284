"""The port's learning-rate search (cli/tune.py) against the JAX package's:
the LR grid, the two stoppers on the same seeded result histories (equal
stop decisions at every validation), the defaults from configs/tune.yaml,
and successive halving through `cli.tune --device cpu` on a tiny PARSeq,
as tests/test_cli.py::test_tune_cli_successive_halving runs the JAX CLI."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from parseq_tpu.cli import tune as jtune
from parseq_tpu_torch.cli import tune

from .test_lmdb import make_str_db
from .test_torch_train_families import one_torch_thread  # noqa: F401 (autouse fixture)


def test_lr_grid_and_defaults_equal():
    assert tune.lr_grid(1e-4, 2e-3, 5) == jtune.lr_grid(1e-4, 2e-3, 5)
    assert tune.lr_grid(3e-4, 3e-4, 1) == jtune.lr_grid(3e-4, 3e-4, 1)
    assert tune._tune_defaults() == jtune._tune_defaults()


def _histories(seed, trials=6, steps=14):
    """Per trial, a seeded run of validations: rising, flat, falling or noisy
    NED, now and then a NaN loss."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in range(trials):
        kind = ('rise', 'flat', 'noise', 'fall')[t % 4]
        base, slope = {'rise': (0.4, 0.05), 'flat': (0.5, 0.0), 'noise': (0.45, 0.0),
                       'fall': (0.3, -0.04)}[kind]
        neds = base + slope * np.arange(steps) + rng.normal(
            0, 0.003 if kind != 'noise' else 0.05, steps)
        losses = rng.uniform(0.5, 2.0, steps)
        if rng.random() < 0.3:
            losses[rng.integers(2, steps)] = np.nan
        out[f't{t}'] = [(float(n), float(l)) for n, l in zip(neds, losses)]
    return out


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('max_t', [5, 10 ** 9])
def test_metric_tracker_decides_as_the_jax_one(seed, max_t):
    ours, theirs = (tune.MetricTracker('NED', max_t=max_t, patience=3),
                    jtune.MetricTracker('NED', max_t=max_t, patience=3))
    decisions = []
    for tid, history in _histories(seed).items():
        for it, (ned, loss) in enumerate(history, 1):
            result = {'training_iteration': it, 'loss': loss, 'NED': ned}
            want = theirs(tid, dict(result))
            assert ours(tid, dict(result)) == want, (tid, it)
            assert ours.trial_history == theirs.trial_history
            decisions.append(want)
    assert any(decisions) and not all(decisions)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('grace', [0, 2])
def test_median_stopping_rule_decides_as_the_jax_one(seed, grace):
    ours, theirs = (tune.MedianStoppingRule(grace_period=grace, min_samples_required=3),
                    jtune.MedianStoppingRule(grace_period=grace, min_samples_required=3))
    decisions = []
    for tid, history in _histories(seed).items():
        for it, (ned, _) in enumerate(history, 1):
            want = theirs.on_result(tid, it, ned)
            assert ours.on_result(tid, it, ned) == want, (tid, it)
            decisions.append(want)
    assert ours.results == theirs.results
    assert any(decisions) and not all(decisions)


def _word_png(text):
    im = Image.new('RGB', (48, 16), (255, 255, 255))
    ImageDraw.Draw(im).text((1, 1), text, fill=(0, 0, 0))
    b = io.BytesIO()
    im.save(b, 'PNG')
    return b.getvalue()


TINY = ['model.img_size=[16,32]', 'model.enc_depth=1', 'model.embed_dim=32',
        'model.enc_num_heads=2', 'model.dec_num_heads=4', 'model.max_label_length=5',
        'model.batch_size=4', 'model.decode_ar=false', 'model.refine_iters=0',
        'data.num_workers=0', 'data.augment=false', 'trainer.devices=1', 'trainer.swa=false']


def test_tune_cli_successive_halving(tmp_path):
    """The setup of tests/test_cli.py::test_tune_cli_successive_halving
    through the port's CLI on the CPU: two trials of distinct LR, each
    validated, results.json and a finite best LR."""
    root = tmp_path / 'data'
    words = ['ab', 'cd', 'ef', 'gh']
    make_str_db(root / 'train' / 'real' / 's', [(_word_png(w), w) for w in words * 4])
    make_str_db(root / 'val' / 's', [(_word_png(w), w) for w in words])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tune.main(['--num_samples', '2', '--rung_steps', '2', '--rungs', '1',
                   '--work_dir', str(tmp_path / 'tune'), '--device', 'cpu',
                   *TINY, f'data.root_dir={root}'])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert np.isfinite(out['best_lr'])
    results = json.loads((tmp_path / 'tune' / 'results.json').read_text())
    assert len(results) == 2 and results[0]['lr'] != results[1]['lr']
    assert out['best_lr'] in (results[0]['lr'], results[1]['lr'])
    for r in results:
        assert r['rung'] == 0 and r['steps'] == 2 and r['wall_s'] > 0
        assert np.isfinite(r['val_loss']) and 0.0 <= r['val_NED'] <= 100.0
        trial = tmp_path / 'tune' / f'rung0_trial{results.index(r)}_lr{r["lr"]:.2e}'
        cfg = json.loads((trial / 'config.json').read_text())
        assert cfg['model']['lr'] == r['lr']  # the trial trained at its own LR


def test_tune_cli_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit):
        tune.main(['--num_samples', '1', '--work_dir', str(tmp_path)])
    assert not (tmp_path / 'results.json').exists()
