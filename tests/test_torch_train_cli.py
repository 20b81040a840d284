"""`python -m parseq_tpu_torch.cli.train ... --device cpu` for every family
at the small geometries of tests/test_train_all_families.py, computing in
float32 as that test trains (the CLI's `train` given compute_dtype float32):
it trains, validates, checkpoints, reads from the best checkpoint and
resumes; ABINet across its switch from pretraining to joint training (the
alignment redrawn once, the optimizer's moments kept), its language model
alone leaving the vision model as drawn."""

import functools
import json

import numpy as np
import pytest
import torch

from parseq_tpu_torch.models import abinet as tabinet
from parseq_tpu_torch.train import loop, optim

from .test_torch_train_families import one_torch_thread  # noqa: F401 (autouse fixture)


# small geometries of tests/test_train_all_families.py, as CLI overrides
CLI_MODELS = {
    'vitstr': ['model.img_size=[16,32]', 'model.patch_size=[8,8]', 'model.depth=1',
               'model.embed_dim=32', 'model.num_heads=4', 'model.max_label_length=7'],
    'crnn': ['model.img_size=[32,64]', 'model.hidden_size=16'],
    'trba': ['model.img_size=[32,64]', 'model.num_fiducial=6', 'model.output_channel=32',
             'model.hidden_size=16'],
    'abinet': ['model.img_size=[32,64]', 'model.nhead=4', 'model.d_inner=64',
               'model.v_num_layers=1', 'model.l_num_layers=1', 'model.iter_size=1'],
}
CLI_MODELS['trbc'] = CLI_MODELS['trba']
CLI_MODELS['tune_abinet-lm'] = CLI_MODELS['abinet']


def _cli(experiment, data_root, work_dir, steps, *extra):
    from parseq_tpu_torch.cli import train as train_cli

    return train_cli.main([
        f'+experiment={experiment}', f'data.root_dir={data_root}', 'data.num_workers=0',
        'data.augment=false', 'model.batch_size=4', f'trainer.max_steps={steps}',
        'trainer.val_check_interval=2', 'trainer.swa_epoch_start=0.0',
        *CLI_MODELS[experiment], *extra, f'--work_dir={work_dir}', '--device', 'cpu'])


@pytest.fixture(autouse=True)
def float32_compute(monkeypatch):
    """The CLI's train computes in float32 (bf16 on a CPU is slow)."""
    monkeypatch.setattr(loop, 'train', functools.partial(loop.train,
                                                         compute_dtype=torch.float32))


@pytest.fixture
def alignment_resets(monkeypatch):
    """Records each alignment redraw: the optimizer's step count, the
    alignment parameters' Adam moments before and after, and the weights."""
    made, calls = [], []
    make = optim.make_abinet_optimizer
    monkeypatch.setattr(optim, 'make_abinet_optimizer',
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    redraw = tabinet.ABINet.alignment_init

    def recorded(self, generator):
        opt = made[-1]
        idx = [i for i, (n, _) in enumerate(self.named_parameters()) if n.startswith('alignment.')]
        mu = [opt.mu[i].clone() for i in idx]
        before = {n: p.clone() for n, p in self.alignment.named_parameters()}
        redraw(self, generator)
        calls.append({'count': opt.count, 'optimizers': len(made), 'mu_before': mu,
                      'mu_after': [opt.mu[i].clone() for i in idx], 'before': before,
                      'after': {n: p.clone() for n, p in self.alignment.named_parameters()}})

    monkeypatch.setattr(tabinet.ABINet, 'alignment_init', recorded)
    return calls


@pytest.mark.parametrize('experiment', ['vitstr', 'crnn', 'trbc', 'trba', 'abinet',
                                        'tune_abinet-lm'])
def test_cli_trains_each_family_on_cpu(experiment, tmp_path, alignment_resets):
    """2 steps (ABINet 4, across its switch from pretraining to joint at
    8/18 of the steps): finite metrics, a validation every 2 steps, the
    checkpoints, a read from the best one, and a resume for 2 more steps."""
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    from .test_torch_train import _write_db

    rng = np.random.default_rng(0)
    words = ['cat', 'dog', 'bird', 'fish', 'ab', 'xyz', 'hello', 'world']
    _write_db(tmp_path / 'data' / 'train' / 'real' / 'syn', list(rng.choice(words, 16)))
    _write_db(tmp_path / 'data' / 'val' / 'syn', words)
    steps = 4 if experiment == 'abinet' else 2
    state, best = _cli(experiment, tmp_path / 'data', tmp_path / 'run', steps)
    assert state['step'] == steps
    metrics = [json.loads(line) for line in open(tmp_path / 'run' / 'metrics.jsonl')]
    losses = [(m['loss'], m['grad_norm']) for m in metrics if 'loss' in m]
    vals = [m for m in metrics if 'val_accuracy' in m]
    assert losses and np.isfinite(losses).all()
    assert [v['step'] for v in vals] == list(range(2, steps + 1, 2))
    assert all(np.isfinite(v['val_loss']) for v in vals)
    ckpts = tmp_path / 'run' / 'checkpoints'
    for name in ('last.ckpt', 'train_state.ckpt', 'swa_state.ckpt', 'swa.ckpt'):
        assert (ckpts / name).exists(), name
    bundle = load_from_checkpoint(str(best), dtype=torch.float32, device='cpu')
    h, w = bundle.img_size
    labels, confs = bundle.read(np.zeros((2, h, w, 3), np.float32))
    assert len(labels) == len(confs) == 2

    if experiment == 'abinet':
        (reset,) = alignment_resets  # once, after the two pretraining steps
        assert reset['count'] == 2 and reset['optimizers'] == 1
        for before, after in zip(reset['mu_before'], reset['mu_after']):
            assert before.abs().max() > 0 and torch.equal(before, after)  # moments kept
        assert not torch.equal(reset['before']['w_att.weight'], reset['after']['w_att.weight'])
        assert not reset['after']['cls.bias'].any()  # redrawn: zero bias
    else:
        assert not alignment_resets
    if experiment == 'tune_abinet-lm':  # the language model alone: vision as drawn
        from parseq_tpu_torch.utils.registry import build_model

        mcfg = json.load(open(tmp_path / 'run' / 'config.json'))['model']
        drawn = build_model(mcfg['name'], mcfg, seed=0, device='cpu').module.state_dict()
        trained = torch.load(ckpts / 'train_state.ckpt', weights_only=True)['model']
        assert all(torch.equal(trained[k], drawn[k]) for k in drawn if k.startswith('vision.'))
        assert not torch.equal(trained['language.cls.weight'], drawn['language.cls.weight'])

    resumed, _ = _cli(experiment, tmp_path / 'data', tmp_path / 'run2', steps + 2,
                      f'ckpt_path={ckpts / "train_state.ckpt"}')
    assert resumed['step'] == steps + 2
    assert [json.loads(line)['step'] for line in open(tmp_path / 'run2' / 'metrics.jsonl')][0] \
        == steps + 1
