"""The port's train step, data pipeline copies and training loop on the CPU,
against the JAX package where both can run the same inputs."""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import jax
import jax.numpy as jnp

from parseq_tpu.data.tokenizer import Tokenizer as JTokenizer
from parseq_tpu.models import parseq as jparseq
from parseq_tpu.train import optim as joptim
from parseq_tpu.train.families import FAMILIES as JFAMILIES
from parseq_tpu.train.steps import make_train_step as jmake_train_step
from parseq_tpu_torch.data.lmdb import LmdbWriter
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import init_state, make_train_step
from parseq_tpu_torch.utils.convert import state_dict_from_jax

CHARSET = 'abcdefghijklmnopqrstuvwxyz'
KW = dict(num_tokens=len(CHARSET) + 3, max_label_length=7, img_size=(16, 32), patch_size=(4, 8),
          embed_dim=64, enc_num_heads=2, enc_mlp_ratio=2.0, enc_depth=1, dec_num_heads=4,
          dec_mlp_ratio=2.0, dec_depth=1, dropout=0.0)


def _text_png(text, w=64, h=24):
    img = Image.new('RGB', (w, h), (255, 255, 255))
    ImageDraw.Draw(img).text((2, 2), text, fill=(0, 0, 0))
    buf = io.BytesIO()
    img.save(buf, 'PNG')
    return buf.getvalue()


def _write_db(path, words):
    with LmdbWriter(path) as w:
        w.put(b'num-samples', str(len(words)).encode())
        for i, word in enumerate(words, start=1):
            w.put(f'image-{i:09d}'.encode(), _text_png(word))
            w.put(f'label-{i:09d}'.encode(), word.encode())


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('data')
    words = ['cat', 'dog', 'bird', 'fish', 'ab', 'xyz', 'hello', 'world']
    rng = np.random.default_rng(0)
    _write_db(root / 'train' / 'real' / 'syn', list(rng.choice(words, 24)))
    _write_db(root / 'val' / 'syn', words + ['Too Long Label X'])
    return root


def _batch(B=8, seed=0, length=None):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 16, 32, 3)).astype(np.uint8)
    words = [''.join(rng.choice(list(CHARSET), length or rng.integers(1, 8))) for _ in range(B)]
    tgt = JTokenizer(CHARSET).encode(words, KW['max_label_length'])
    perms = jparseq.gen_tgt_perms(np.random.default_rng(seed), jparseq.PARSeqConfig(**KW))
    return {'images': images, 'tgt': tgt, 'perms': perms}


def _port_model(params):
    model = PARSeq(PARSeqConfig(**KW))
    model.load_state_dict(state_dict_from_jax(params, KW['patch_size']), strict=True)
    return model


@pytest.mark.parametrize('microbatches', [1, 4])
def test_train_step_matches_jax(microbatches):
    """One step at f32 with dropout 0: loss, grad norm and the updated
    params (OneCycle LR at step 0, AdamW, clip 20) against the JAX step."""
    cfg = jparseq.PARSeqConfig(**KW)
    params = jparseq.init(jax.random.key(1), cfg)
    ocfg = dict(lr=3e-3, total_steps=10, batch_size=8, warmup_pct=0.2)
    tx, _ = joptim.make_optimizer(joptim.OptimConfig(**ocfg), params)
    jstep = jax.jit(jmake_train_step(JFAMILIES['parseq'], cfg, tx, jnp.float32,
                                     microbatches=microbatches))
    batch = _batch()
    jstate = {'params': params, 'stats': {}, 'opt_state': tx.init(params),
              'step': jnp.zeros((), jnp.int32)}
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))

    model = _port_model(params)
    state = init_state(model, optim.OptimConfig(**ocfg))
    step = make_train_step(get_family('parseq'), model.cfg, torch.float32,
                           microbatches=microbatches)
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert state['step'] == 1 and state['opt_state'].count == 1
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), atol=1e-5)
    np.testing.assert_allclose(float(m['grad_norm']), float(jm['grad_norm']), rtol=1e-4)
    assert int(m['numel']) == int(jm['numel'])
    want = state_dict_from_jax(jstate['params'], KW['patch_size'])
    for name, p in model.named_parameters():
        # one AdamW step moves each weight by at most ~lr; f32 gradients that
        # differ in the last digits move it by far less
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-6,
                                   err_msg=name)


def test_microbatches_equal_single_step():
    """microbatches 4 and 1: the same mean gradient, the same update, when
    every microbatch counts the same number of tokens (labels of one length;
    otherwise the equal-weight mean of per-microbatch means differs from the
    token mean, as DDP's does)."""
    params = jparseq.init(jax.random.key(2), jparseq.PARSeqConfig(**KW))
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=3, length=5).items()}
    out = []
    for m in (1, 4):
        model = _port_model(params)
        state = init_state(model, optim.OptimConfig(total_steps=5, batch_size=8))
        metrics = make_train_step(get_family('parseq'), model.cfg, torch.float32,
                                  microbatches=m)(state, batch, None)
        out.append((metrics, model.state_dict()))
    (m1, sd1), (m4, sd4) = out
    np.testing.assert_allclose(float(m4['grad_norm']), float(m1['grad_norm']), rtol=1e-5)
    assert int(m4['numel']) == int(m1['numel'])
    for k in sd1:
        torch.testing.assert_close(sd4[k], sd1[k], rtol=0, atol=1e-6)


def test_gradient_accumulation_updates_every_k_calls():
    params = jparseq.init(jax.random.key(4), jparseq.PARSeqConfig(**KW))
    model = _port_model(params)
    state = init_state(model, optim.OptimConfig(total_steps=5, batch_size=8), accumulate=2)
    step = make_train_step(get_family('parseq'), model.cfg, torch.float32, accumulate=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(state, {k: torch.from_numpy(v) for k, v in _batch(seed=5).items()}, None)
    assert state['opt_state'].count == 0
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    step(state, {k: torch.from_numpy(v) for k, v in _batch(seed=6).items()}, None)
    assert state['opt_state'].count == 1
    assert not torch.equal(before['head.weight'], model.state_dict()['head.weight'])


@pytest.mark.parametrize('name,val', [('vitstr', 'ce'), ('crnn', 'ctc'), ('trbc', 'ctc'),
                                      ('trba', 'ce'), ('abinet', 'ce'), ('abinet-lm', 'ce')])
def test_get_family_returns_each_adapter(name, val):
    """Every family trains (tests/test_torch_train_families.py); CRNN and
    TRBC validate with the CTC loss, the others with CE."""
    family = get_family(name)
    assert callable(family.prepare) and callable(family.loss) and family.val == val


@pytest.mark.parametrize('split', ['train', 'val'])
def test_port_data_module_gives_the_jax_batches(data_root, split):
    """The port's copies (LMDB reader, datasets, loader, transforms) and the
    JAX package's modules read the same tiny LMDB into equal batches."""
    from parseq_tpu.data.module import SceneTextDataModule as JModule
    from parseq_tpu_torch.data.module import SceneTextDataModule

    args = (str(data_root), 'real', (16, 32), 7, CHARSET, CHARSET, 4, 0, False)
    mods = [cls(*args) for cls in (JModule, SceneTextDataModule)]
    loaders = [m.train_dataloader(seed=3) if split == 'train' else m.val_dataloader()
               for m in mods]
    batches = [list(ld) for ld in loaders]
    assert len(batches[0]) == len(batches[1]) > 1
    for (ja, jl, jv), (ta, tl, tv) in zip(*batches):
        assert ta.dtype == ja.dtype == np.uint8
        np.testing.assert_array_equal(ta, ja)
        assert tl == jl
        np.testing.assert_array_equal(tv, jv)


def _config(data_root, **trainer):
    return {
        'model': {'name': 'parseq', 'img_size': [16, 32], 'patch_size': [4, 8],
                  'max_label_length': 7, 'charset_train': CHARSET, 'charset_test': CHARSET,
                  'batch_size': 4, 'lr': 3e-4, 'weight_decay': 0.0, 'warmup_pct': 0.2,
                  'embed_dim': 64, 'enc_num_heads': 2, 'enc_mlp_ratio': 2, 'enc_depth': 1,
                  'dec_num_heads': 4, 'dec_mlp_ratio': 2, 'dec_depth': 1, 'perm_num': 6,
                  'perm_forward': True, 'perm_mirrored': True, 'dropout': 0.1,
                  'decode_ar': True, 'refine_iters': 1},
        'data': {'root_dir': str(data_root), 'train_dir': 'real', 'num_workers': 0,
                 'augment': False, 'batch_size': 4},
        'trainer': {'max_epochs': 2, 'val_check_interval': 3, 'gradient_clip_val': 20,
                    'devices': 1, 'swa': True, 'microbatches': 2, **trainer},
    }


def test_train_on_cpu_writes_metrics_checkpoints_and_resumes(data_root, tmp_path):
    from parseq_tpu_torch.train.loop import train
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    cfg = _config(data_root, swa_epoch_start=0.0)
    state, best = train(cfg, tmp_path / 'run', compute_dtype=torch.float32, max_steps=6,
                        device='cpu')
    assert state['step'] == 6 and state['opt_state'].count == 6
    metrics = [json.loads(line) for line in open(tmp_path / 'run' / 'metrics.jsonl')]
    losses = [m['loss'] for m in metrics if 'loss' in m]
    vals = [m for m in metrics if 'val_accuracy' in m]
    assert losses and all(np.isfinite(losses))
    assert [v['step'] for v in vals] == [3, 6]
    assert all(np.isfinite(v['val_loss']) and 0 <= v['val_accuracy'] <= 100 for v in vals)
    ckpts = tmp_path / 'run' / 'checkpoints'
    assert best is not None and best.exists() and best.suffix == '.ckpt'
    for name in ('last.ckpt', 'train_state.ckpt', 'swa_state.ckpt', 'swa.ckpt'):
        assert (ckpts / name).exists(), name
    assert list((tmp_path / 'run' / 'tb').glob('events.out.tfevents.*'))

    bundle = load_from_checkpoint(str(best), dtype=torch.float32, device='cpu')
    labels, confs = bundle.read(np.zeros((3, 16, 32, 3), np.float32))
    assert len(labels) == len(confs) == 3
    torch.testing.assert_close(bundle.module.state_dict()['head.weight'],
                               torch.load(best, weights_only=True)['state_dict']['head.weight'])

    # resume from step 6 continues to step 8 and appends its own metrics
    cfg = _config(data_root, swa_epoch_start=0.0)
    cfg['ckpt_path'] = str(ckpts / 'train_state.ckpt')
    state2, _ = train(cfg, tmp_path / 'run2', compute_dtype=torch.float32, max_steps=8,
                      device='cpu')
    assert state2['step'] == 8 and state2['opt_state'].count == 8
    steps = [json.loads(line)['step'] for line in open(tmp_path / 'run2' / 'metrics.jsonl')]
    assert steps[0] == 7 and max(steps) == 8


def test_train_rejects_unknown_keys_and_devices(data_root, tmp_path):
    from parseq_tpu_torch.train.loop import train

    with pytest.raises(ValueError, match='unknown trainer config'):
        train(_config(data_root, bogus=1), tmp_path / 'a', device='cpu')
    cfg = _config(data_root)
    cfg['data']['bogus'] = 1
    with pytest.raises(ValueError, match='unknown data config'):
        train(cfg, tmp_path / 'b', device='cpu')
    with pytest.raises(ValueError, match='in no process group'):
        train(_config(data_root, devices=2), tmp_path / 'c', device='cpu')


def test_cli_trains_on_cpu(data_root, tmp_path):
    from parseq_tpu_torch.cli import train as train_cli

    state, best = train_cli.main([
        '+experiment=parseq-tiny', f'data.root_dir={data_root}', 'data.num_workers=0',
        'data.augment=false', 'model.batch_size=4', 'model.img_size=[16,32]',
        'model.enc_depth=1', 'trainer.max_steps=2', 'trainer.val_check_interval=2',
        f'--work_dir={tmp_path / "cli"}', '--device', 'cpu'])
    assert state['step'] == 2 and best.exists()


def test_cli_has_no_cpu_carry_on(data_root, tmp_path, monkeypatch):
    """--device cuda (the default) without a card raises; it never trains on
    the CPU instead."""
    from parseq_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main(['+experiment=parseq-tiny', f'data.root_dir={data_root}',
                        f'--work_dir={tmp_path / "cli"}'])
    assert not (tmp_path / 'cli' / 'metrics.jsonl').exists()


def test_training_tracks_jax_over_many_steps():
    """From the same initial weights, with dropout off at f32, 40 steps of
    the port's train step follow the JAX package's step on the same
    batches and permutations: loss and grad norm at every step (the f32
    sums differ only in order; AdamW keeps the two trajectories together)."""
    cfg = jparseq.PARSeqConfig(**KW)
    params = jparseq.init(jax.random.key(7), cfg)
    ocfg = dict(lr=3e-3, total_steps=40, batch_size=8, warmup_pct=0.1)
    tx, _ = joptim.make_optimizer(joptim.OptimConfig(**ocfg), params)
    jstep = jax.jit(jmake_train_step(JFAMILIES['parseq'], cfg, tx, jnp.float32))
    jstate = {'params': params, 'stats': {}, 'opt_state': tx.init(params),
              'step': jnp.zeros((), jnp.int32)}
    model = _port_model(params)
    state = init_state(model, optim.OptimConfig(**ocfg))
    step = make_train_step(get_family('parseq'), model.cfg, torch.float32)
    for s in range(40):
        batch = _batch(seed=100 + s % 5)  # 5 batches, seen 8 times each
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=1e-3,
                                   err_msg=f'step {s}')
        np.testing.assert_allclose(float(m['grad_norm']), float(jm['grad_norm']), rtol=1e-2,
                                   err_msg=f'step {s}')
