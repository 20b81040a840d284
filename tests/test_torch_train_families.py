"""The port's training of ViTSTR, CRNN, TRBC, TRBA and ABINet on the CPU,
against the JAX package on the same inputs.

One train step per family (ABINet in each of its stages) at f32 with
dropout 0, from the same weights (JAX init, batch-norm affines and
statistics redrawn with numpy, converted to the port's state_dict), on a
numpy batch: the loss, the gradient norm, every parameter's gradient, the
batch-norm running statistics and the updated parameters against the JAX
package's `make_train_step`. The JAX side's TRBA samples its TPS grid with
`_grid_sample_gather`, the semantics-defining path the port's grid_sample is
held to (tests/test_torch_trba.py), monkeypatched in; the JAX package is
unchanged. Gradients that pass back through train-mode batch norms on this
small batch may be held by their relative L2 difference (TRUNK below). Then
attention routing under dropout, the train loop's CTC validation and SWA
batch-norm re-estimation against the JAX loop's. The TRBA, TRBC and ABINet
steps are in tests/test_torch_train_trba.py and tests/test_torch_train_abinet*.py,
`cli.train --device cpu` for every family in tests/test_torch_train_cli.py:
one file for each test worker's share, as `--dist loadfile` keeps a file on
one worker.
"""

import functools
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.data import tokenizer as jtokenizer
from parseq_tpu.models import abinet as jabinet
from parseq_tpu.models import crnn as jcrnn
from parseq_tpu.models import trba as jtrba
from parseq_tpu.models import vitstr as jvitstr
from parseq_tpu.ops import grid_sample as jgrid
from parseq_tpu.train import optim as joptim
from parseq_tpu.train.families import FAMILIES as JFAMILIES
from parseq_tpu.train.steps import make_train_step as jmake_train_step
from parseq_tpu_torch.data import tokenizer as ttokenizer
from parseq_tpu_torch.models import abinet as tabinet
from parseq_tpu_torch.models import crnn as tcrnn
from parseq_tpu_torch.models import trba as ttrba
from parseq_tpu_torch.models import vitstr as tvitstr
from parseq_tpu_torch.ops import attention, flash_bwd, layers
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import init_state, make_train_step
from parseq_tpu_torch.utils import convert

CHARSET = 'abcdefghijklmnopqrstuvwxyz'
B = 4
MAX_LEN = 7
OCFG = dict(lr=3e-3, total_steps=10, batch_size=B, warmup_pct=0.2)
L_LR = 1e-3  # ABINet's language-model LR, unlike the main one
PRETRAIN_END = 4
# f32 both sides, sums in another order.
LOSS_ATOL = 1e-5
GNORM_RTOL = 1e-4
GRAD_REL = 1e-4  # of each parameter's largest gradient
GRAD_FLOOR = 1e-2  # ... or of this share of the model's largest, if more
STATS_ATOL = 1e-5
STATS_RTOL = 1e-4  # a late ResNet layer's batch variance, f32 sums in another order
PARAM_ATOL = 2e-6  # tests/test_torch_train.py::test_train_step_matches_jax
# A trunk of train-mode batch norms (the CNNs of CRNN, TRBA and TRBC,
# ABINet's ResNet, vision transformer and position attention): the f32
# rounding of the forward grows through tens of batch norms and puts a few
# ReLU and max-pool decisions on the other side, which moves the gradients
# that pass back through them by up to a few percent. Either framework's
# f32 step can be the one that is off: against the port's float64 step
# (experiments/torch_train_f64_witness.py, seed 0, microbatches 1), CRNN's
# JAX gradients sit 2.6e-3 away and the port's 1.7e-5; ABINet's
# (pretraining) 2.6e-2 and 1.6e-2. A trunk parameter whose gradient misses
# the limit above is held by its relative L2 difference within its family's
# bound: 3x the worst reading over seeds 0-4 at microbatches 1 and 2 (CRNN
# 1.5e-2, TRBA 3.8e-2, TRBC 6.5e-2, ABINet 5.8e-2).
# family -> (prefixes, bound)
TRUNK = {'crnn': (('cnn.',), 5e-2),
         'trba': (('Transformation.', 'FeatureExtraction.'), 1.2e-1),
         'trbc': (('Transformation.', 'FeatureExtraction.'), 2e-1),
         'abinet': (('vision.backbone.', 'vision.attention.'), 1.8e-1)}

# family -> (JAX model module, port model module, config keywords)
GEOMETRY = {
    'vitstr': (jvitstr, tvitstr, dict(img_size=(16, 32), patch_size=(8, 8), depth=1,
                                      embed_dim=32, num_heads=4)),
    'crnn': (jcrnn, tcrnn, dict(img_size=(32, 64), hidden_size=16)),
    'trba': (jtrba, ttrba, dict(img_size=(32, 64), num_fiducial=6, output_channel=32,
                                hidden_size=16, num_char_embeddings=16)),
    'trbc': (jtrba, ttrba, dict(img_size=(32, 64), num_fiducial=6, output_channel=32,
                                hidden_size=16, num_char_embeddings=16, use_ctc=True)),
    'abinet': (jabinet, tabinet, dict(img_size=(32, 128), d_model=512, nhead=4, d_inner=64,
                                      v_num_layers=1, l_num_layers=1, iter_size=2,
                                      dropout=0.0)),
}
CTC = ('crnn', 'trbc')
# TRBA's and TRBC's images vary over 8 pixels (_smooth_images), as text
# crops do: on per-pixel noise their TPS sampling turns the grid's last-bit
# rounding, which differs between the frameworks, into changes of whole
# pixel values, which flip ReLU and max-pool decisions downstream (the
# port's f32 ResNet gradients then sit 5-30% from its float64 ones,
# experiments/torch_train_f64_witness.py).
SMOOTH_IMAGES = {'trba', 'trbc'}


def _redraw(tree, rng):
    """Batch-norm scale/bias and mean/var leaves redrawn with numpy."""
    if isinstance(tree, list):
        return [_redraw(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {'scale', 'bias'}:
        return {'scale': jnp.asarray(rng.uniform(0.5, 1.5, tree['scale'].shape), jnp.float32),
                'bias': jnp.asarray(rng.normal(0, 0.1, tree['bias'].shape), jnp.float32)}
    if set(tree) == {'mean', 'var'}:
        return {'mean': jnp.asarray(rng.normal(0, 0.1, tree['mean'].shape), jnp.float32),
                'var': jnp.asarray(rng.uniform(0.5, 1.5, tree['var'].shape), jnp.float32)}
    return {k: _redraw(v, rng) for k, v in tree.items()}


def _state_dict(family, params, stats, kw):
    if family == 'vitstr':
        return convert.vitstr_state_dict_from_jax(params, patch_size=kw['patch_size'])
    if family == 'crnn':
        return convert.crnn_state_dict_from_jax(params, stats)
    if family in ('trba', 'trbc'):
        return convert.trba_state_dict_from_jax(params, stats, use_ctc=family == 'trbc')
    return convert.abinet_state_dict_from_jax(params, stats, img_size=kw['img_size'],
                                              max_label_length=MAX_LEN)


# family -> (JAX config class, port model class, port config class)
CLASSES = {'vitstr': ('ViTSTRConfig', 'ViTSTR'), 'crnn': ('CRNNConfig', 'CRNN'),
           'trba': ('TRBAConfig', 'TRBA'), 'trbc': ('TRBAConfig', 'TRBA'),
           'abinet': ('ABINetConfig', 'ABINet')}


def _tokenizers(family):
    ctc = family in CTC
    return ((jtokenizer.CTCTokenizer if ctc else jtokenizer.Tokenizer)(CHARSET),
            (ttokenizer.CTCTokenizer if ctc else ttokenizer.Tokenizer)(CHARSET))


@functools.lru_cache(maxsize=None)
def _jax_weights(family, seed):
    """JAX init (the slow part, cached) with the batch-norm leaves and TRBA's
    localization head redrawn -> (JAX cfg, params, stats, keywords)."""
    jmod, _, kw = GEOMETRY[family]
    kw = dict(kw, num_tokens=len(_tokenizers(family)[0]), max_label_length=MAX_LEN)
    jcfg = getattr(jmod, CLASSES[family][0])(**kw)
    tree = jmod.init(jax.random.key(seed), jcfg)
    params, stats = tree if isinstance(tree, tuple) else (tree, {})
    rng = np.random.default_rng(seed)
    params, stats = _redraw(params, rng), _redraw(stats, rng)
    if family in ('trba', 'trbc'):  # an image-dependent TPS grid
        fc2 = params['loc']['fc2']
        params['loc']['fc2'] = dict(fc2, w=jnp.asarray(rng.normal(0, 0.05, fc2['w'].shape),
                                                       jnp.float32))
    return jcfg, params, stats, kw


def _setup(family, seed=0):
    """-> (JAX cfg, params, stats, port model in train mode on the same
    weights, JAX and port tokenizers, config keywords)."""
    jcfg, params, stats, kw = _jax_weights(family, seed)
    tmod = GEOMETRY[family][1]
    cfg_cls, model_cls = CLASSES[family]
    model = getattr(tmod, model_cls)(getattr(tmod, cfg_cls)(**kw))
    model.load_state_dict(_state_dict(family, params, stats, kw), strict=True)
    return (jcfg, params, stats, model.train(), *_tokenizers(family), kw)


def _words(rng, n=B):
    return [''.join(rng.choice(list(CHARSET), rng.integers(1, MAX_LEN + 1))) for _ in range(n)]


def _smooth_images(rng, h, w, cell=8):
    """uint8 images that vary over `cell` pixels, as text crops do: noise
    at 1/cell of the resolution, upsampled bilinearly."""
    lo = rng.uniform(0, 255, (B, h // cell + 2, w // cell + 2, 3))
    y, x = np.linspace(0, h // cell + 1, h), np.linspace(0, w // cell + 1, w)
    y0, x0 = np.minimum(y.astype(int), h // cell), np.minimum(x.astype(int), w // cell)
    wy, wx = (y - y0)[None, :, None, None], (x - x0)[None, None, :, None]
    rows = lo[:, y0] * (1 - wy) + lo[:, y0 + 1] * wy
    return np.rint(rows[:, :, x0] * (1 - wx) + rows[:, :, x0 + 1] * wx).astype(np.uint8)


def _batches(family, jcfg, model, jtok, ttok, seed=0):
    rng = np.random.default_rng(seed)
    h, w = GEOMETRY[family][2]['img_size']
    if family in SMOOTH_IMAGES:
        images = _smooth_images(rng, h, w)
    else:
        images = rng.integers(0, 256, (B, h, w, 3)).astype(np.uint8)
    words = _words(rng)
    jbatch = {'images': images, **JFAMILIES[family].prepare(jtok, words, jcfg, None)}
    tbatch = {'images': images, **get_family(family).prepare(ttok, words, model.cfg, None)}
    assert set(jbatch) == set(tbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], jbatch[k], err_msg=k)
    return ({k: jnp.asarray(v) for k, v in jbatch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in tbatch.items()})


def _stash_grads():
    """An optax stage that keeps the gradients it is given as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: test workers run side by side on the CPU, and
    torch's default (a thread a core in every worker) oversubscribes it
    ~20-fold on these steps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gather_grid_sample(monkeypatch):
    monkeypatch.setattr(jtrba, 'grid_sample', jgrid._grid_sample_gather)


@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('family', ['vitstr', 'crnn'])
def test_train_step_matches_jax(family, microbatches, gather_grid_sample):
    check_train_step(family, {}, microbatches)


def check_train_step(family, static, microbatches):
    """One step of the port against the JAX package's; `static` goes to both
    steps' loss. TRBA and TRBC run it in tests/test_torch_train_trba.py,
    ABINet's stages in tests/test_torch_train_abinet*.py (each file on a
    test worker of its own)."""
    jcfg, params, stats, model, jtok, ttok, kw = _setup(family)
    jbatch, tbatch = _batches(family, jcfg, model, jtok, ttok)
    ocfg = joptim.OptimConfig(**OCFG)
    if family == 'abinet':
        tx, _ = joptim.make_abinet_optimizer(ocfg, L_LR, PRETRAIN_END, params)
    else:
        tx, _ = joptim.make_optimizer(ocfg, params)
    tx = optax.chain(_stash_grads(), tx)
    jstep = jax.jit(jmake_train_step(JFAMILIES[family], jcfg, tx, jnp.float32,
                                     microbatches=microbatches, **static))
    jstate = {'params': params, 'stats': stats, 'opt_state': tx.init(params),
              'step': jnp.zeros((), jnp.int32)}
    jstate, jm = jstep(jstate, jbatch, jax.random.key(0))

    state = init_state(model, optim.OptimConfig(**OCFG))
    if family == 'abinet':
        state['opt_state'] = optim.make_abinet_optimizer(
            model.named_parameters(), optim.OptimConfig(**OCFG), L_LR, PRETRAIN_END)
    step = make_train_step(get_family(family), model.cfg, torch.float32,
                           microbatches=microbatches, **static)
    m = step(state, tbatch, None)

    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), atol=LOSS_ATOL)
    np.testing.assert_allclose(float(m['grad_norm']), float(jm['grad_norm']), rtol=GNORM_RTOL)
    assert int(m['numel']) == int(jm['numel'])
    lr0 = {n: sched(0) for sched, idx in state['opt_state'].groups.items()
           for n in np.array([n for n, _ in model.named_parameters()])[idx]}
    jax_grads = _state_dict(family, jstate['opt_state'][0], jstate['stats'], kw)
    want = _state_dict(family, jstate['params'], jstate['stats'], kw)
    top = max(np.abs(g.numpy()).max() for g in jax_grads.values())
    worst = 0.0
    for name, p in model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        g = jax_grads[name].numpy()
        err = np.abs(got - g).max()
        if err > GRAD_REL * max(np.abs(g).max(), GRAD_FLOOR * top):
            rel = np.linalg.norm(got - g) / np.linalg.norm(g)
            prefixes, bound = TRUNK.get(family, ((), 0.0))
            assert name.startswith(prefixes) and rel <= bound, (
                f'gradient of {name}: max difference {err:.3e} (largest {np.abs(g).max():.3e}, '
                f"the model's {top:.3e}), relative L2 {rel:.3e}")
            worst = max(worst, rel)
        # Adam's first step moves a weight by about lr * sign(g); where the
        # two gradients' difference exceeds either, the sign is undecided
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        signed = np.minimum(np.abs(got), np.abs(g)) > np.abs(got - g)
        assert diff[signed].max(initial=0) <= PARAM_ATOL, name
        assert diff.max() <= 2 * lr0[name] + PARAM_ATOL, name
    print(f'{family} {static} x{microbatches}: worst trunk relative L2 {worst:.3e}')
    n_stats = 0
    for name, buf in model.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=STATS_RTOL,
                                       atol=STATS_ATOL, err_msg=name)
            n_stats += 1
    assert (n_stats > 0) == (family != 'vitstr')


def _raise(*args, **kwargs):
    raise AssertionError('a kernel was called under dropout')


@pytest.mark.parametrize('L', [128, 197])
def test_no_kernel_under_dropout(monkeypatch, L):
    """With attention dropout encoder_self_attention is layers.mha with that
    dropout: B2 (at L >= KERNEL_MIN_LEN) and B4 (below it, under autograd)
    are never called. Without dropout the same call does reach them."""
    monkeypatch.setattr(attention, 'fused_attention_nosplit', _raise)
    monkeypatch.setattr(flash_bwd, 'attention_flashbwd', _raise)
    rng = np.random.default_rng(0)
    D, h = 64, 1
    x = torch.from_numpy(rng.standard_normal((2, L, D)).astype(np.float32)).requires_grad_()
    w_in, b_in, w_out, b_out = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
                                for s in ((3 * D, D), (3 * D,), (D, D), (D,)))
    got = attention.encoder_self_attention(x, w_in, b_in, w_out, b_out, h, dropout_rate=0.1,
                                           rng=torch.Generator().manual_seed(3))
    want = layers.mha(x, x, x, w_in, b_in, w_out, b_out, num_heads=h, dropout_rate=0.1,
                      rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    with pytest.raises(AssertionError, match='under dropout'):
        attention.encoder_self_attention(x, w_in, b_in, w_out, b_out, h).sum().backward()


def test_ctc_validation_and_swa_batchnorm_match_jax_loop(tmp_path):
    """The JAX loop and the port's training CRNN from the same weights (a
    reference .pt both load) with the LR at 0, so the weights stay: one step
    (the same batch-norm update), the validation after it (CTC loss over the
    target length, best-path decode: loss, accuracy, NED, confidence), and
    the SWA checkpoint's batch-norm statistics, re-estimated over the train
    batches for the averaged weights."""
    from parseq_tpu.train.loop import train as jtrain
    from parseq_tpu.utils.checkpoint import load_checkpoint
    from parseq_tpu_torch.train.loop import train

    from .test_torch_train import _write_db

    rng = np.random.default_rng(1)
    words = _words(rng, 24)
    _write_db(tmp_path / 'data' / 'train' / 'real' / 'syn', words[:16])
    _write_db(tmp_path / 'data' / 'val' / 'syn', words[16:])
    _, _, _, model, _, _, kw = _setup('crnn', seed=2)
    torch.save(model.state_dict(), tmp_path / 'crnn.pt')
    config = {
        'model': dict(name='crnn', charset_train=CHARSET, charset_test=CHARSET,
                      max_label_length=MAX_LEN, batch_size=4, lr=0.0, weight_decay=0.0,
                      warmup_pct=0.2, img_size=list(kw['img_size']),
                      hidden_size=kw['hidden_size']),
        'data': dict(root_dir=str(tmp_path / 'data'), train_dir='real', num_workers=0,
                     augment=False, batch_size=4),
        'trainer': dict(max_epochs=1, val_check_interval=1, gradient_clip_val=20, devices=1,
                        swa=True, swa_epoch_start=0.0, microbatches=1),
        'pretrained': str(tmp_path / 'crnn.pt'),
    }
    jtrain(config, str(tmp_path / 'jax'), compute_dtype=jnp.float32, max_steps=1)
    train(config, tmp_path / 'port', compute_dtype=torch.float32, max_steps=1, device='cpu')

    jval, tval = ([m for m in map(json.loads, open(tmp_path / run / 'metrics.jsonl'))
                   if 'val_loss' in m] for run in ('jax', 'port'))
    assert len(jval) == len(tval) == 1
    np.testing.assert_allclose(tval[0]['val_loss'], jval[0]['val_loss'], atol=1e-5)
    for key in ('val_accuracy', 'val_NED', 'val_confidence'):
        np.testing.assert_allclose(tval[0][key], jval[0][key], atol=1e-4, err_msg=key)

    jtree, _, _ = load_checkpoint(tmp_path / 'jax' / 'checkpoints' / 'swa.ckpt')
    want = _state_dict('crnn', jtree['params'], jtree['stats'], kw)
    got = torch.load(tmp_path / 'port' / 'checkpoints' / 'swa.ckpt',
                     weights_only=True)['state_dict']
    moved = 0
    for name, buf in model.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=name)
            moved += not torch.allclose(got[name], buf)
    assert moved  # the re-estimation moved the statistics
