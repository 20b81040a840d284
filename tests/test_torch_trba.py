"""Port TRBA / TRBC inference against parseq_tpu (ops/grid_sample.py,
models/trba.py) at f32 on the CPU.

The JAX package's default grid sample is a one-hot matmul, a TPU layout
workaround; its semantics-defining path is `_grid_sample_gather`, and the
port is held against that: the model comparisons run JAX's trba with
`grid_sample` monkeypatched to the gather path (the JAX package itself is
unchanged). JAX params from trba.init, with the localization head's weights
and every batch-norm statistic and affine parameter redrawn from numpy so
the TPS grid depends on the image and each mapping is exercised.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.models import trba as jtrba
from parseq_tpu.ops import grid_sample as jgrid
from parseq_tpu_torch.models import trba as ttrba
from parseq_tpu_torch.ops.grid_sample import grid_sample
from parseq_tpu_torch.utils.convert import trba_state_dict_from_jax

# f32 both sides; sums in another order through the localization CNN, the
# TPS solve, 32 ResNet layers and 2 x 2 LSTM directions. Greedy picks must be
# equal, so both sides decode the same ids.
GRID_ATOL = 1e-5
TPS_ATOL = 1e-4
LOGITS_ATOL = 1e-4
KW = dict(num_tokens=15, max_label_length=6, img_size=(32, 64), num_fiducial=6,
          output_channel=32, hidden_size=16, num_char_embeddings=16)


@pytest.fixture
def gather_grid_sample(monkeypatch):
    monkeypatch.setattr(jtrba, 'grid_sample', jgrid._grid_sample_gather)


def test_grid_sample_matches_jax_gather():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    grid = (rng.random((2, 5, 7, 2)) * 2.4 - 1.2).astype(np.float32)  # with out-of-bounds
    grid[0, 0, 0] = (1.0, 1.0)  # the far corner exactly
    want = jgrid._grid_sample_gather(jnp.asarray(images), jnp.asarray(grid))
    got = grid_sample(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                      torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=GRID_ATOL)


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


def _pair(use_ctc, seed):
    kw = dict(KW, use_ctc=use_ctc, num_tokens=13 if use_ctc else 15)
    cfg = jtrba.TRBAConfig(**kw)
    params, stats = jtrba.init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    params, stats = _redraw(params, rng), _redraw(stats, rng)
    fc2 = params['loc']['fc2']
    params['loc']['fc2'] = dict(fc2, w=jnp.asarray(rng.normal(0, 0.05, fc2['w'].shape),
                                                   jnp.float32))
    model = ttrba.TRBA(ttrba.TRBAConfig(**kw)).eval()
    model.load_state_dict(trba_state_dict_from_jax(params, stats, use_ctc=use_ctc), strict=True)
    images = np.random.default_rng(seed + 1).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    return cfg, params, stats, model, images


@pytest.fixture(scope='module')
def trba_pair():
    return _pair(False, 3)


def test_tps_matches_jax(trba_pair, gather_grid_sample):
    cfg, params, stats, model, images = trba_pair
    want, _ = jtrba.tps(params['loc'], stats['loc'], cfg, jnp.asarray(images),
                        jtrba.tps_constants(cfg))
    with torch.no_grad():
        got = model.tps(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=TPS_ATOL)
    # the grid depends on the image: the two rectified images are not one warp
    assert float(np.abs(np.asarray(want) - jnp.asarray(images)).max()) > 1e-2


def test_trba_greedy_logits_match_jax(trba_pair, gather_grid_sample):
    cfg, params, stats, model, images = trba_pair
    want, _ = jtrba.forward(params, stats, cfg, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.shape == want.shape == (2, cfg.num_steps, cfg.num_tokens)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)


def test_trba_teacher_forced_logits_match_jax(trba_pair, gather_grid_sample):
    """`text` feeds step t its id; fed the greedy picks, it gives the greedy
    logits back."""
    cfg, params, stats, model, images = trba_pair
    text = np.random.default_rng(7).integers(0, cfg.num_tokens, (2, cfg.num_steps))
    want, _ = jtrba.forward(params, stats, cfg, jnp.asarray(images), text=jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(images), text=torch.from_numpy(text))
        greedy = model(torch.from_numpy(images))
        ids = torch.cat([torch.full((2, 1), cfg.bos_id), greedy.argmax(-1)[:, :-1]], dim=1)
        refed = model(torch.from_numpy(images), text=ids)
    assert got.shape == want.shape == (2, cfg.num_steps, cfg.num_tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    assert float((got - greedy).abs().max()) > 10 * LOGITS_ATOL  # the ids were fed
    np.testing.assert_allclose(refed.numpy(), greedy.numpy(), atol=1e-6)


def test_trbc_logits_match_jax(gather_grid_sample):
    cfg, params, stats, model, images = _pair(True, 5)
    want, _ = jtrba.forward(params, stats, cfg, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 64 // 4 + 1, cfg.num_tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)


@pytest.mark.parametrize('with_buffers', [False, True])
def test_state_dict_loads_with_and_without_grid_buffers(trba_pair, with_buffers):
    """The reference's GridGenerator keeps inv_delta_C and P_hat as buffers,
    so a released TRBA file may carry them; the JAX converter's state_dict
    does not. Both load strict=True and read alike."""
    cfg, params, stats, model, images = trba_pair
    sd = trba_state_dict_from_jax(params, stats)
    assert not any('GridGenerator' in k for k in sd)
    if with_buffers:  # as the reference builds them: float64 numpy -> float32 tensor
        C = jtrba._build_C(cfg.num_fiducial)
        sd['Transformation.GridGenerator.inv_delta_C'] = torch.tensor(
            jtrba._build_inv_delta_C(cfg.num_fiducial, C)).float()
        sd['Transformation.GridGenerator.P_hat'] = torch.tensor(jtrba._build_P_hat(
            cfg.num_fiducial, C, jtrba._build_P(cfg.img_size[1], cfg.img_size[0]))).float()
    fresh = ttrba.TRBA(model.cfg).eval()
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    gg = fresh.Transformation.GridGenerator
    want_inv, want_p_hat = (np.asarray(c) for c in jtrba.tps_constants(cfg))
    np.testing.assert_array_equal(gg.inv_delta_C.numpy(), want_inv)
    np.testing.assert_array_equal(gg.P_hat.numpy(), want_p_hat)
    assert {'Transformation.GridGenerator.inv_delta_C',
            'Transformation.GridGenerator.P_hat'} <= set(fresh.state_dict())
    with torch.no_grad():
        x = torch.from_numpy(images)
        np.testing.assert_array_equal(fresh(x).numpy(), model(x).numpy())
    if with_buffers:  # loaded buffers are the ones used
        sd['Transformation.GridGenerator.P_hat'] = sd['Transformation.GridGenerator.P_hat'] * 0.5
        fresh.load_state_dict(sd, strict=True)
        assert torch.equal(gg.P_hat, sd['Transformation.GridGenerator.P_hat'])
