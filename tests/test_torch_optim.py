"""The port's optimizer, schedule and SWA average against
parseq_tpu.train.optim (optax) on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.models import parseq as jparseq
from parseq_tpu.train import optim as joptim
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.utils.convert import state_dict_from_jax

# optax evaluates the schedule in f32, the port in Python floats: near the
# end of the cosine f32's cos(pi * pct) + 1 cancels, so the bound is relative
# plus a floor of 1e-6 of the peak LR.
SCHED_RTOL = 1e-6
# Five f32 AdamW steps; the update order matches optax's, the clip factor is
# applied as one multiply (optax divides, then multiplies).
PARAM_ATOL = 2e-7


@pytest.mark.parametrize('total', [2, 3, 5, 13, 100, 1000])
@pytest.mark.parametrize('swa', [False, True])
@pytest.mark.parametrize('warmup', [0.075, 0.3])
def test_schedule_matches_jax_at_every_step(total, swa, warmup):
    kw = dict(lr=7e-4, total_steps=total, swa=swa, warmup_pct=warmup, batch_size=384)
    want_fn = joptim.onecycle_schedule(joptim.OptimConfig(**kw))
    got_fn = optim.onecycle_schedule(optim.OptimConfig(**kw))
    steps = range(total + 3)
    want = np.asarray([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.asarray([got_fn(s) for s in steps])
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL,
                               atol=SCHED_RTOL * optim.scaled_lr(optim.OptimConfig(**kw)))


def test_scaled_and_swa_lr_match_jax():
    for kw in (dict(), dict(lr=1e-3, accum=2, num_devices=4, batch_size=96),
               dict(swa_epoch_start=0.5, warmup_pct=0.1)):
        assert (optim.scaled_lr(optim.OptimConfig(**kw))
                == joptim.scaled_lr(joptim.OptimConfig(**kw)))
        assert optim.swa_lr(optim.OptimConfig(**kw)) == pytest.approx(
            joptim.swa_lr(joptim.OptimConfig(**kw)), rel=1e-12)


@pytest.fixture(scope='module')
def small_parseq():
    kw = dict(num_tokens=13, max_label_length=5, img_size=(16, 32), embed_dim=32,
              enc_num_heads=2, enc_depth=1, dec_num_heads=4)
    params = jparseq.init(jax.random.key(0), jparseq.PARSeqConfig(**kw))
    model = PARSeq(PARSeqConfig(**kw))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model


def test_no_decay_mask_matches_jax(small_parseq):
    """The rule on the port's parameter names: >= 2-D weights decay, except
    the embedding and positional tables. (The JAX package applies it to its
    own tree, whose encoder blocks are stacked over depth, so there the
    encoder's LayerNorm scales and biases are 2-D and decay; the port follows
    the reference's per-parameter rule.)"""
    _, model = small_parseq
    named = list(model.named_parameters())
    want = joptim._no_decay_mask({n: jnp.asarray(p.detach().numpy()) for n, p in named})
    got = dict(zip((n for n, _ in named), optim.decay_mask(named)))
    assert got == want
    assert not got['text_embed.embedding.weight'] and not got['pos_queries']
    assert not got['encoder.pos_embed'] and not got['head.bias'] and got['head.weight']
    assert not got['encoder.blocks.0.norm1.weight'] and got['encoder.blocks.0.attn.qkv.weight']


@pytest.mark.parametrize('weight_decay,clip', [(0.0, 20.0), (0.01, 20.0), (0.05, 0.5)])
def test_adamw_steps_match_optax(small_parseq, weight_decay, clip):
    """Five AdamW + global-norm-clip steps on identical numpy gradients
    (clip 0.5 engages the clip on every step); the optax chain runs on a
    tree keyed by the port's parameter names."""
    _, model = small_parseq
    cfg_kw = dict(lr=3e-3, total_steps=20, weight_decay=weight_decay, grad_clip=clip,
                  batch_size=256, warmup_pct=0.2)
    tparams = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = list(tparams)
    jp = {n: jnp.asarray(p.numpy()) for n, p in tparams.items()}
    tx, _ = joptim.make_optimizer(joptim.OptimConfig(**cfg_kw), jp)
    st = tx.init(jp)
    opt = optim.AdamW(list(tparams.items()), optim.OptimConfig(**cfg_kw))
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in tparams.items()}
        upd, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, jp)
        jp = {n: jp[n] + upd[n] for n in names}
        gnorm = opt.step([tparams[n] for n in names], [torch.from_numpy(g[n]) for n in names])
        want_norm = float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values())))
        assert float(gnorm) == pytest.approx(want_norm, rel=1e-5)
    for n in names:
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jp[n]), atol=PARAM_ATOL,
                                   err_msg=n)
    assert opt.count == 5


def test_swa_mean():
    rng = np.random.default_rng(0)
    snaps = [[torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal(5).astype(np.float32))] for _ in range(4)]
    st = optim.swa_init(snaps[0])
    jst = joptim.swa_init([jnp.asarray(p.numpy()) for p in snaps[0]])
    for s in snaps:
        optim.swa_update(st, s)
        jst = joptim.swa_update(jst, [jnp.asarray(p.numpy()) for p in s])
    assert st['n'] == int(jst['n']) == 4
    means = [torch.stack(c).mean(0) for c in zip(*snaps)]
    for got, want, mean in zip(st['avg'], jst['avg'], means):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
        torch.testing.assert_close(got, mean, rtol=0, atol=1e-6)


def test_optimizer_state_round_trip(small_parseq):
    _, model = small_parseq
    named = [(n, p.detach().clone()) for n, p in model.named_parameters()]
    opt = optim.AdamW(named, optim.OptimConfig(total_steps=10))
    ps = [p for _, p in named]
    opt.step(ps, [torch.ones_like(p) for p in ps])
    again = optim.AdamW(named, optim.OptimConfig(total_steps=10))
    again.load_state_dict(opt.state_dict())
    assert again.count == 1
    for a, b in zip(again.mu + again.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
