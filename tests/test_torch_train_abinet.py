"""The port's ABINet training on the CPU against the JAX package: one train
step of pretraining and of the language model alone (lm_only) at
microbatches 1 and 2, held as tests/test_torch_train_families.py holds the
other families; lm_only moving the language model alone; the optimizer's
two schedules. The joint stage is in tests/test_torch_train_abinet_joint.py."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.train import optim as joptim
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import init_state, make_train_step

from .test_torch_train_families import (B, L_LR, OCFG, _batches, _setup, check_train_step,
                                        one_torch_thread)  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('static', [{'pretraining': True}, {'lm_only': True}],
                         ids=['pretraining', 'lm_only'])
def test_train_step_matches_jax(static, microbatches):
    check_train_step('abinet', static, microbatches)


def test_lm_only_leaves_vision_and_alignment():
    """ABINet's lm_only step moves the language model alone: no other
    parameter and no batch-norm statistic changes."""
    jcfg, _, _, model, jtok, ttok, _ = _setup('abinet')
    _, tbatch = _batches('abinet', jcfg, model, jtok, ttok)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_state(model, optim.OptimConfig(**OCFG))
    make_train_step(get_family('abinet'), model.cfg, torch.float32, lm_only=True)(
        state, tbatch, None)
    after = model.state_dict()
    for k, v in after.items():
        assert k.startswith('language.') or torch.equal(v, before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in after if k.startswith('language.'))


def test_abinet_optimizer_schedules_match_jax():
    """Per-group LR of 20 steps: `language.*` on the OneCycle of l_lr until
    pretrain_end, then the main one; everything else on the main one. Held
    against make_abinet_optimizer's schedules (f32 values, so rtol 1e-5) and
    against its updates of the same gradients."""
    cfg = dict(lr=3e-3, total_steps=20, batch_size=B, warmup_pct=0.2, swa=True,
               swa_epoch_start=0.75)
    rng = np.random.default_rng(0)
    shapes = {'language': (3, 4), 'vision': (5,), 'alignment': (2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: {'w': jnp.asarray(v)} for k, v in init.items()}
    tx, jmain = joptim.make_abinet_optimizer(joptim.OptimConfig(**cfg), L_LR, 9, jparams)
    jl = joptim.onecycle_schedule(joptim.OptimConfig(**dict(cfg, lr=L_LR)))
    jopt = tx.init(jparams)
    tparams = [torch.from_numpy(v.copy()) for v in init.values()]
    opt = optim.make_abinet_optimizer([(f'{k}.w', p) for k, p in zip(init, tparams)],
                                      optim.OptimConfig(**cfg), L_LR, 9)
    sched_of = {n: s for s, idx in opt.groups.items() for n in idx}
    for k in range(20):
        want_l = float(jl(k)) if k < 9 else float(jmain(k))
        np.testing.assert_allclose(sched_of[0](opt.count), want_l, rtol=1e-5, err_msg=k)
        for i in (1, 2):
            np.testing.assert_allclose(sched_of[i](opt.count), float(jmain(k)), rtol=1e-5)
        grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        upd, jopt = tx.update({n: {'w': jnp.asarray(g)} for n, g in grads.items()}, jopt,
                              jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step(tparams, [torch.from_numpy(g) for g in grads.values()])
        for n, p in zip(init, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[n]['w']), rtol=1e-5,
                                       atol=1e-7, err_msg=f'{n} step {k}')
