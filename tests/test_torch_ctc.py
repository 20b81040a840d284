"""The port's train-mode batch norm (ops/cnn.py) and CTC loss (ops/ctc.py)
against the JAX package's on the CPU, inputs drawn from numpy with a seed."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from parseq_tpu.ops import cnn as jcnn
from parseq_tpu.ops import ctc as jctc
from parseq_tpu_torch.ops import cnn as tcnn
from parseq_tpu_torch.ops import ctc as tctc

BN_ATOL = 1e-6  # f32 output and new statistics
CTC_ATOL = 1e-5  # loss and its gradient with respect to log_probs


def _bn_pair(C, rng):
    scale, bias = rng.uniform(0.5, 1.5, C), rng.normal(0, 0.1, C)
    mean, var = rng.normal(0, 0.1, C), rng.uniform(0.5, 1.5, C)
    bn = nn.BatchNorm2d(C).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    p = {'scale': jnp.asarray(scale, jnp.float32), 'bias': jnp.asarray(bias, jnp.float32)}
    s = {'mean': jnp.asarray(mean, jnp.float32), 'var': jnp.asarray(var, jnp.float32)}
    return bn, p, s


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_train_batchnorm_matches_jax(dtype):
    """Batch statistics (biased variance) normalize; the running ones move by
    momentum 0.1 with the unbiased variance; the result is cast to x's dtype
    (bf16: within one bf16 ulp of the largest output)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 0.5).astype(np.float32)
    bn, p, s = _bn_pair(5, rng)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype)
    want, new = jcnn.batchnorm(p, s, jx, train=True)
    got = tcnn.batchnorm(torch.from_numpy(x).to(getattr(torch, dtype)), bn)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    atol = BN_ATOL if dtype == 'float32' else np.abs(want).max() * 2.0 ** -8
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=atol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new['mean']), atol=BN_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new['var']), atol=BN_ATOL)


def test_eval_batchnorm_keeps_running_statistics():
    rng = np.random.default_rng(1)
    bn, p, s = _bn_pair(4, rng)
    bn.eval()
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    before = bn.running_var.clone()
    got = tcnn.batchnorm(torch.from_numpy(x), bn)
    want, _ = jcnn.batchnorm(p, s, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               atol=BN_ATOL)
    assert torch.equal(bn.running_var, before)


def test_train_batchnorm_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    bn, p, s = _bn_pair(3, rng)
    xt = torch.from_numpy(x).requires_grad_()
    (tcnn.batchnorm(xt, bn) * torch.from_numpy(g)).sum().backward()

    def f(xx, pp):
        y, _ = jcnn.batchnorm(pp, s, xx.transpose(0, 2, 3, 1), train=True)
        return (y.transpose(0, 3, 1, 2) * g).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), p)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp['scale']), atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp['bias']), atol=1e-5)


def _ctc_inputs(seed, T=8, C=6):
    """Log-probabilities (a log_softmax, then perturbed: the gradient must be
    the true one for any log_probs), padded targets with an empty one and a
    run of repeats."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((5, T, C)).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    lp = (lp + rng.standard_normal(lp.shape) * 0.1).astype(np.float32)
    targets = rng.integers(1, C, (5, 4)).astype(np.int32)
    targets[2] = 2  # repeats need blanks between them
    lengths = np.array([3, 0, 4, 2, 4], np.int32)
    return lp, targets, lengths


def _both(lp, targets, lengths, reduction):
    def jf(x):
        return jctc.ctc_loss(x, jnp.asarray(targets), jnp.asarray(lengths), reduction=reduction)

    want, jgrad = jf(jnp.asarray(lp)), jax.grad(lambda x: jf(x).sum())(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    got = tctc.ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(lengths),
                        reduction=reduction)
    (grad,) = torch.autograd.grad(got.sum(), x)
    return got.detach().numpy(), np.asarray(want), grad.numpy(), np.asarray(jgrad)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
def test_ctc_loss_and_gradient_match_jax(reduction):
    got, want, grad, jgrad = _both(*_ctc_inputs(0), reduction)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=CTC_ATOL)
    np.testing.assert_allclose(grad, jgrad, atol=CTC_ATOL)


def test_ctc_infeasible_target_is_zeroed():
    """T = 3 cannot emit 'aab' (a blank must separate the a's): its loss and
    gradient are 0, as the other rows' are not."""
    lp, _, _ = _ctc_inputs(1, T=3)
    targets = np.array([[1, 1, 2, 0]] * 5, np.int32)
    lengths = np.array([3, 1, 2, 0, 3], np.int32)
    got, want, grad, jgrad = _both(lp, targets, lengths, 'none')
    np.testing.assert_allclose(got, want, atol=CTC_ATOL)
    np.testing.assert_allclose(grad, jgrad, atol=CTC_ATOL)
    assert got[0] == 0 and got[4] == 0 and (got[1:4] > 0).all()
    assert not grad[0].any() and grad[1].any()


def test_ctc_empty_target_is_the_all_blank_path():
    lp, _, _ = _ctc_inputs(2)
    got, want, _, _ = _both(lp[:1], np.zeros((1, 4), np.int32), np.zeros(1, np.int32), 'none')
    np.testing.assert_allclose(got, -lp[0, :, 0].sum(), atol=CTC_ATOL)
    np.testing.assert_allclose(got, want, atol=CTC_ATOL)


def test_greedy_decode_ids_matches_jax():
    logits = np.random.default_rng(3).standard_normal((2, 7, 5)).astype(np.float32)
    np.testing.assert_array_equal(tctc.greedy_decode_ids(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jctc.greedy_decode_ids(jnp.asarray(logits))))
