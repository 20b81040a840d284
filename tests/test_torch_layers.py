"""Port layers (parseq_tpu_torch.ops.layers) against parseq_tpu.ops.layers.

Inputs come from numpy with a seed; JAX params (right-multiply layout) are
transposed into the port's torch layout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.ops import layers as jl
from parseq_tpu_torch.ops import layers as tl

RNG_SEED = 0
# f32: both sides compute the same sums in f32 in a different order.
# bf16: outputs of magnitude up to ~4 carry one or two bf16 roundings
# (2^-8 relative each), which the two frameworks place differently.
TOL = {'f32': 1e-5, 'bf16': 5e-2}

_JDT = {'f32': jnp.float32, 'bf16': jnp.bfloat16}
_TDT = {'f32': torch.float32, 'bf16': torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _both(a, dt):
    return jnp.asarray(a, _JDT[dt]), torch.from_numpy(a).to(_TDT[dt])


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_linear(dt):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = (0.2 * rng.standard_normal((16, 24))).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jx, tx = _both(x, dt)
    want = jl.linear({'w': jnp.asarray(w), 'b': jnp.asarray(b)}, jx)
    got = tl.linear(tx, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.dtype == _TDT[dt]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt])


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_layer_norm(dt):
    rng = np.random.default_rng(RNG_SEED + 1)
    x = (3.0 + 2.0 * rng.standard_normal((4, 7, 32))).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jx, tx = _both(x, dt)
    want = jl.layer_norm({'scale': jnp.asarray(g), 'bias': jnp.asarray(b)}, jx)
    got = tl.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == _TDT[dt]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt])


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_gelu(dt):
    """Exact erf form at f32, tanh form at bf16, on both sides."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    jx, tx = _both(x, dt)
    np.testing.assert_allclose(_np(tl.gelu(tx)), _np(jl.gelu(jx)),
                               atol=TOL[dt])


def test_bool_to_bias_and_embedding():
    rng = np.random.default_rng(RNG_SEED + 2)
    mask = rng.random((3, 9)) > 0.5
    np.testing.assert_array_equal(tl.bool_to_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jl.bool_to_bias(jnp.asarray(mask))))
    w = rng.standard_normal((11, 8)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 5))
    np.testing.assert_array_equal(
        tl.embedding(torch.from_numpy(ids), torch.from_numpy(w)).numpy(),
        np.asarray(jl.embedding({'w': jnp.asarray(w)}, jnp.asarray(ids))))


@pytest.mark.parametrize('case', ['plain', 'causal', 'causal_padding', 'cross'])
def test_mha(case):
    rng = np.random.default_rng(RNG_SEED + 3)
    B, Lq, Lk, D, h = 2, 6, 6 if case != 'cross' else 9, 24, 4
    q = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = q if case != 'cross' else rng.standard_normal((B, Lk, D)).astype(np.float32)
    p = {n: {'w': (0.3 * rng.standard_normal((D, D))).astype(np.float32),
             'b': (0.1 * rng.standard_normal(D)).astype(np.float32)} for n in ('q', 'k', 'v', 'out')}
    bias = None
    if case.startswith('causal'):
        bias = np.where(np.triu(np.ones((Lq, Lk), bool), 1), jl.NEG_INF, 0.0).astype(np.float32)
    kpm = None
    if case == 'causal_padding':
        kpm = np.zeros((B, Lk), bool)
        kpm[0, -2:] = True
    want = jl.mha(jax_tree(p), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=h,
                  attn_bias=None if bias is None else jnp.asarray(bias),
                  key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    in_w = torch.from_numpy(np.concatenate([p[n]['w'].T for n in 'qkv']))
    in_b = torch.from_numpy(np.concatenate([p[n]['b'] for n in 'qkv']))
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    got = tl.mha(tq, tkv, tkv, in_w, in_b, torch.from_numpy(p['out']['w'].T.copy()),
                 torch.from_numpy(p['out']['b']), num_heads=h,
                 attn_bias=None if bias is None else torch.from_numpy(bias),
                 key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL['f32'])


def test_mlp():
    rng = np.random.default_rng(RNG_SEED + 4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {'fc1': {'w': (0.3 * rng.standard_normal((16, 64))).astype(np.float32),
                 'b': rng.standard_normal(64).astype(np.float32)},
         'fc2': {'w': (0.3 * rng.standard_normal((64, 16))).astype(np.float32),
                 'b': rng.standard_normal(16).astype(np.float32)}}
    want = jl.mlp(jax_tree(p), jnp.asarray(x))
    got = tl.mlp(torch.from_numpy(x), *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        p['fc1']['w'].T, p['fc1']['b'], p['fc2']['w'].T, p['fc2']['b'])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL['f32'])


def jax_tree(p):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in p.items()}
