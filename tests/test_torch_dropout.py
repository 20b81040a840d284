"""The port's dropout against parseq_tpu.ops.layers.dropout: the same numpy
bits give the same outputs; the uint8 rate quantization, rate >= 1 and the
uint8 limit below 1/512; attention-probability and MLP dropout sites."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.ops import layers as jlayers
from parseq_tpu_torch.ops import layers


def _x_and_bits(shape, bits_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    high = 256 if bits_dtype == np.uint8 else 65536
    return x, rng.integers(0, high, shape).astype(bits_dtype)


@pytest.mark.parametrize('rate', [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize('bits_dtype', [np.uint8, np.uint16])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_same_bits_same_output(rate, bits_dtype, dtype):
    x, bits = _x_and_bits((4, 7, 33), bits_dtype)
    want = jlayers.dropout(jnp.asarray(x, dtype), rate, jnp.asarray(bits))
    got = layers.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), rate,
                         torch.from_numpy(bits))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_uint8_rate_quantizes():
    """rate 0.1 drops where bits < 26 and scales survivors by 256/230."""
    x = torch.ones(256)
    bits = torch.arange(256, dtype=torch.uint8)
    y = layers.dropout(x, 0.1, bits)
    assert int((y == 0).sum()) == 26
    torch.testing.assert_close(y[26:], torch.full((230,), 256 / 230), rtol=0, atol=0)


def test_rate_one_and_zero():
    x = torch.randn(3, 5)
    bits = torch.zeros(3, 5, dtype=torch.uint8)
    assert torch.equal(layers.dropout(x, 1.0, bits), torch.zeros_like(x))
    assert torch.equal(layers.dropout(x, 1.5, torch.Generator()), torch.zeros_like(x))
    assert layers.dropout(x, 0.0, bits) is x
    assert layers.dropout(x, 0.3, None) is x


def test_uint8_below_1_over_512_raises():
    with pytest.raises(ValueError, match='uint8'):
        layers.dropout(torch.ones(4), 1 / 600, torch.zeros(4, dtype=torch.uint8))
    # the 16-bit path takes it
    y = layers.dropout(torch.ones(4), 1 / 600, torch.full((4,), 1000, dtype=torch.int32))
    torch.testing.assert_close(y, torch.full((4,), 1 / (1 - 1 / 600)))


def test_generator_draw_rate():
    """The keyed draw: 16-bit bits from the generator, empirical rate."""
    y = layers.dropout(torch.ones(200_000), 0.1, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.1) < 5e-3
    again = layers.dropout(torch.ones(200_000), 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_attention_and_mlp_dropout_sites_match_jax():
    """Probability dropout after the cast to the compute dtype, and the MLP
    hidden dropout, with the same uint8 bits on both sides (f32)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32) for _ in range(3))
    bits = rng.integers(0, 256, (2, 3, 5, 5)).astype(np.uint8)
    want = jlayers.attention(*(jnp.asarray(t) for t in (q, k, v)), dropout_rate=0.2,
                             rng=jnp.asarray(bits))
    got = layers.attention(*(torch.from_numpy(t) for t in (q, k, v)), dropout_rate=0.2,
                           rng=torch.from_numpy(bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    x = rng.standard_normal((4, 6)).astype(np.float32)
    w1 = rng.standard_normal((6, 12)).astype(np.float32)
    w2 = rng.standard_normal((12, 6)).astype(np.float32)
    hbits = rng.integers(0, 256, (4, 12)).astype(np.uint8)
    p = {'fc1': {'w': jnp.asarray(w1), 'b': jnp.zeros(12)},
         'fc2': {'w': jnp.asarray(w2), 'b': jnp.zeros(6)}}
    want = jlayers.mlp(p, jnp.asarray(x), dropout_rate=0.3, rng=jnp.asarray(hbits))
    got = layers.mlp(torch.from_numpy(x), torch.from_numpy(w1.T.copy()), torch.zeros(12),
                     torch.from_numpy(w2.T.copy()), torch.zeros(6), dropout_rate=0.3,
                     rng=torch.from_numpy(hbits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
