"""Port CRNN inference against parseq_tpu (ops/cnn.py max_pool2d, ops/rnn.py,
models/crnn.py) at f32 on the CPU.

JAX params from crnn.init with every batch-norm statistic and affine
parameter redrawn from numpy (so the mapping of each is exercised), port
weights through crnn_state_dict_from_jax, NHWC images from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.data.tokenizer import CTCTokenizer as JCTCTokenizer
from parseq_tpu.models import crnn as jcrnn
from parseq_tpu.ops import cnn as jcnn
from parseq_tpu.ops import rnn as jrnn
from parseq_tpu_torch.data.tokenizer import CTCTokenizer
from parseq_tpu_torch.models import crnn as tcrnn
from parseq_tpu_torch.ops import cnn as tcnn
from parseq_tpu_torch.ops import rnn as trnn
from parseq_tpu_torch.utils.convert import crnn_state_dict_from_jax

# f32 both sides; only the order of the sums differs (7 convolutions, then
# 2 x 2 LSTM directions over 17 steps).
LSTM_ATOL = 1e-5
LOGITS_ATOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('kernel,stride,padding', [
    ((2, 2), (2, 2), (0, 0)),
    ((2, 2), (2, 1), (0, 1)),
    ((3, 3), None, (1, 1)),
    ((2, 2), (2, 1), (1, 0)),
])
def test_max_pool2d_matches_jax(kernel, stride, padding):
    """torch MaxPool2d semantics (floor mode, -inf padding) on both sides,
    with odd sizes so floor mode drops a row or column."""
    x = np.random.default_rng(0).standard_normal((2, 9, 13, 5)).astype(np.float32)
    want = jcnn.max_pool2d(jnp.asarray(x), kernel, stride, padding)
    got = tcnn.max_pool2d(_nchw(x), kernel, stride, padding)
    np.testing.assert_array_equal(got.numpy(), _nchw(want).numpy())


def _jax_lstm(key, d, h):
    return jrnn.lstm_init(jax.random.key(key), d, h)


@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_matches_jax(reverse):
    p = _jax_lstm(1, 12, 16)
    x = np.random.default_rng(1).standard_normal((3, 7, 12)).astype(np.float32)
    want = jrnn.lstm(p, jnp.asarray(x), reverse=reverse)
    t = {k: torch.from_numpy(np.array(v).T.copy() if k.startswith('w') else np.array(v))
         for k, v in p.items()}
    got = trnn.lstm(torch.from_numpy(x), t['wih'], t['whh'], t['bih'], t['bhh'], reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LSTM_ATOL)


def test_bilstm_matches_jax_and_loads_reference_keys():
    p = jrnn.bilstm_init(jax.random.key(2), 12, 16, 10)
    x = np.random.default_rng(2).standard_normal((3, 7, 12)).astype(np.float32)
    want = jrnn.bilstm(p, jnp.asarray(x))
    module = trnn.BidirectionalLSTM(12, 16, 10)
    sd = {k.removeprefix('rnn.0.'): v
          for k, v in crnn_state_dict_from_jax({'cnn': [], 'rnn0': p, 'rnn1': p},
                                               {'bn': []}).items() if k.startswith('rnn.0.')}
    module.load_state_dict(sd, strict=True)
    assert 'rnn.weight_ih_l0_reverse' in sd
    got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=LSTM_ATOL)


def _random_stats(params, stats, seed):
    """Redraw batch-norm scales, biases and running statistics with numpy."""
    rng = np.random.default_rng(seed)
    convs = [dict(c) for c in params['cnn']]
    for c in convs:
        if 'bn' in c:
            c['bn'] = {'scale': jnp.asarray(rng.uniform(0.5, 1.5, c['bn']['scale'].shape),
                                            jnp.float32),
                       'bias': jnp.asarray(rng.normal(0, 0.1, c['bn']['bias'].shape), jnp.float32)}
    bn = [{'mean': jnp.asarray(rng.normal(0, 0.1, s['mean'].shape), jnp.float32),
           'var': jnp.asarray(rng.uniform(0.5, 1.5, s['var'].shape), jnp.float32)}
          for s in stats['bn']]
    return dict(params, cnn=convs), {'bn': bn}


@pytest.fixture(scope='module')
def crnn_pair():
    cfg = jcrnn.CRNNConfig(num_tokens=37, hidden_size=32, img_size=(32, 64))
    params, stats = _random_stats(*jcrnn.init(jax.random.key(3), cfg), seed=3)
    model = tcrnn.CRNN(tcrnn.CRNNConfig(num_tokens=37, hidden_size=32, img_size=(32, 64))).eval()
    model.load_state_dict(crnn_state_dict_from_jax(params, stats), strict=True)
    images = np.random.default_rng(4).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    return cfg, params, stats, model, images


def test_crnn_logits_and_reads_match_jax(crnn_pair):
    cfg, params, stats, model, images = crnn_pair
    want, _ = jcrnn.forward(params, stats, cfg, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 64 // 4 + 1, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    charset = '0123456789abcdefghijklmnopqrstuvwxyz'
    want_text, want_p = JCTCTokenizer(charset).decode(np.asarray(jax.nn.softmax(want, -1)))
    text, p = CTCTokenizer(charset).decode(torch.softmax(got, -1).numpy())
    assert text == want_text
    np.testing.assert_allclose(np.stack(p), np.stack(want_p), rtol=1e-4)


def test_crnn_leaky_relu_matches_jax():
    kw = dict(num_tokens=11, hidden_size=16, img_size=(32, 32), leaky_relu=True)
    cfg = jcrnn.CRNNConfig(**kw)
    params, stats = jcrnn.init(jax.random.key(5), cfg)
    model = tcrnn.CRNN(tcrnn.CRNNConfig(**kw)).eval()
    model.load_state_dict(crnn_state_dict_from_jax(params, stats), strict=True)
    images = np.random.default_rng(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want, _ = jcrnn.forward(params, stats, cfg, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
