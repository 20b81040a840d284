"""Port PARSeq inference against parseq_tpu.models.parseq at f32.

Same small config as tests/test_parseq_parity.py (dec_depth=2 exercises the
content-stream update), JAX params from parseq.init, port weights through
state_dict_from_jax, NHWC images from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.data import Tokenizer
from parseq_tpu.models import parseq as jparseq
from parseq_tpu.ops.layers import bool_to_bias
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.ops import ar_kernel
from parseq_tpu_torch.utils.convert import state_dict_from_jax

# f32 on both sides; the decoder output passes 3 encoder blocks and two
# two-stream layers, summed in another order (the JAX parity tests' bound).
ATOL = 2e-3
# Greedy picks must agree wherever the top-2 margin exceeds this.
MARGIN = 0.05

KW = dict(num_tokens=13, max_label_length=7, img_size=(32, 64), patch_size=(4, 8),
          embed_dim=48, enc_num_heads=4, enc_mlp_ratio=4.0, enc_depth=3,
          dec_num_heads=6, dec_mlp_ratio=4.0, dec_depth=2)


def _pair(kw, key=0):
    params = jparseq.init(jax.random.key(key), jparseq.PARSeqConfig(**kw))
    model = PARSeq(PARSeqConfig(**kw)).eval()
    model.load_state_dict(state_dict_from_jax(params, kw.get('patch_size', (4, 8))), strict=True)
    return params, model


@pytest.fixture(scope='module')
def pair():
    return _pair(KW)


@pytest.fixture(scope='module')
def images():
    return np.random.default_rng(0).standard_normal((2, 32, 64, 3)).astype(np.float32)


def _assert_close(got, want, atol=ATOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    top2 = np.sort(want, -1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[confident], want.argmax(-1)[confident])


@pytest.mark.parametrize('mode', ['nar', 'ar', 'ar_refine'])
def test_forward_matches_jax(pair, images, mode):
    params, base = pair
    kw = {**KW, 'decode_ar': mode != 'nar', 'refine_iters': 2 if mode == 'ar_refine' else 0}
    model = PARSeq(PARSeqConfig(**kw)).eval()
    model.load_state_dict(base.state_dict(), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    want = np.asarray(jparseq.forward(params, jparseq.PARSeqConfig(**kw), jnp.asarray(images)))
    assert got.shape == (2, model.cfg.num_steps, model.cfg.num_classes)
    _assert_close(got, want)


def test_decode_with_masks_matches_jax(pair, images):
    params, model = pair
    cfg = jparseq.PARSeqConfig(**KW)
    rng = np.random.default_rng(1)
    B, n = 2, cfg.num_steps
    tgt = rng.integers(0, cfg.num_tokens - 2, size=(B, n))
    tgt[:, 0] = cfg.bos_id
    causal = np.triu(np.ones((n, n), bool), 1)
    pad = np.zeros((B, n), bool)
    pad[0, -2:] = True
    memory = jparseq.encode(params, cfg, jnp.asarray(images))
    want = jparseq.head(params, jparseq.decode(
        params, cfg, jnp.asarray(tgt, jnp.int32), memory,
        content_bias=bool_to_bias(jnp.asarray(causal)), padding_mask=jnp.asarray(pad)))
    from parseq_tpu_torch.ops.layers import bool_to_bias as t_bool_to_bias

    with torch.no_grad():
        mem_t = model.encode(torch.from_numpy(images))
        got = model.decoder_head(model.decode(
            torch.from_numpy(tgt), mem_t, content_bias=t_bool_to_bias(torch.from_numpy(causal)),
            padding_mask=torch.from_numpy(pad)))
    _assert_close(got.numpy(), np.asarray(want), atol=5e-4)


def test_early_exit_reads_the_same_strings(pair, images):
    """Early exit (batch stops once every row emitted EOS) against the JAX
    early-exit decode and the port's full scan."""
    params, model = pair
    cfg = jparseq.PARSeqConfig(**KW)
    tok = Tokenizer('0123456789')
    memory = jparseq.encode(params, cfg, jnp.asarray(images))
    want = jparseq.ar_decode(params, cfg, memory, early_exit=True)
    with torch.no_grad():
        mem_t = torch.from_numpy(np.array(memory))
        early = model.ar_decode(mem_t, early_exit=True)
        full = model.ar_decode(mem_t)
    labels = [tok.decode(torch.softmax(x, -1).numpy())[0] for x in (early, full)]
    assert labels[0] == labels[1] == tok.decode(np.asarray(jax.nn.softmax(want, -1)))[0]


def test_cpu_forward_runs_the_scan(pair, images):
    """On a CPU tensor forward never launches the fused kernel."""
    _, model = pair
    before = ar_kernel.launches
    with torch.no_grad():
        model(torch.from_numpy(images))
    assert ar_kernel.launches == before


def test_full_parseq_s_width_matches_jax():
    """PARSeq-S widths (D=384, 6/12 heads, 97 tokens, 26 steps, 32x128,
    AR + 1 refine) at batch 2; encoder depth cut to 2 to keep the CPU test
    short (depth repeats identical blocks)."""
    kw = dataclasses.asdict(PARSeqConfig())
    kw['enc_depth'] = 2
    params, model = _pair(kw, key=5)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jparseq.forward(params, jparseq.PARSeqConfig(**kw), jnp.asarray(x)))
    assert got.shape == (2, 26, 95)
    _assert_close(got, want)
