"""The training half of the port's PARSeq against parseq_tpu.models.parseq:
permutation sampling, permutation masks, the multi-permutation loss and its
gradients, and the validation loss, at f32 on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.data import Tokenizer
from parseq_tpu.models import parseq as jparseq
from parseq_tpu_torch.models import parseq as tparseq
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.utils.convert import state_dict_from_jax

# f32 on both sides; the loss passes an encoder and two decoder layers whose
# f32 sums are taken in another order (the bound of test_torch_parseq.py is
# 2e-3 on logits; a mean CE and its gradients move far less).
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4  # of each parameter's largest gradient

CHARSET = '0123456789'
KW = dict(num_tokens=len(CHARSET) + 3, max_label_length=7, img_size=(32, 64),
          patch_size=(4, 8), embed_dim=64, enc_num_heads=2, enc_mlp_ratio=4.0, enc_depth=2,
          dec_num_heads=4, dec_mlp_ratio=4.0, dec_depth=2, dropout=0.1)
# enc dh = 32 at L = 64: under autograd the encoder attention takes
# attention_flashbwd (kernel B4's plain backward on the CPU).


@pytest.fixture(scope='module')
def pair():
    params = jparseq.init(jax.random.key(0), jparseq.PARSeqConfig(**KW))
    model = PARSeq(PARSeqConfig(**KW))
    model.load_state_dict(state_dict_from_jax(params, KW['patch_size']), strict=True)
    return params, model


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    tgt = Tokenizer(CHARSET).encode(['0123', '9', '4567890'], KW['max_label_length'])
    perms = jparseq.gen_tgt_perms(np.random.default_rng(1), jparseq.PARSeqConfig(**KW))
    return images, tgt, perms


@pytest.mark.parametrize('max_len', [1, 3, 4, 5, 25])
@pytest.mark.parametrize('seed', [0, 1, 7])
@pytest.mark.parametrize('perm_num,mirrored,forward', [(6, True, True), (4, False, True),
                                                        (5, False, False)])
def test_gen_tgt_perms_equals_jax(max_len, seed, perm_num, mirrored, forward):
    kw = dict(max_label_length=max_len, perm_num=perm_num, perm_mirrored=mirrored,
              perm_forward=forward)
    want = jparseq.gen_tgt_perms(np.random.default_rng(seed), jparseq.PARSeqConfig(**kw))
    got = tparseq.gen_tgt_perms(np.random.default_rng(seed), PARSeqConfig(**kw))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('max_len', [3, 7, 25])
def test_perm_attn_masks_equal_jax(max_len):
    perms = jparseq.gen_tgt_perms(np.random.default_rng(max_len),
                                  jparseq.PARSeqConfig(max_label_length=max_len))
    want = jax.vmap(jparseq.perm_attn_masks)(jnp.asarray(perms))
    got = tparseq.perm_attn_masks(torch.from_numpy(perms))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one permutation at a time too
    for g, w in zip(tparseq.perm_attn_masks(torch.from_numpy(perms[2])), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w[2]))


def test_dropout_site_shapes_equal_jax():
    for depth in (1, 2, 3):
        kw = {**KW, 'dec_depth': depth}
        assert (tparseq.dropout_site_shapes(PARSeqConfig(**kw), 3, 8, 16)
                == jparseq.dropout_site_shapes(jparseq.PARSeqConfig(**kw), 3, 8, 16))


def _jax_grads_by_torch_name(params, grads_tree):
    """The JAX gradient tree mapped onto the port's parameter names (the
    conversion is linear, so it maps gradients as it maps weights)."""
    return state_dict_from_jax(grads_tree, KW['patch_size'])


def test_multi_perm_loss_and_grads_match_jax(pair, batch):
    """Dropout off (JAX rng=None): the loss and every parameter's gradient."""
    params, model = pair
    images, tgt, perms = batch
    cfg = jparseq.PARSeqConfig(**KW)

    def jloss(p):
        return jparseq.multi_perm_loss(p, cfg, jnp.asarray(images), jnp.asarray(tgt),
                                       jnp.asarray(perms))[0]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    _, want_numel = jparseq.multi_perm_loss(params, cfg, jnp.asarray(images), jnp.asarray(tgt),
                                            jnp.asarray(perms))
    model.zero_grad()
    loss, numel = model.multi_perm_loss(torch.from_numpy(images), torch.from_numpy(tgt),
                                        torch.from_numpy(perms))
    loss.backward()
    assert int(numel) == int(want_numel)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=LOSS_ATOL)
    want = _jax_grads_by_torch_name(params, want_grads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, (name, err, scale)


def test_multi_perm_loss_counts_eos_only_for_two_perms(pair, batch):
    """numel = K * (chars) + 2 * (EOS) for the batch: PAD never counts."""
    _, model = pair
    images, tgt, perms = batch
    with torch.no_grad():
        _, numel = model.multi_perm_loss(torch.from_numpy(images), torch.from_numpy(tgt),
                                         torch.from_numpy(perms))
    chars = sum(len(w) for w in ['0123', '9', '4567890'])
    assert int(numel) == len(perms) * chars + 2 * 3


@pytest.mark.parametrize('shared,u8', [(False, True), (False, False), (True, True)])
def test_multi_perm_loss_with_dropout(pair, batch, shared, u8):
    """With dropout the loss differs from the dropout-off loss, is finite,
    repeats for the same generator seed, and draws bits of the configured
    type: uint8 per permutation by default."""
    _, base = pair
    images, tgt, perms = batch
    model = PARSeq(dataclasses.replace(base.cfg, shared_perm_dropout=shared,
                                       bulk_bits_uint8=u8))
    model.load_state_dict(base.state_dict())
    args = (torch.from_numpy(images), torch.from_numpy(tgt), torch.from_numpy(perms))
    with torch.no_grad():
        off, _ = model.multi_perm_loss(*args)
        a, _ = model.multi_perm_loss(*args, rng=torch.Generator().manual_seed(3))
        b, _ = model.multi_perm_loss(*args, rng=torch.Generator().manual_seed(3))
    assert torch.isfinite(a) and float(a) == float(b) and float(a) != float(off)


def test_logits_loss_matches_jax(pair, batch):
    params, model = pair
    images, tgt, _ = batch
    cfg = jparseq.PARSeqConfig(**KW)
    want_logits, want_loss, want_numel = jparseq.logits_loss(params, cfg, jnp.asarray(images),
                                                             jnp.asarray(tgt))
    with torch.no_grad():
        logits, loss, numel = model.eval().logits_loss(torch.from_numpy(images),
                                                       torch.from_numpy(tgt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=2e-3)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4)
    assert int(numel) == int(want_numel)


def test_init_weights_follow_the_jax_schemes():
    """Random init for training from scratch: every parameter's spread and
    range as parseq.init draws them (xavier-uniform decoder q/k/v and out
    projections, truncated normal elsewhere)."""
    params = jparseq.init(jax.random.key(0), jparseq.PARSeqConfig(**KW))
    want = state_dict_from_jax(params, KW['patch_size'])
    model = PARSeq(PARSeqConfig(**KW))
    model.init_weights(torch.Generator().manual_seed(0))
    for name, got in model.state_dict().items():
        w = want[name]
        for stat in (lambda t: float(t.std()) if t.numel() > 1 else 0.0,
                     lambda t: float(t.abs().max())):
            a, b = stat(got), stat(w)
            assert abs(a - b) <= 0.15 * max(a, b) + 1e-12, (name, a, b)
