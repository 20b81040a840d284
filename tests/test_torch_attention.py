"""Kernel B2 (fused no-split attention): the port's plain version against
the JAX Pallas kernel in interpret mode, the routing of
encoder_self_attention, the card check's inputs and limits against faults
planted in the plain version, and the CUDA kernel (bf16 and f32) against the
plain version on the card (marked `gpu`, skipped without one).

The GPU host has no jax, so jax is imported inside the fixture that needs
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest --noconftest -m gpu tests/test_torch_attention.py`).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops import attention, flash_bwd, layers, quant


@pytest.fixture(scope='module')
def jax_attention():
    pytest.importorskip('jax')
    from parseq_tpu.ops import attention as jattention

    return jattention


def _qkv(B, L, D, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D), dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize('B,L,h,D', [(4, 32, 4, 64), (3, 40, 2, 32),
                                     (2, 197, 6, 48),    # ViTSTR's odd L
                                     (2, 256, 8, 512)])  # ABINet vision encoder
def test_plain_matches_jax_kernel(jax_attention, B, L, h, D):
    """f32 both sides: only the order of the f32 sums differs (atol 1e-5,
    the bound of tests/test_fused_attention.py)."""
    import jax.numpy as jnp

    q, k, v = _qkv(B, L, D)
    scale = 1.0 / math.sqrt(D // h)
    want = jax_attention._pallas_attention_nosplit(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), h, scale, interpret=True)
    got = attention.fused_attention_nosplit_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_matches_jax_reference_in_bf16(jax_attention):
    """bf16 inputs: p and o are rounded to bf16 on both sides, sums taken in
    another order, so outputs may differ by a bf16 step (atol 2e-2)."""
    import jax.numpy as jnp

    q, k, v = _qkv(2, 197, 384, seed=3)
    want = jax_attention._reference_nosplit(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                            6, 0.125)
    got = attention.fused_attention_nosplit_reference(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), 6, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def test_packed_views_match_contiguous_operands():
    """q, k, v as column slices of one (B, L, 3D) tensor (row stride 3D)."""
    D = 96
    qkv = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 200, 3 * D),
                                                                    dtype=np.float32))
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    assert q.stride() == (200 * 3 * D, 3 * D, 1)
    got = attention.fused_attention_nosplit(q, k, v, 3, 0.2)
    want = attention.fused_attention_nosplit(q.contiguous(), k.contiguous(), v.contiguous(), 3,
                                             0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('route', ['kernel_branch', 'plain'])
def test_encoder_self_attention_matches_jax_mha(jax_attention, route):
    """At L = 197 >= KERNEL_MIN_LEN the CPU takes B2's plain version (or,
    inside kernels.plain(), layers.packed_self_attention of the packed
    projection); both equal JAX layers.mha at f32."""
    import jax
    import jax.numpy as jnp

    from parseq_tpu.ops import layers as jlayers

    B, L, D, h = 2, 197, 96, 3
    p = jlayers.mha_init(jax.random.key(0), D)
    x = np.random.default_rng(5).standard_normal((B, L, D)).astype(np.float32)
    want = np.asarray(jlayers.mha(p, *(jnp.asarray(x),) * 3, num_heads=h))
    w_in = torch.from_numpy(np.concatenate([np.asarray(p[n]['w']).T for n in 'qkv']))
    b_in = torch.from_numpy(np.concatenate([np.asarray(p[n]['b']) for n in 'qkv']))
    w_out = torch.from_numpy(np.asarray(p['out']['w']).T.copy())
    b_out = torch.from_numpy(np.array(p['out']['b']))
    args = (torch.from_numpy(x), w_in, b_in, w_out, b_out, h)
    before = attention.launches
    if route == 'plain':
        with kernels.plain():
            got = attention.encoder_self_attention(*args)
        assert attention.KERNEL_MIN_LEN == 192 and kernels.enabled()
        o = layers.packed_self_attention(layers.linear(args[0], w_in, b_in), h)
        torch.testing.assert_close(got, layers.linear(o, w_out, b_out), rtol=0, atol=0)
    else:
        got = attention.encoder_self_attention(*args)
    assert attention.launches == before  # no kernel launch for a CPU tensor
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


_B2_CASE = dict(L=197, heads=2, grad=False, plain=False, dropout=False, int8=False)


@pytest.mark.parametrize('change,route', [
    ({}, 'B2'),  # ViTSTR-S's and ABINet's reads
    ({'grad': True}, 'B2'),  # training at L >= KERNEL_MIN_LEN: B2 with its plain backward
    ({'int8': True}, 'B2'),  # the int8 serving path
    ({'plain': True}, 'packed'),
    ({'dropout': True}, 'mha'),  # no kernel drops attention probabilities
    ({'L': 24, 'grad': True}, 'B4'),  # PARSeq-S training (L = 128 there)
    ({'L': 24, 'grad': True, 'heads': 4}, 'packed'),  # dh 16: the kernel does not take it
    ({'L': 24, 'grad': True, 'plain': True}, 'packed'),
    ({'L': 20, 'grad': True}, 'packed'),  # L not a multiple of 8
    ({'L': 24}, 'packed'),  # inference below KERNEL_MIN_LEN
    ({'L': 24, 'int8': True}, 'packed'),
    ({'L': 24, 'grad': True, 'dropout': True}, 'mha'),
], ids=repr)
def test_encoder_self_attention_decision_table(monkeypatch, change, route):
    """encoder_self_attention's gates of B2 (L >= KERNEL_MIN_LEN) and B4
    (autograd, and a shape the backward kernel takes), both outside
    kernels.plain(), on one packed projection; layers.mha only for
    attention-probability dropout."""
    case = {**_B2_CASE, **change}
    calls = []

    def record(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    monkeypatch.setattr(attention, 'fused_attention_nosplit',
                        record('B2', attention.fused_attention_nosplit))
    monkeypatch.setattr(flash_bwd, 'attention_flashbwd',
                        record('B4', flash_bwd.attention_flashbwd))
    monkeypatch.setattr(layers, 'packed_self_attention',
                        record('packed', layers.packed_self_attention))
    monkeypatch.setattr(layers, 'mha', record('mha', layers.mha))
    L, D = case['L'], 64
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, L, D, generator=gen).requires_grad_(case['grad'])
    w = [torch.randn(s, generator=gen) * 0.1 for s in ((3 * D, D), (3 * D,), (D, D), (D,))]
    if case['int8']:
        w[0] = quant.Int8Weight(*quant.quantize_weight(w[0]))
    drop = dict(dropout_rate=0.1, rng=torch.Generator().manual_seed(1)) if case['dropout'] else {}
    with kernels.plain() if case['plain'] else contextlib.nullcontext():
        y = attention.encoder_self_attention(x, *w, case['heads'], **drop)
    assert calls == [route] and y.shape == x.shape


def test_other_devices_raise():
    t = torch.empty(1, 192, 64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        attention.fused_attention_nosplit(t, t, t, 1, 0.125)


# The card check's inputs and limits (attention.check_operands,
# CHECK_LIMITS), shared with chip_smoke.py, exercised on the CPU.
ATTEND = attention._attend


def _uniform(q, k, v, scale):
    p = torch.full((*q.shape[:-1], k.shape[-2]), 1.0 / k.shape[-2])
    return p.to(v.dtype) @ v


def _other_heads_keys(q, k, v, scale):
    return ATTEND(q, k.roll(1, dims=-3), v, scale)


def _last_8_keys_masked(q, k, v, scale):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s[..., -8:] = -math.inf
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


def _last_query_tile_dropped(q, k, v, scale):
    o = ATTEND(q, k, v, scale).clone()
    o[..., (q.shape[-2] - 1) // 16 * 16:, :] = 0
    return o


def _p_cast_before_normalising(q, k, v, scale):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return ((e.to(v.dtype) @ v).float() / e.sum(-1, keepdim=True)).to(v.dtype)


def _another_sum_order(q, k, v, scale):
    """What a correct kernel computes, with other roundings inside f32: f64
    sums rounded to f32, exp as ex2, p normalised by a multiply."""
    s = (q.double() @ k.double().transpose(-1, -2)).float() * scale
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * 1.4426950408889634)
    p = e * (1.0 / e.sum(-1, keepdim=True))
    return (p.to(v.dtype).double() @ v.double()).to(v.dtype)


def _check_case(layout, dtype=torch.bfloat16):
    """Operands and the plain version of B2 at ViTSTR's (2, 197, 6, 384) or of
    B3 at (12, 128, 64), drawn as the card check draws them."""
    gen = torch.Generator().manual_seed(7)
    if layout == 'B2':
        q, k, v = attention.check_operands(2, 197, 384, 64, 0.125, gen, dtype)
        return (q, k, v), lambda *t: attention.fused_attention_nosplit_reference(*t, 6, 0.125)
    q, k, v = attention.check_operands(12, 128, 64, 64, 0.125, gen, dtype)
    return (q, k, v), lambda *t: attention.fused_attention_reference(*t, 0.125)


def test_check_operands_spread_scores():
    """Scores of the check's inputs spread by about CHECK_SCORE_STD (N(0, 1)
    inputs at scale 0.125 spread them by 1, where softmax is near uniform);
    q, k, v are column views of one packed projection, in the given type."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = attention.check_operands(2, 197, 384, 64, 0.125, gen, torch.float32)
    assert q.dtype == torch.float32 and q.stride() == (197 * 3 * 384, 3 * 384, 1)
    assert k.data_ptr() == q.data_ptr() + 384 * 4 and v.data_ptr() == k.data_ptr() + 384 * 4
    qh, kh = (t.reshape(2, 197, 6, 64).transpose(1, 2) for t in (q, k))
    spread = float(((qh @ kh.transpose(-1, -2)) * 0.125).std(-1).mean())
    assert 0.9 * attention.CHECK_SCORE_STD < spread < 1.1 * attention.CHECK_SCORE_STD
    assert 0.95 < float(v.std()) < 1.05
    assert attention.check_operands(1, 5, 64, 64, 0.125, gen)[0].dtype == torch.bfloat16


@pytest.mark.parametrize('layout', ['B2', 'B3'])
@pytest.mark.parametrize('fault', [_uniform, _other_heads_keys, _last_8_keys_masked,
                                   _last_query_tile_dropped, _p_cast_before_normalising],
                         ids=lambda f: f.__name__[1:])
def test_check_limits_catch_planted_faults(monkeypatch, layout, fault):
    """A plain version with a planted fault fails the card check against the
    correct one, in bf16 at the shapes the check runs: by more than twice
    the max limit or twice the mean limit."""
    operands, plain = _check_case(layout)
    want = plain(*operands)
    monkeypatch.setattr(attention, '_attend', fault)
    bad = plain(*operands)
    rel_max, rel_mean = attention.check_errors(bad, want)
    limit_max, limit_mean = attention.CHECK_LIMITS[torch.bfloat16]
    print(f'{layout} {fault.__name__}: relative max {rel_max:.3e}, mean {rel_mean:.3e}')
    assert not attention.check_passes(bad, want)
    assert rel_max > 2 * limit_max or rel_mean > 2 * limit_mean


@pytest.mark.parametrize('layout', ['B2', 'B3'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
def test_check_limits_pass_another_sum_order(monkeypatch, layout, dtype):
    """The same function with other roundings inside f32 (what the kernel
    does) stays within a tenth of the limits."""
    operands, plain = _check_case(layout, dtype)
    want = plain(*operands)
    monkeypatch.setattr(attention, '_attend', _another_sum_order)
    got = plain(*operands)
    rel_max, rel_mean = attention.check_errors(got, want)
    limit_max, limit_mean = attention.CHECK_LIMITS[dtype]
    assert attention.check_passes(got, want)
    assert rel_mean <= limit_mean / 10 and rel_max <= limit_max


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


# Every length class of the kernel: 1 row, ragged single tiles, one and two
# warps' worth of key tiles, PARSeq-S's 128, the L >= 192 users and the
# longest the kernel takes.
GPU_LENGTHS = (1, 5, 16, 17, 128, 129, 196, 197, 256, 416)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('B,L,h', [(2, L, 6) for L in GPU_LENGTHS] + [(2, 256, 8), (1, 197, 6)])
def test_cuda_kernel_matches_plain(cuda_device, B, L, h, dtype):
    """Within CHECK_LIMITS of the plain version on the check's inputs, and
    strided (views of the packed projection) and contiguous operands give
    the same bits."""
    D = 64 * h
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    q, k, v = attention.check_operands(B, L, D, 64, 0.125, gen, dtype)
    before = attention.launches
    got = attention.fused_attention_nosplit(q, k, v, h, 0.125)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.shape == (B, L, D) and got.is_contiguous() and got.dtype == dtype
    want = attention.fused_attention_nosplit_reference(q, k, v, h, 0.125)
    assert attention.check_passes(got, want), attention.check_errors(got, want)
    same = attention.fused_attention_nosplit(q.contiguous(), k.contiguous(), v.contiguous(), h,
                                             0.125)
    assert torch.equal(got, same)


@pytest.mark.gpu
def test_cuda_kernel_rejects_other_operands(cuda_device):
    """bf16 or f32, all three of one type; dh = 64; scale > 0."""
    q, k, v = attention.check_operands(1, 197, 384, 64, 0.125,
                                       torch.Generator(device=cuda_device).manual_seed(0))
    with pytest.raises(ValueError, match='bf16 or f32'):
        attention.fused_attention_nosplit(q.half(), k.half(), v.half(), 6, 0.125)
    with pytest.raises(ValueError, match='must be'):
        attention.fused_attention_nosplit(q, k.float(), v, 6, 0.125)
    with pytest.raises(ValueError, match='D == 64'):
        attention.fused_attention_nosplit(q, k, v, 4, 0.125)
    with pytest.raises(ValueError, match='scale > 0'):
        attention.fused_attention_nosplit(q, k, v, 6, -0.125)
