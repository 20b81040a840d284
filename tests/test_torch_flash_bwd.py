"""Kernel B4 (attention backward): the port's plain backward against the JAX
Pallas kernel in interpret mode, the autograd Function against plain
autograd, the encoder self-attention route under autograd, the kernel's
shape guard, and the CUDA kernel against the plain version on the card
(marked `gpu`, skipped without one).

The GPU host has no jax, so jax is imported inside the fixture that needs
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd.py`).
"""

import math

import numpy as np
import pytest
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops import attention, flash_bwd, layers

SHAPES = [(4, 3, 16, 8), (2, 6, 128, 64), (3, 2, 24, 16)]  # tests/test_flash_bwd.py


@pytest.fixture(scope='module')
def jax_flash_bwd():
    pytest.importorskip('jax')
    from parseq_tpu.ops import flash_bwd as jflash_bwd

    return jflash_bwd


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _pack(q, k, v):
    """(B, h, L, dh) x 3 -> packed (B, L, 3 h dh)."""
    B, h, L, dh = q.shape
    return torch.cat([t.transpose(1, 2).reshape(B, L, h * dh) for t in (q, k, v)], dim=-1)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_backward_matches_jax_kernel(jax_flash_bwd, shape):
    """f32 both sides; only the order of the f32 sums differs (5e-6, the
    bound of tests/test_flash_bwd.py)."""
    import jax
    import jax.numpy as jnp

    q, k, v, do = _inputs(shape)
    scale = 1.0 / math.sqrt(shape[-1])
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_bwd.attention_flashbwd(a, b, c, scale, True),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = flash_bwd.attention_flashbwd_backward_reference(
        *(torch.from_numpy(t) for t in (q, k, v, do)), scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-6)


@pytest.mark.parametrize('shape', SHAPES)
def test_autograd_function_matches_plain_autograd(shape):
    """attention_flashbwd on the packed projection: forward equal to the
    plain forward, gradients of the packed input equal to plain autograd."""
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(shape, seed=1))
    B, h, L, dh = shape
    scale = 1.0 / math.sqrt(dh)
    qkv = _pack(q, k, v).requires_grad_()
    out = flash_bwd.attention_flashbwd(qkv, h, scale)
    (grad,) = torch.autograd.grad(out.sin().sum(), qkv)

    qkv2 = qkv.detach().clone().requires_grad_()
    D = h * dh
    parts = [flash_bwd.split_heads(qkv2[..., i * D:(i + 1) * D], h) for i in range(3)]
    ref = flash_bwd.attention_forward_reference(*parts, scale).transpose(1, 2).reshape(B, L, D)
    (want,) = torch.autograd.grad(ref.sin().sum(), qkv2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(grad, want, rtol=0, atol=5e-6)
    assert grad.is_contiguous() and grad.shape == qkv.shape


def test_backward_writes_into_strided_views():
    """Operands and outputs as (B, h, L, dh) views of packed tensors."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs((2, 2, 16, 32), seed=2))
    qkv = _pack(q, k, v)
    parts = [flash_bwd.split_heads(qkv[..., i * 64:(i + 1) * 64], 2) for i in range(3)]
    grad = torch.zeros_like(qkv)
    outs = [flash_bwd.split_heads(grad[..., i * 64:(i + 1) * 64], 2) for i in range(3)]
    flash_bwd.attention_flashbwd_backward(*parts, do, 0.2, *outs)
    for o, w in zip(outs, flash_bwd.attention_flashbwd_backward_reference(q, k, v, do, 0.2)):
        torch.testing.assert_close(o, w, rtol=0, atol=0)


def test_encoder_self_attention_routes_training_through_b4(monkeypatch):
    """Under autograd at L < KERNEL_MIN_LEN with dh = 32 the packed
    projection goes to attention_flashbwd; kernels.plain() and no_grad take
    layers.packed_self_attention; all agree to f32 rounding in outputs and gradients."""
    calls = []
    real = flash_bwd.attention_flashbwd
    monkeypatch.setattr(flash_bwd, 'attention_flashbwd',
                        lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(3)
    B, L, D, h = 2, 24, 64, 2
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1).requires_grad_()
         for s in ((3 * D, D), (3 * D,), (D, D), (D,))]

    def run():
        y = attention.encoder_self_attention(x, *w, h)
        return y, torch.autograd.grad(y.sin().sum(), w)

    y1, g1 = run()
    assert calls == [(B, L, 3 * D)]
    with kernels.plain():
        y2, g2 = run()
    assert len(calls) == 1
    with torch.no_grad():
        y3 = attention.encoder_self_attention(x, *w, h)
    assert len(calls) == 1
    torch.testing.assert_close(y1, y2, rtol=0, atol=1e-6)
    torch.testing.assert_close(y3, y2, rtol=0, atol=1e-6)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    # a head width the kernel does not take stays on plain autograd
    attention.encoder_self_attention(x, *w, 4).sum().backward()
    assert len(calls) == 1


@pytest.mark.parametrize('shape,dtype', [((1, 1, 300, 64), torch.bfloat16),
                                         ((1, 1, 20, 64), torch.bfloat16),
                                         ((1, 1, 16, 48), torch.bfloat16),
                                         ((1, 1, 16, 64), torch.float16)])
def test_kernel_shape_guard_raises(shape, dtype):
    t = torch.empty(shape, dtype=dtype, device='meta')
    with pytest.raises(ValueError, match=r'\(B, h, L, dh\) = \(1, 1, '):
        flash_bwd.attention_flashbwd_backward(t, t, t, t, 0.1, t, t, t)


@pytest.mark.parametrize('scale', [0.0, -0.125])
def test_kernel_scale_guard_raises(scale):
    """The bf16 kernel takes the row max of the unscaled scores, which is
    the max of the scaled ones only for scale > 0."""
    t = torch.empty(1, 1, 16, 64, dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='scale > 0'):
        flash_bwd.attention_flashbwd_backward(t, t, t, t, scale, t, t, t)


def test_other_devices_raise():
    t = torch.empty(1, 1, 16, 64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        flash_bwd.attention_flashbwd_backward(t, t, t, t, 0.1, t, t, t)


# The card check's inputs and limits (flash_bwd.check_operands,
# CHECK_LIMITS), shared with chip_smoke.py, exercised on the CPU: faults
# planted in the plain version (flash_bwd._grads, monkeypatched) fail it,
# and what a right kernel computes passes it.
GRADS = flash_bwd._grads
CHECK_SHAPE = (8, 6, 128, 64)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _kernel_like(split):
    """The kernel's arithmetic: scores and dP as f64 sums rounded to f32, exp
    as ex2, P normalised by a multiply, and P and dS passed through `split`
    before the three products that take them."""
    def grads(q, k, v, do, scale):
        s = (q.double() @ k.double().transpose(-1, -2)).float()
        e = torch.exp2((s - s.amax(-1, keepdim=True)) * (scale * 1.4426950408889634))
        p = e * (1.0 / e.sum(-1, keepdim=True))
        dp = (do.double() @ v.double().transpose(-1, -2)).float()
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        p, ds = split(p).double(), split(ds).double()
        dv = (p.transpose(-1, -2) @ do.double()).float()
        dq = (ds @ k.double()).float() * scale
        dk = (ds.transpose(-1, -2) @ q.double()).float() * scale
        return dq, dk, dv
    return grads


def _float64(q, k, v, do, scale):
    return tuple(g.float() for g in GRADS(q.double(), k.double(), v.double(), do.double(), scale))


def _uniform_p(q, k, v, do, scale):
    return GRADS(torch.zeros_like(q), k, v, do, scale)


def _delta_dropped(q, k, v, do, scale):
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    ds = p * (do @ v.transpose(-1, -2))
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, p.transpose(-1, -2) @ do


def _other_heads_keys(q, k, v, do, scale):
    return GRADS(q, k.roll(1, dims=-3), v, do, scale)


def _last_8_keys_masked(q, k, v, do, scale):
    s = (q @ k.transpose(-1, -2)) * scale
    s[..., -8:] = -math.inf
    p = torch.softmax(s, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, p.transpose(-1, -2) @ do


def _check_case(dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(11)
    *operands, _, _, _, scale = flash_bwd.check_operands(*CHECK_SHAPE, gen, dtype)
    return operands, scale


def test_check_operands_spread_scores():
    """Scores spread by about CHECK_SCORE_STD; q, k, v are views of one packed
    projection, the outputs views of one packed gradient."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do, dq, dk, dv, scale = flash_bwd.check_operands(2, 6, 128, 64, gen, torch.float32)
    assert scale == 0.125 and q.stride() == (128 * 3 * 384, 64, 3 * 384, 1)
    assert k.data_ptr() == q.data_ptr() + 384 * 4 and dv.data_ptr() == dk.data_ptr() + 384 * 4
    assert do.shape == dq.shape == (2, 6, 128, 64) and do.is_contiguous()
    spread = float(((q @ k.transpose(-1, -2)) * scale).std(-1).mean())
    assert 0.9 * flash_bwd.CHECK_SCORE_STD < spread < 1.1 * flash_bwd.CHECK_SCORE_STD
    assert 0.95 < float(v.std()) < 1.05 and 0.95 < float(do.std()) < 1.05
    assert flash_bwd.check_operands(1, 1, 8, 32, gen)[0].dtype == torch.bfloat16


@pytest.mark.parametrize('fault', [_uniform_p, _delta_dropped, _other_heads_keys,
                                   _last_8_keys_masked, _kernel_like(_bf16)],
                         ids=['uniform_p', 'delta_dropped', 'other_heads_keys',
                              'last_8_keys_masked', 'p_and_ds_rounded_once_to_bf16'])
def test_check_limits_catch_planted_faults(monkeypatch, fault):
    """A plain version with a planted fault fails the card check against the
    right one, in bf16 at (8, 6, 128, 64): by more than twice the max limit
    or twice the mean limit in at least one of dq, dk, dv."""
    operands, scale = _check_case()
    want = flash_bwd.attention_flashbwd_backward_reference(*operands, scale)
    monkeypatch.setattr(flash_bwd, '_grads', fault)
    bad = flash_bwd.attention_flashbwd_backward_reference(*operands, scale)
    errs = flash_bwd.check_errors(bad, want)
    limit_max, limit_mean = flash_bwd.CHECK_LIMITS[torch.bfloat16]
    print(f'{fault.__name__}: relative max / mean {errs}')
    assert not flash_bwd.check_passes(bad, want)
    assert any(m > 2 * limit_max or a > 2 * limit_mean for m, a in errs)


@pytest.mark.parametrize('right', [_float64, _kernel_like(_hi_lo)], ids=['float64', 'hi_lo'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
def test_check_limits_pass_what_the_kernel_computes(monkeypatch, right, dtype):
    """A float64 version, and the kernel's arithmetic with P and dS split into
    bf16 hi + lo, pass the check with the mean at most a tenth of its limit
    (f32 operands: the hi + lo split is not what the f32 kernel does, so
    only the float64 version is held to the f32 limits)."""
    if dtype == torch.float32 and right is not _float64:
        right = _kernel_like(lambda x: x)
    operands, scale = _check_case(dtype)
    want = flash_bwd.attention_flashbwd_backward_reference(*operands, scale)
    monkeypatch.setattr(flash_bwd, '_grads', right)
    got = flash_bwd.attention_flashbwd_backward_reference(*operands, scale)
    limit_max, limit_mean = flash_bwd.CHECK_LIMITS[dtype]
    errs = flash_bwd.check_errors(got, want)
    assert flash_bwd.check_passes(got, want), errs
    assert all(a <= limit_mean / 10 for _, a in errs)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when a header under csrc/ that its
    sources may include (csrc/hopper.cuh) changes, not only its sources."""
    from parseq_tpu_torch.kernels import build

    assert (build.CSRC / 'hopper.cuh').is_file()
    assert f'-I{build.CSRC}' in build.NVCC_FLAGS
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    src, header = tmp_path / 'k.cu', tmp_path / 'shared.cuh'
    src.write_text('#include "shared.cuh"\n')
    header.write_text('// one\n')
    first = build._build_hash([src], ['nvcc'])
    header.write_text('// two\n')
    assert build._build_hash([src], ['nvcc']) != first


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


# The shapes of the card check: every length class of the kernel (one key
# tile, ragged tiles, PARSeq-S's 128, one past it, a ragged last tile of a
# 4-block cluster, the longest), both head widths, B = 1, 7, 48, head counts
# other than 6 and the whole training batch.
GPU_CASES = ([(B, 6, L, 64) for L in (8, 16, 120, 128, 136, 200, 256) for B in (1, 7, 48)]
             + [(B, 6, L, 32) for L in (8, 120, 136, 200, 256) for B in (1, 7)]
             + [(3, 2, 24, 32), (2, 3, 256, 64), (2, 3, 200, 64), (5, 1, 200, 32),
                (384, 6, 128, 64)])


@pytest.mark.gpu
@pytest.mark.parametrize('B,h,L,dh', GPU_CASES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain(cuda_device, B, h, L, dh, dtype):
    """Within CHECK_LIMITS of the plain version on the check's inputs; bf16
    strided (views of the packed projection and gradient) and contiguous
    operands give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    q, k, v, do, dq, dk, dv, scale = flash_bwd.check_operands(B, h, L, dh, gen, dtype)
    before = flash_bwd.launches
    flash_bwd.attention_flashbwd_backward(q, k, v, do, scale, dq, dk, dv)
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 1
    got = (dq, dk, dv)
    want = flash_bwd.attention_flashbwd_backward_reference(q, k, v, do, scale)
    assert flash_bwd.check_passes(got, want), flash_bwd.check_errors(got, want)
    if dtype == torch.bfloat16:
        same = [torch.empty_like(dq) for _ in range(3)]
        flash_bwd.attention_flashbwd_backward(q.contiguous(), k.contiguous(), v.contiguous(), do,
                                              scale, *same)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
