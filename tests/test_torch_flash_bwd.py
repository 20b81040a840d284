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
    projection goes to attention_flashbwd; plain_backward() and no_grad take
    layers.mha; all agree to f32 rounding in outputs and gradients."""
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
    with attention.plain_backward():
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


def test_other_devices_raise():
    t = torch.empty(1, 1, 16, 64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        flash_bwd.attention_flashbwd_backward(t, t, t, t, 0.1, t, t, t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('B,h,L,dh', [(48, 6, 128, 64), (3, 2, 24, 32), (2, 3, 256, 64),
                                      (5, 1, 200, 32)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain(cuda_device, B, h, L, dh, dtype):
    """bf16: outputs rounded to bf16, f32 sums in another order (2^-6 of the
    largest reference value); f32: 1e-5 of it."""
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    D = h * dh
    qkv = torch.randn(B, L, 3 * D, generator=gen, device=cuda_device).to(dtype)
    parts = [flash_bwd.split_heads(qkv[..., i * D:(i + 1) * D], h) for i in range(3)]
    do = torch.randn(B, h, L, dh, generator=gen, device=cuda_device).to(dtype)
    grad = torch.empty_like(qkv)
    outs = [flash_bwd.split_heads(grad[..., i * D:(i + 1) * D], h) for i in range(3)]
    before = flash_bwd.launches
    flash_bwd.attention_flashbwd_backward(*parts, do, dh ** -0.5, *outs)
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 1
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    for got, want in zip(outs, flash_bwd.attention_flashbwd_backward_reference(
            *parts, do, dh ** -0.5)):
        assert got.dtype == dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())
