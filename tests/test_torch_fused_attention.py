"""Kernel B3 (fused attention on the head-split (BH, L, dh) layout) and the
backward of kernel B2: the port's plain versions and autograd Functions
against the JAX package's Pallas kernels in interpret mode and its custom
VJPs, and the CUDA kernels against the plain versions on the card (marked
`gpu`, skipped without one).

The GPU host has no jax, so jax is imported inside the fixture that needs
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest --noconftest -m gpu tests/test_torch_fused_attention.py`).
"""

import math

import numpy as np
import pytest
import torch

from parseq_tpu_torch.ops import attention


@pytest.fixture(scope='module')
def jax_attention():
    pytest.importorskip('jax')
    from parseq_tpu.ops import attention as jattention

    return jattention


@pytest.fixture
def jax_interpret(jax_attention):
    """The JAX package's attention module with both Pallas kernels patched to
    interpret mode, so its custom VJPs run on the CPU (the patch of
    tests/test_fused_attention.py::test_custom_vjp_grads_match_reference)."""
    names = ('_pallas_attention', '_pallas_attention_nosplit')
    orig = {n: getattr(jax_attention, n) for n in names}
    for n, fn in orig.items():
        setattr(jax_attention, n, lambda *a, fn=fn, **kw: fn(*a, interpret=True, **kw))
    try:
        yield jax_attention
    finally:
        for n, fn in orig.items():
            setattr(jax_attention, n, fn)


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize('bh,L,dh', [(4, 32, 16), (6, 64, 64), (3, 40, 32)])
def test_plain_matches_jax_kernel(jax_attention, bh, L, dh):
    """The shapes of tests/test_fused_attention.py; f32 both sides, only the
    order of the f32 sums differs (atol 1e-5, that test's bound)."""
    import jax.numpy as jnp

    q, k, v = _arrays((bh, L, dh), 0)
    scale = 1.0 / math.sqrt(dh)
    want = jax_attention._pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           scale, interpret=True)
    got = attention.fused_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_matches_jax_kernel_in_bf16(jax_attention):
    """bf16 at ViTSTR's L = 197, dh = 64: p and o are rounded to bf16 on both
    sides and the f32 sums taken in another order, so outputs may differ by
    a bf16 step of values up to ~4 (atol 2e-2)."""
    import jax.numpy as jnp

    q, k, v = _arrays((12, 197, 64), 1)
    want = jax_attention._pallas_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                           0.125, interpret=True)
    got = attention.fused_attention_reference(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def _grads(fn, arrays, cotangent):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn(*leaves).backward(torch.from_numpy(cotangent))
    return [t.grad.numpy() for t in leaves]


def test_fused_attention_grads_match_jax_custom_vjp(jax_interpret):
    """d/dq, dk, dv of sum(o * g) through the port's Function (forward:
    plain version on the CPU; backward: autograd of the plain version)
    against jax.grad through fused_attention's custom VJP; f32, atol 1e-5."""
    import jax
    import jax.numpy as jnp

    q, k, v, g = _arrays((2, 16, 8), 1, n=4)
    scale = 1.0 / math.sqrt(8)
    want = jax.grad(lambda *t: jnp.sum(jax_interpret.fused_attention(*t, scale) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    before = attention.split_launches
    got = _grads(lambda *t: attention.fused_attention(*t, scale), (q, k, v), g)
    assert attention.split_launches == before  # no kernel launch for a CPU tensor
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


@pytest.mark.parametrize('B,L,h,D', [(2, 16, 2, 16), (2, 197, 6, 48)])
def test_nosplit_grads_match_jax_custom_vjp(jax_interpret, B, L, h, D):
    """The B2 backward: the same comparison for fused_attention_nosplit
    against jax.grad through `_ns_bwd`; f32, atol 1e-5."""
    import jax
    import jax.numpy as jnp

    q, k, v, g = _arrays((B, L, D), 2, n=4)
    scale = 1.0 / math.sqrt(D // h)
    want = jax.grad(lambda *t: jnp.sum(jax_interpret.fused_attention_nosplit(*t, h, scale) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _grads(lambda *t: attention.fused_attention_nosplit(*t, h, scale), (q, k, v), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_packed_views_take_gradients_into_the_projection():
    """q, k, v as column views of one packed (B, L, 3D) leaf: the B2 Function
    puts each view's gradient into its own columns, as plain autograd does."""
    D, h = 32, 2
    qkv = torch.from_numpy(_arrays((2, 20, 3 * D), 3, n=1)[0]).requires_grad_()
    g = torch.from_numpy(_arrays((2, 20, D), 4, n=1)[0])
    views = [qkv[..., i * D:(i + 1) * D] for i in range(3)]
    (got,) = torch.autograd.grad(attention.fused_attention_nosplit(*views, h, 0.25), qkv, g)
    (want,) = torch.autograd.grad(
        attention.fused_attention_nosplit_reference(*views, h, 0.25), qkv, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_other_devices_raise():
    t = torch.empty(2, 16, 64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        attention.fused_attention(t, t, t, 0.125)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _cuda_leaves(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(torch.bfloat16).requires_grad_()
            for _ in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('BH,L', [(12, 128), (18, 197), (6, 5), (6, 416)])
def test_cuda_b3_matches_plain(cuda_device, BH, L, dtype):
    """Forward: within attention.CHECK_LIMITS of the plain version on the
    card check's inputs (contiguous (BH, L, 64) leaves). Gradients, a wiring
    check: the backward is autograd of the plain version in both, from the
    same q, k, v, so they are equal whatever the kernel computes; their
    values are held against JAX's custom VJP by
    test_fused_attention_grads_match_jax_custom_vjp."""
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    q, k, v = (t.contiguous().requires_grad_()
               for t in attention.check_operands(BH, L, 64, 64, 0.125, gen, dtype))
    g = torch.randn(BH, L, 64, generator=gen, device=cuda_device).to(dtype)
    before = attention.split_launches
    got = attention.fused_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert attention.split_launches == before + 1
    want = attention.fused_attention_reference(q, k, v, 0.125)
    assert got.dtype == dtype and attention.check_passes(got.detach(), want.detach()), \
        attention.check_errors(got.detach(), want.detach())
    grads = torch.autograd.grad(got, (q, k, v), g)
    wants = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip(grads, wants):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_b2_backward_matches_plain(cuda_device):
    """B2 under autograd on the card at ViTSTR's (L, h, D) = (197, 6, 384):
    the kernel forward, gradients equal to plain autograd's (a wiring check;
    test_nosplit_grads_match_jax_custom_vjp holds their values)."""
    q, k, v, g = _cuda_leaves((2, 197, 384), cuda_device, 0)
    before = attention.launches
    got = attention.fused_attention_nosplit(q, k, v, 6, 0.125)
    assert attention.launches == before + 1
    grads = torch.autograd.grad(got, (q, k, v), g)
    wants = torch.autograd.grad(attention.fused_attention_nosplit_reference(q, k, v, 6, 0.125),
                                (q, k, v), g)
    for a, b in zip(grads, wants):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
