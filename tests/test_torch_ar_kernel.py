"""Fused AR decode (kernel B1): the port's plain version against the JAX
Pallas kernel in interpret mode, and the CUDA kernel against the plain
version on the card (marked `gpu`, skipped without one).

Comparison method of tests/test_fused_attention.py: random weights make
near-tie greedy picks, so besides the direct comparison one side is
teacher-forced on the other's token prefix and logits compare step by step.

The GPU host has no jax, so jax is imported inside the fixture that needs
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest -m gpu tests/test_torch_ar_kernel.py`).
"""

import numpy as np
import pytest
import torch

from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.ops import ar_kernel
from parseq_tpu_torch.utils.convert import state_dict_from_jax

# bf16 matmul inputs on both sides; f32 accumulation in another order and
# erf (exact vs the JAX kernel's polynomial, |err| < 1.5e-7).
ATOL = 2e-2
# Greedy picks must agree wherever the top-2 margin exceeds the bf16 noise.
MARGIN = 0.05

KW = dict(num_tokens=13, max_label_length=7, img_size=(32, 64), patch_size=(4, 8),
          embed_dim=48, enc_num_heads=4, enc_depth=1, dec_num_heads=6, dec_depth=1)


@pytest.fixture(scope='module')
def setup():
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from parseq_tpu.models import parseq as jparseq
    from parseq_tpu.ops.ar_kernel import ar_decode_fused as jax_ar_decode_fused

    jcfg = jparseq.PARSeqConfig(**KW)
    params = jparseq.init(jax.random.key(3), jcfg)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((4, 32, 64, 3)).astype(np.float32))
    memory = jparseq.encode(params, jcfg, images).astype(jnp.bfloat16)
    model = PARSeq(PARSeqConfig(**KW)).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    mem_t = torch.from_numpy(np.array(memory.astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jax_ar_decode_fused(params, jcfg, memory, batch_block=2, interpret=True))
    return model, mem_t, want


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL)
    top2 = np.sort(want, -1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[confident], want.argmax(-1)[confident])


@pytest.mark.parametrize('mode', ['greedy', 'teacher_forced'])
def test_plain_matches_jax_kernel(setup, mode):
    model, memory, want = setup
    tokens = torch.from_numpy(want.argmax(-1)) if mode == 'teacher_forced' else None
    got = ar_kernel.ar_decode_fused_reference(model, memory, tokens=tokens).numpy()
    assert got.shape == want.shape == (4, model.cfg.num_steps, model.cfg.num_classes)
    _assert_close(got, want)


def test_cpu_tensor_takes_plain_version(setup):
    model, memory, _ = setup
    before = ar_kernel.launches
    got = ar_kernel.ar_decode_fused(model, memory)
    assert ar_kernel.launches == before  # no kernel launch on the CPU
    np.testing.assert_array_equal(
        got.numpy(), ar_kernel.ar_decode_fused_reference(model, memory).numpy())


@pytest.mark.parametrize('batch,sms,rows', [(1, 132, 1), (132, 132, 1), (133, 132, 2),
                                            (256, 132, 2), (300, 132, 4), (2000, 132, 8)])
def test_rows_per_block_fills_one_wave(batch, sms, rows):
    assert ar_kernel.rows_per_block(batch, sms) == rows


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('batch', [1, 3, 9])
def test_cuda_kernel_matches_plain(cuda_device, batch):
    """dh must be 32 for the kernel: D=64 with 2 decoder heads."""
    cfg = PARSeqConfig(num_tokens=13, max_label_length=7, img_size=(32, 64), embed_dim=64,
                       enc_num_heads=2, enc_depth=1, dec_num_heads=2)
    model = PARSeq(cfg)
    model.init_weights(torch.Generator().manual_seed(batch))
    model = model.to(cuda_device).eval()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    memory = torch.randn(batch, 64, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    before = ar_kernel.launches
    got = ar_kernel.ar_decode_fused(model, memory)
    torch.cuda.synchronize()
    assert ar_kernel.launches == before + 1
    want = ar_kernel.ar_decode_fused_reference(model, memory, tokens=got.argmax(-1))
    _assert_close(got.cpu().numpy(), want.cpu().numpy())
