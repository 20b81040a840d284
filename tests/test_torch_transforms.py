"""The port's device-side preprocessing (data/transforms.py:preprocess_torch)
against the JAX package's preprocess_jax on the CPU.

jax.image.resize's cubic antialiases; torch's bicubic matches it only with
antialias=True. Both are exact at 32x128 -> 32x128, so the guard of that
choice is a case at another size with antialias=False, which must miss.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parseq_tpu.data.transforms import preprocess_jax
from parseq_tpu_torch.data.transforms import preprocess_torch

# f32 both sides, values in [-1, 1]: the resize's sums differ in order only.
ATOL = 1e-6
SIZES = ((20, 50), (64, 256), (10, 10), (100, 300), (32, 128))


def _images(h, w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    return rng.uniform(0, 1, (3, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32], ids=['uint8', 'f32'])
@pytest.mark.parametrize('size', SIZES, ids=[f'{h}x{w}' for h, w in SIZES])
def test_preprocess_torch_matches_preprocess_jax(size, dtype):
    x = _images(*size, dtype)
    want = np.asarray(preprocess_jax(x))
    got = preprocess_torch(x)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 128, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0


def test_preprocess_torch_takes_tensors_and_a_device():
    x = _images(20, 50, np.uint8)
    got = preprocess_torch(torch.from_numpy(x), img_size=(16, 32), device='cpu')
    assert got.device.type == 'cpu' and got.shape == (3, 16, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(preprocess_jax(x, (16, 32))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize('size', SIZES[:4], ids=[f'{h}x{w}' for h, w in SIZES[:4]])
def test_bicubic_without_antialias_misses(size):
    """The trap: torch's bicubic without antialias is another resize."""
    x = _images(*size, np.uint8)
    want = np.asarray(preprocess_jax(x))
    y = F.interpolate(torch.from_numpy(x).float().permute(0, 3, 1, 2) / 255.0, size=(32, 128),
                      mode='bicubic', align_corners=False, antialias=False).clamp(0.0, 1.0)
    plain = ((y - 0.5) / 0.5).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 100 * ATOL
