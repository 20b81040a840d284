"""Port ViT encoder against parseq_tpu.models.vit.apply at f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parseq_tpu.models import vit as jvit
from parseq_tpu_torch.models import vit as tvit
from parseq_tpu_torch.ops.attention import encoder_self_attention
from parseq_tpu_torch.utils.convert import vit_state_dict

# f32 both sides; sums over D=48..96 in a different order.
ATOL = 2e-4


@pytest.mark.parametrize('img_size,patch_size', [((32, 64), (4, 8)), ((32, 128), (8, 4))])
def test_encoder_matches_jax(img_size, patch_size):
    """Two patch geometries: the (ph, pw, C) flattening order must survive
    a non-square patch in either orientation."""
    kw = dict(img_size=img_size, patch_size=patch_size, embed_dim=48, depth=2, num_heads=4)
    jcfg = jvit.ViTConfig(**kw)
    params = jvit.init(jax.random.key(1), jcfg)
    enc = tvit.VisionTransformer(tvit.ViTConfig(**kw)).eval()
    enc.load_state_dict(vit_state_dict(params, prefix='', patch_size=patch_size), strict=True)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, *img_size, 3)).astype(np.float32)
    want = np.asarray(jvit.apply(params, jnp.asarray(images), jcfg))
    with torch.no_grad():
        got = enc(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, jcfg.num_patches, 48)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_long_sequences_need_kernel_b2():
    x = torch.zeros(1, 192, 8)
    w, b = torch.zeros(24, 8), torch.zeros(24)
    with pytest.raises(NotImplementedError, match='B2'):
        encoder_self_attention(x, w, b, torch.zeros(8, 8), torch.zeros(8), 2)
