"""state_dict_from_jax is the exact inverse of the JAX package's converter."""

import numpy as np
import pytest

import jax

from parseq_tpu.models import parseq as jparseq
from parseq_tpu.models import vit as jvit
from parseq_tpu.utils.torch_convert import convert_parseq, convert_vit_encoder
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.models.vit import ViTConfig, VisionTransformer
from parseq_tpu_torch.utils.convert import state_dict_from_jax, vit_state_dict


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize('dec_depth', [1, 2])
def test_parseq_roundtrip_and_strict_load(dec_depth):
    kw = dict(num_tokens=13, max_label_length=7, img_size=(32, 64), embed_dim=48,
              enc_num_heads=4, enc_depth=2, dec_num_heads=6, dec_depth=dec_depth)
    params = jparseq.init(jax.random.key(dec_depth), jparseq.PARSeqConfig(**kw))
    sd = state_dict_from_jax(params)
    # Leaf for leaf, bit for bit, through the JAX package's own converter.
    _assert_trees_equal(convert_parseq({k: v.numpy() for k, v in sd.items()}), params)
    model = PARSeq(PARSeqConfig(**kw))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape, k


def test_vit_roundtrip_without_prefix():
    """A bare timm encoder state_dict (no 'encoder.' prefix), non-square patch."""
    kw = dict(img_size=(32, 64), patch_size=(8, 4), embed_dim=48, depth=2, num_heads=4)
    params = jvit.init(jax.random.key(0), jvit.ViTConfig(**kw))
    sd = vit_state_dict(params, prefix='', patch_size=(8, 4))
    _assert_trees_equal(convert_vit_encoder({k: v.numpy() for k, v in sd.items()}, prefix=''),
                        params)
    VisionTransformer(ViTConfig(**kw)).load_state_dict(sd, strict=True)
