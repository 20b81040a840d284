"""Port registry, hub and read CLI against the JAX package's ModelBundle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.utils import registry as jregistry
from parseq_tpu_torch import hub
from parseq_tpu_torch.cli import read as read_cli
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.convert import state_dict_from_jax

SMALL = dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6, max_label_length=10)


def _jax_and_port(seed=0):
    jb = jregistry.create_model('parseq', seed=seed, dtype=jnp.float32, **SMALL)
    tb = registry.create_model('parseq', device='cpu', dtype=torch.float32, **SMALL)
    tb.module.load_state_dict(state_dict_from_jax(jb.params), strict=True)
    return jb, tb


def test_read_matches_jax_bundle():
    """Same weights and images: the same labels, confidences to f32 noise."""
    jb, tb = _jax_and_port()
    images = np.random.default_rng(0).uniform(-1, 1, (3, 32, 128, 3)).astype(np.float32)
    want_labels, want_conf = jb.read(jnp.asarray(images))
    labels, conf = tb.read(images)
    assert labels == want_labels
    np.testing.assert_allclose(conf, want_conf, rtol=1e-3)


def test_unknown_model_key_fails_loudly():
    with pytest.raises(registry.InvalidModelError, match='bogus_key'):
        registry.create_model('parseq', device='cpu', bogus_key=1, **SMALL)


def test_parseq_tiny_factory_composes_its_experiment():
    model = hub.parseq_tiny(device='cpu', enc_depth=1)
    assert model.name == 'parseq-tiny'
    assert (model.cfg.embed_dim, model.cfg.enc_num_heads, model.cfg.dec_num_heads) == (192, 3, 6)
    assert model.cfg.num_tokens == 97
    assert model.module.encoder.pos_embed.shape == (1, 128, 192)


@pytest.mark.parametrize('name', ['vitstr', 'crnn', 'trba', 'abinet', 'parseq_patch16_224'])
def test_unported_factories_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        getattr(hub, name)()


def test_read_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    jb, tb = _jax_and_port(seed=1)
    ckpt = tmp_path / 'parseq-small.pt'
    torch.save(tb.module.state_dict(), ckpt)
    img = (np.random.default_rng(2).random((40, 150, 3)) * 255).astype(np.uint8)
    png = tmp_path / 'word.png'
    Image.fromarray(img).save(png)
    overrides = [f'{k}:int={v}' for k, v in SMALL.items()]
    read_cli.main([str(ckpt), '--images', str(png), '--device', 'cpu', *overrides])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    from parseq_tpu_torch.data.transforms import load_image

    labels, conf = tb.read(load_image(png)[None])
    assert line == f'{png}: {labels[0]} (conf={conf[0]:.4f})'


def test_read_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(SystemExit):
        read_cli.main([str(tmp_path / 'parseq.pt'), '--images', 'x.png'])
