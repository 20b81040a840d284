"""Port registry, hub and read CLI against the JAX package's ModelBundle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.utils import registry as jregistry
from parseq_tpu_torch import hub
from parseq_tpu_torch.cli import read as read_cli
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.convert import (abinet_state_dict_from_jax, crnn_state_dict_from_jax,
                                            state_dict_from_jax, trba_state_dict_from_jax,
                                            vitstr_state_dict_from_jax)

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


@pytest.mark.parametrize('name', ['crnn', 'trba'])
def test_cnn_factories_build_and_read(name):
    """hub.crnn and hub.trba build their experiments and read on the CPU."""
    narrow = {'crnn': dict(hidden_size=32),
              'trba': dict(hidden_size=16, output_channel=32, max_label_length=6)}[name]
    model = getattr(hub, name)(device='cpu', dtype=torch.float32, **narrow)
    assert (model.name, model.img_size, type(model.module).__name__) == (
        name, (32, 128), name.upper())
    images = np.random.default_rng(5).uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    labels, conf = model.read(images)
    assert len(labels) == len(conf) == 2
    assert all(set(t) <= set(model.tokenizer.charset) for t in labels)
    assert all(0.0 <= c <= 1.0 for c in conf)


# Small widths of each family at its experiment's image size; every encoder
# runs at L >= 192 (197, 196, 256), the kernel branch of its attention.
FAMILIES = {
    'vitstr': dict(embed_dim=48, num_heads=4, depth=2, max_label_length=10),
    'parseq-patch16-224': dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6,
                               max_label_length=10),
    'abinet': dict(nhead=4, d_inner=128, v_num_layers=1, l_num_layers=1, iter_size=2,
                   max_label_length=10),
}
# The CNN families at narrow widths (CRNN's and TRBA's convolutions keep
# their published channels where the config does not set them).
FAMILIES.update({
    'crnn': dict(hidden_size=32),
    'trba': dict(hidden_size=16, output_channel=32, max_label_length=6),
    'trbc': dict(hidden_size=16, output_channel=32, max_label_length=6),
})


def _port_state_dict(experiment, jb):
    if experiment == 'crnn':
        return crnn_state_dict_from_jax(jb.params['params'], jb.params['stats'])
    if experiment in ('trba', 'trbc'):
        return trba_state_dict_from_jax(jb.params['params'], jb.params['stats'],
                                        use_ctc=experiment == 'trbc')
    if experiment == 'vitstr':
        return vitstr_state_dict_from_jax(jb.params, jb.cfg.patch_size)
    if experiment == 'abinet':
        return abinet_state_dict_from_jax(jb.params['params'], jb.params['stats'],
                                          img_size=jb.cfg.img_size,
                                          max_label_length=jb.cfg.max_label_length)
    return state_dict_from_jax(jb.params, jb.cfg.patch_size)


@pytest.mark.parametrize('experiment', sorted(FAMILIES))
def test_family_reads_like_jax_bundle(experiment):
    """create_model for the families beyond PARSeq-S: the same weights and
    images give the JAX ModelBundle's labels, confidences to f32 noise."""
    overrides = FAMILIES[experiment]
    jb = jregistry.create_model(experiment, seed=0, dtype=jnp.float32, **overrides)
    tb = registry.create_model(experiment, device='cpu', dtype=torch.float32, **overrides)
    assert tb.img_size == jb.img_size and type(tb.cfg).__name__ == type(jb.cfg).__name__
    tb.module.load_state_dict(_port_state_dict(experiment, jb), strict=True)
    images = np.random.default_rng(3).uniform(-1, 1, (2, *jb.img_size, 3)).astype(np.float32)
    want_labels, want_conf = jb.read(jnp.asarray(images))
    labels, conf = tb.read(images)
    assert labels == want_labels
    np.testing.assert_allclose(conf, want_conf, rtol=1e-3)


def test_slice2_factories_compose_their_experiments():
    vitstr = hub.vitstr(device='cpu', depth=1)
    assert (vitstr.name, vitstr.img_size) == ('vitstr', (224, 224))
    assert vitstr.module.pos_embed.shape == (1, 197, 384)
    p16 = hub.parseq_patch16_224(device='cpu', enc_depth=1)
    assert p16.name == 'parseq-patch16-224'
    assert p16.module.encoder.pos_embed.shape == (1, 196, 384)
    sv = registry.create_model('abinet-sv', device='cpu', l_num_layers=1)
    assert (sv.cfg.v_num_layers, sv.cfg.v_attention) == (2, 'attention')
    assert len(sv.module.vision.backbone.transformer.layers) == 2


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


def test_read_cli_loads_vitstr_by_file_name(tmp_path, capsys):
    """A vitstr*.pt file builds the ViTSTR family (JAX registry.py's rule)."""
    from PIL import Image

    overrides = FAMILIES['vitstr']
    tb = registry.create_model('vitstr', device='cpu', dtype=torch.float32, **overrides)
    ckpt = tmp_path / 'vitstr-small.pt'
    torch.save(tb.module.state_dict(), ckpt)
    png = tmp_path / 'word.png'
    pixels = (np.random.default_rng(4).random((40, 150, 3)) * 255).astype(np.uint8)
    Image.fromarray(pixels).save(png)
    read_cli.main([str(ckpt), '--images', str(png), '--device', 'cpu',
                   *(f'{k}:int={v}' for k, v in overrides.items())])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    from parseq_tpu_torch.data.transforms import load_image

    image = load_image(png, tb.img_size)
    assert image.shape == (224, 224, 3)
    labels, conf = tb.read(image[None])
    assert line == f'{png}: {labels[0]} (conf={conf[0]:.4f})'


def test_read_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(SystemExit):
        read_cli.main([str(tmp_path / 'parseq.pt'), '--images', 'x.png'])
