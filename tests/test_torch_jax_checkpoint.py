"""The JAX package's msgpack checkpoints in the port: the decoder
(utils/msgpack.py) against flax.serialization.msgpack_restore and
msgpack.unpackb, each of the six families loaded through
registry.load_from_checkpoint with the JAX bundle's logits at f32, cli.read
on a JAX checkpoint, the format told by the first bytes (a legacy
torch.save `.ckpt` too), and experiments/torch_jax_ckpt.py's packer, which
writes such a file on a host without flax."""

import json
import random

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from experiments.torch_jax_ckpt import packb, parseq_tree, save_parseq_as_jax
from parseq_tpu.utils import config as jconfig
from parseq_tpu.utils import registry as jregistry
from parseq_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from parseq_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from parseq_tpu_torch.cli import read as read_cli
from parseq_tpu_torch.utils import msgpack as tmsgpack
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.checkpoint import load_jax_checkpoint

# Narrow, shallow models of each family at its experiment's image size, and
# the f32 parity tolerance each family's own port test holds its logits to
# (tests/test_torch_parseq.py, _vitstr.py, _crnn.py, _trba.py, _abinet.py).
FAMILIES = {
    'parseq': (dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6,
                    max_label_length=10), 2e-3),
    'vitstr': (dict(embed_dim=48, num_heads=4, depth=2, max_label_length=10), 2e-4),
    'crnn': (dict(hidden_size=32), 1e-4),
    'trba': (dict(hidden_size=16, output_channel=32, max_label_length=6), 1e-4),
    'trbc': (dict(hidden_size=16, output_channel=32, max_label_length=6), 1e-4),
    'abinet': (dict(nhead=4, d_inner=128, v_num_layers=1, l_num_layers=1, iter_size=2,
                    max_label_length=10), 3e-3),
}


def _save_jax(path, experiment, seed=0):
    """A JAX bundle and its checkpoint as the JAX trainer writes one (meta:
    name and the composed model config; CNN families and ABINet as
    {'params', 'stats'}, PARSeq and ViTSTR as bare params)."""
    overrides = FAMILIES[experiment][0]
    jb = jregistry.create_model(experiment, seed=seed, dtype=jnp.float32, **overrides)
    mcfg = dict(jconfig.compose(experiment)['model'], **overrides)
    jax_save_checkpoint(path, jb.params, jb.cfg, meta={'name': experiment, 'model_config': mcfg})
    return jb


def _assert_trees_equal(got, want, where='root'):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray) and want.dtype.name == 'bfloat16':
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(), want.view(np.uint16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, where


# ---------------------------------------------------------------- decoder ---


def test_decoder_equals_flax_on_a_saved_checkpoint(tmp_path):
    _save_jax(tmp_path / 'p.ckpt', 'parseq')
    data = (tmp_path / 'p.ckpt').read_bytes()
    _assert_trees_equal(tmsgpack.restore(data), serialization.msgpack_restore(data))
    params, config, meta = load_jax_checkpoint(tmp_path / 'p.ckpt')
    jparams, jconfig_, jmeta = jax_load_checkpoint(tmp_path / 'p.ckpt')
    assert (config, meta) == (jconfig_, jmeta) and meta['name'] == 'parseq'
    _assert_trees_equal(params, jax_to_np(jparams))


def jax_to_np(tree):
    if isinstance(tree, dict):
        return {k: jax_to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_to_np(v) for v in tree]
    return np.asarray(tree)


def _random_tree(rng, depth=0):
    kind = rng.randrange(11 if depth < 3 else 8)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind == 1:  # every int width, both signs
        bits = rng.choice([4, 5, 7, 8, 15, 16, 31, 32, 63])
        return rng.randrange(-(1 << bits), 1 << bits) if bits < 63 else rng.randrange(0, 1 << 64)
    if kind == 2:
        return rng.uniform(-1e6, 1e6)
    if kind == 3:  # str of each length class (fix, 8, 16 bits)
        n = rng.choice([0, 5, 31, 32, 255, 256, 70000])
        return ''.join(rng.choice('aé\U0001F600z') for _ in range(n))
    if kind == 4:
        return rng.randbytes(rng.choice([0, 3, 255, 256, 70000]))
    if kind == 5:
        return np.float32(rng.random())
    if kind in (6, 7):  # ndarrays, f32, int and bf16
        shape = tuple(rng.randrange(1, 5) for _ in range(rng.randrange(0, 4)))
        arr = np.random.default_rng(rng.randrange(1 << 30)).standard_normal(shape)
        dtype = rng.choice([np.float32, np.int32, np.uint8, jnp.bfloat16, np.float64])
        return np.asarray(arr * 100).astype(dtype)
    if kind in (8, 9):
        return [_random_tree(rng, depth + 1) for _ in range(rng.choice([0, 3, 15, 16, 17]))]
    return {f'k{i}': _random_tree(rng, depth + 1) for i in range(rng.choice([0, 2, 15, 16, 20]))}


@pytest.mark.parametrize('seed', range(5))
def test_decoder_equals_msgpack_and_flax_on_seeded_trees(seed):
    rng = random.Random(seed)
    tree = {'root': [_random_tree(rng) for _ in range(6)],
            'bf16': np.asarray(np.arange(6).reshape(2, 3), jnp.bfloat16)}
    data = serialization.msgpack_serialize(tree)
    _assert_trees_equal(tmsgpack.restore(data), serialization.msgpack_restore(data))
    plain = msgpack.packb({'a': [1, -1, 2 ** 40, -2 ** 40, 1.5, 'x' * 40, b'y' * 300, None, True],
                           'b': {'c': list(range(20))}, 'seed': seed})
    assert tmsgpack.unpackb(plain) == msgpack.unpackb(plain)


def test_chunked_arrays_are_reassembled(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)  # flax chunks leaves above it
    tree = {'big': np.arange(100, dtype=np.float32).reshape(10, 10), 'small': np.ones(3)}
    data = serialization.msgpack_serialize(tree)
    assert tmsgpack.CHUNKED.encode() in data
    got = tmsgpack.restore(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got['big'], tree['big'])
    with pytest.raises(tmsgpack.MsgpackError, match=tmsgpack.CHUNKED):
        tmsgpack.restore(msgpack.packb({'x': {tmsgpack.CHUNKED: True, 'shape': 1}}))


@pytest.mark.parametrize('data, match', [
    (msgpack.packb(msgpack.ExtType(2, b'\x00')), 'ext type 2'),
    (msgpack.packb(msgpack.ExtType(7, b'abcd')), 'ext type 7'),
    (b'\xc1', '0xc1'),
    (msgpack.packb([1, 2, 3])[:-1], 'truncated'),
    (msgpack.packb(1) + b'\x00', 'after'),
    (serialization.msgpack_serialize(complex(1, 2)), 'ext type 2'),
])
def test_anything_else_raises(data, match):
    with pytest.raises(tmsgpack.MsgpackError, match=match):
        tmsgpack.unpackb(data)


# --------------------------------------------------------------- families ---


@pytest.mark.parametrize('experiment', sorted(FAMILIES))
def test_jax_checkpoint_loads_with_the_jax_bundles_logits(tmp_path, experiment):
    path = tmp_path / f'{experiment}-jax.ckpt'
    jb = _save_jax(path, experiment)
    tb = registry.load_from_checkpoint(str(path), device='cpu', dtype=torch.float32)
    assert type(tb.cfg).__name__ == type(jb.cfg).__name__ and tb.img_size == jb.img_size
    images = np.random.default_rng(3).uniform(-1, 1, (2, *jb.img_size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jb.forward_fn)(jb.params, jnp.asarray(images)))
    got = tb(images).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FAMILIES[experiment][1])


def test_read_cli_reads_a_jax_checkpoint(tmp_path, capsys):
    from PIL import Image

    jb = _save_jax(tmp_path / 'parseq-small.ckpt', 'parseq', seed=1)
    paths = []
    for i, pixels in enumerate(np.random.default_rng(2).integers(0, 256, (3, 32, 128, 3),
                                                                 dtype=np.uint8)):
        paths.append(str(tmp_path / f'{i}.png'))
        Image.fromarray(pixels).save(paths[-1])
    read_cli.main([str(tmp_path / 'parseq-small.ckpt'), '--images', *paths, '--device', 'cpu'])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(str(tmp_path))]
    from parseq_tpu.data.transforms import batch_images

    labels, conf = jb.read(jnp.asarray(batch_images(paths, jb.img_size)))
    assert lines == [f'{p}: {t} (conf={c:.4f})' for p, t, c in zip(paths, labels, conf)]


def test_format_is_told_by_the_first_bytes(tmp_path):
    """A msgpack file named .pt goes to the JAX reader; a legacy-format
    torch.save `.ckpt` (b'\\x80\\x02\\x8a\\n...') to torch.load; anything else
    raises naming its first bytes."""
    jb = _save_jax(tmp_path / 'parseq.pt', 'parseq')
    tb = registry.load_from_checkpoint(str(tmp_path / 'parseq.pt'), device='cpu')
    assert tb.cfg.embed_dim == jb.cfg.embed_dim == 48
    legacy = tmp_path / 'parseq-legacy.ckpt'
    torch.save(tb.module.state_dict(), legacy, _use_new_zipfile_serialization=False)
    assert legacy.read_bytes()[:4] == b'\x80\x02\x8a\n'
    lb = registry.load_from_checkpoint(str(legacy), device='cpu',
                                       **FAMILIES['parseq'][0])
    for k, v in tb.module.state_dict().items():
        assert torch.equal(lb.module.state_dict()[k], v), k
    (tmp_path / 'junk.ckpt').write_bytes(b'GARBAGE!')
    with pytest.raises(ValueError, match='GARB'):
        registry.load_from_checkpoint(str(tmp_path / 'junk.ckpt'), device='cpu')


def test_family_and_tree_shape_must_agree(tmp_path):
    jb = jregistry.create_model('crnn', seed=0, dtype=jnp.float32, hidden_size=32)
    mcfg = dict(jconfig.compose('crnn')['model'], hidden_size=32)
    jax_save_checkpoint(tmp_path / 'c.ckpt', jb.params['params'], None,
                        meta={'name': 'crnn', 'model_config': mcfg})
    with pytest.raises(registry.InvalidModelError, match='bare params'):
        registry.load_from_checkpoint(str(tmp_path / 'c.ckpt'), device='cpu')


# ----------------------------------------------------------------- packer ---


def test_packer_writes_what_flax_and_the_jax_package_read(tmp_path):
    """experiments/torch_jax_ckpt.py: flax restores its file, the JAX
    package's load gives convert_parseq's tree and the same logits, and the
    port reads it like the .pt of the same weights."""
    from parseq_tpu.utils.torch_convert import convert_parseq

    overrides = FAMILIES['parseq'][0]
    tb = registry.create_model('parseq', device='cpu', dtype=torch.float32, seed=4, **overrides)
    sd = tb.module.state_dict()
    mcfg = dict(jconfig.compose('parseq')['model'], **overrides)
    path = tmp_path / 'packed.ckpt'
    save_parseq_as_jax(path, sd, mcfg)
    data = path.read_bytes()
    _assert_trees_equal(tmsgpack.restore(data), serialization.msgpack_restore(data))
    params, _, meta = jax_load_checkpoint(path)
    assert meta == {'name': 'parseq', 'model_config': json.loads(json.dumps(mcfg))}
    _assert_trees_equal(jax_to_np(params), jax_to_np(convert_parseq(sd)))
    _assert_trees_equal(parseq_tree(sd), jax_to_np(convert_parseq(sd)))
    jb = jregistry.load_from_checkpoint(str(path), dtype=jnp.float32)
    images = np.random.default_rng(5).uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    loaded = registry.load_from_checkpoint(str(path), device='cpu', dtype=torch.float32)
    np.testing.assert_array_equal(loaded(images).numpy(), tb(images).numpy())
    np.testing.assert_allclose(np.asarray(jb.forward_fn(jb.params, jnp.asarray(images))),
                               tb(images).numpy(), atol=FAMILIES['parseq'][1])
    for obj in (None, True, -1, -33, 2 ** 40, 0.25, 'é' * 40, b'x' * 300, list(range(17)),
                {str(i): i for i in range(17)}, np.arange(3, dtype=np.int32)):
        if not isinstance(obj, np.ndarray):
            assert msgpack.unpackb(packb(obj)) == obj
        _assert_trees_equal(tmsgpack.unpackb(packb(obj)), obj)
