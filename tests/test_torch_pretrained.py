"""The port's checkpoint and pretrained-weight loading: reference state_dicts
saved as `.ckpt` (and Lightning-wrapped) load as `.pt` files do, the
trainer's own checkpoints keep loading with their stored config, and the
pretrained resolution (utils/pretrained.py) against the JAX package's
table, with fake weight files under a monkeypatched table and cache
directory. Downloads are served from `file://` URLs; a guard fails any test
that opens another URL, so no test reaches the network."""

import hashlib
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.utils import pretrained as jpretrained
from parseq_tpu.utils import registry as jregistry
from parseq_tpu_torch import hub
from parseq_tpu_torch.cli import read as read_cli
from parseq_tpu_torch.utils import pretrained, registry
from parseq_tpu_torch.utils.checkpoint import save_checkpoint
from parseq_tpu_torch.utils.msgpack import MsgpackError

SMALL = dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6, max_label_length=10)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """urllib may open file:// URLs only."""
    urlopen = urllib.request.urlopen

    def local_only(url, *args, **kwargs):
        target = url.full_url if isinstance(url, urllib.request.Request) else str(url)
        if not target.startswith('file:'):
            raise AssertionError(f'a test tried to open {target}')
        return urlopen(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, 'urlopen', local_only)


def _images(n=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 128, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def parseq_s():
    """A port PARSeq-S (full width, random weights) and its logits on 2 images."""
    bundle = registry.create_model('parseq', seed=3, device='cpu', dtype=torch.float32)
    with torch.no_grad():
        logits = bundle(_images())
    return bundle.module.state_dict(), logits


def _logits(path, **kwargs):
    bundle = registry.load_from_checkpoint(str(path), device='cpu', dtype=torch.float32, **kwargs)
    with torch.no_grad():
        return bundle(_images())


# C1: a reference state_dict saved as .ckpt.

@pytest.mark.parametrize('wrap', ['plain', 'lightning'])
def test_reference_state_dict_as_ckpt_loads_like_pt(tmp_path, parseq_s, wrap):
    """parseq.ckpt holding a reference state_dict (bare, or as Lightning's
    {'state_dict': {'model.<key>': ...}}) gives the logits of the same
    weights saved as parseq.pt."""
    sd, want = parseq_s
    torch.save(sd, tmp_path / 'parseq.pt')
    obj = sd if wrap == 'plain' else {'state_dict': {f'model.{k}': v for k, v in sd.items()}}
    torch.save(obj, tmp_path / 'parseq.ckpt')
    torch.testing.assert_close(_logits(tmp_path / 'parseq.pt'), want, rtol=0, atol=0)
    torch.testing.assert_close(_logits(tmp_path / 'parseq.ckpt'), want, rtol=0, atol=0)


def test_reference_ckpt_reads_like_the_jax_package(tmp_path):
    """The same reference .ckpt through both packages: the same labels,
    confidences to f32 noise."""
    tb = registry.create_model('parseq', seed=1, device='cpu', dtype=torch.float32, **SMALL)
    path = tmp_path / 'parseq.ckpt'
    torch.save({'state_dict': {f'model.{k}': v for k, v in tb.module.state_dict().items()}}, path)
    jb = jregistry.load_from_checkpoint(str(path), dtype=jnp.float32, **SMALL)
    port = registry.load_from_checkpoint(str(path), device='cpu', dtype=torch.float32, **SMALL)
    images = _images(3, seed=4)
    want_labels, want_conf = jb.read(jnp.asarray(images))
    labels, conf = port.read(images)
    assert labels == want_labels
    np.testing.assert_allclose(conf, want_conf, rtol=1e-3)


def test_trainer_checkpoint_loads_with_its_stored_config(tmp_path):
    """A checkpoint as the port's trainer writes it (utils/checkpoint.py,
    meta with the model config) still builds its own geometry, whatever its
    file name says."""
    bundle = registry.create_model('parseq', seed=2, device='cpu', dtype=torch.float32, **SMALL)
    with torch.no_grad():
        want = bundle(_images())
    path = tmp_path / 'vitstr-step=3.ckpt'  # the name must not decide the family
    save_checkpoint(path, bundle.module.state_dict(), bundle.cfg,
                    meta={'name': 'parseq', 'model_config': dict(bundle.raw_config)})
    loaded = registry.load_from_checkpoint(str(path), device='cpu', dtype=torch.float32)
    assert loaded.cfg == bundle.cfg
    with torch.no_grad():
        torch.testing.assert_close(loaded(_images()), want, rtol=0, atol=0)


def test_non_torch_checkpoint_names_the_queue(tmp_path):
    path = tmp_path / 'model.ckpt'
    path.write_bytes(b'\x82\xa6params')  # a msgpack map, the JAX package's format
    # goes to the port's reader of that format (utils/msgpack.py), which
    # names what is wrong with this one: it ends inside its first key
    with pytest.raises(MsgpackError, match='truncated msgpack'):
        registry.load_from_checkpoint(str(path), device='cpu')


# C2: pretrained=True and pretrained=<experiment>, offline.

def test_weights_table_matches_the_jax_package():
    assert pretrained.WEIGHTS_URL == jpretrained.WEIGHTS_URL


@pytest.mark.parametrize('experiment', sorted(jpretrained.WEIGHTS_URL))
def test_filename_and_hash_prefix(experiment):
    assert pretrained.expected_filename(experiment) == jpretrained.expected_filename(experiment)
    assert (pretrained.expected_hash_prefix(experiment)
            == jpretrained.expected_hash_prefix(experiment))


def test_unknown_experiment_lists_the_table():
    assert pretrained.expected_filename('parseq') == 'parseq-bb5792a6.pt'
    assert pretrained.expected_hash_prefix('parseq') == 'bb5792a6'
    with pytest.raises(pretrained.PretrainedWeightsError, match='available'):
        pretrained.expected_filename('nonexistent-model')


def test_sha256_prefix_check(tmp_path):
    f = tmp_path / 'w.pt'
    f.write_bytes(b'payload')
    assert pretrained.sha256_prefix_ok(f, hashlib.sha256(b'payload').hexdigest()[:8])
    assert not pretrained.sha256_prefix_ok(f, 'deadbeef')


def _fake_entry(monkeypatch, payload, experiment='fake-model', stem='fake_model'):
    prefix = hashlib.sha256(payload).hexdigest()[:8]
    monkeypatch.setitem(pretrained.WEIGHTS_URL, experiment,
                        f'https://example.com/dl/{stem}-{prefix}.pt')
    return f'{stem}-{prefix}.pt'


def test_find_cached_verifies_hash(tmp_path, monkeypatch):
    payload = b'fake released weights'
    name = _fake_entry(monkeypatch, payload)
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(tmp_path))
    assert pretrained.find_cached('fake-model') is None
    (tmp_path / name).write_bytes(payload)
    assert pretrained.find_cached('fake-model') == tmp_path / name
    (tmp_path / name).write_bytes(b'corrupted!')  # a bad file fails loudly, never used
    with pytest.raises(pretrained.PretrainedWeightsError, match='sha256'):
        pretrained.find_cached('fake-model')


def test_cache_search_order(tmp_path, monkeypatch):
    """$PARSEQ_TPU_CACHE, then <cache>/parseq_tpu/checkpoints, then torch.hub's
    <cache>/torch/hub/checkpoints (the JAX package's order)."""
    payload = b'weights'
    name = _fake_entry(monkeypatch, payload)
    env, cache = tmp_path / 'env', tmp_path / 'xdg'
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(env))
    monkeypatch.setenv('XDG_CACHE_HOME', str(cache))
    own, hub_dir = cache / 'parseq_tpu' / 'checkpoints', cache / 'torch' / 'hub' / 'checkpoints'
    assert pretrained.cache_dirs() == [env, own, hub_dir] == jpretrained.cache_dirs()
    for d in (hub_dir, own, env):  # each newly planted directory wins
        d.mkdir(parents=True)
        (d / name).write_bytes(payload)
        assert pretrained.get_pretrained_path('fake-model') == d / name


def _offline(*args, **kwargs):
    raise OSError('no network')


def test_missing_weights_error_names_file_and_directories(tmp_path, monkeypatch):
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(tmp_path))
    monkeypatch.setattr(pretrained, 'download', _offline)  # a host without a network
    with pytest.raises(pretrained.PretrainedWeightsError, match='not found in cache') as e:
        pretrained.get_pretrained_path('parseq')
    assert 'parseq-bb5792a6.pt' in str(e.value)
    for d in pretrained.cache_dirs():
        assert str(d) in str(e.value)
    with pytest.raises(pretrained.PretrainedWeightsError, match='parseq-bb5792a6.pt'):
        registry.load_from_checkpoint('pretrained=parseq', device='cpu')
    with pytest.raises(pretrained.PretrainedWeightsError, match='parseq-bb5792a6.pt'):
        hub.parseq(pretrained=True, device='cpu')


def test_planted_weights_load_by_hub_and_by_name(tmp_path, monkeypatch, parseq_s):
    """A planted PARSeq-S file under the table's name and hash: hub.parseq
    (pretrained=True), load_from_checkpoint('pretrained=parseq') and the
    read CLI's `pretrained=parseq` give the logits of those weights."""
    sd, want = parseq_s
    src = tmp_path / 'w.pt'
    torch.save(sd, src)
    payload = src.read_bytes()
    name = _fake_entry(monkeypatch, payload, experiment='parseq', stem='parseq')
    cache = tmp_path / 'cache'
    cache.mkdir()
    (cache / name).write_bytes(payload)
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(cache))
    bundle = hub.parseq(pretrained=True, device='cpu', dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(bundle(_images()), want, rtol=0, atol=0)
    torch.testing.assert_close(_logits('pretrained=parseq'), want, rtol=0, atol=0)


def test_read_cli_takes_pretrained_name(tmp_path, monkeypatch, capsys):
    from PIL import Image

    tb = registry.create_model('parseq-tiny', seed=0, device='cpu', dtype=torch.float32)
    src = tmp_path / 'w.pt'
    torch.save(tb.module.state_dict(), src)
    payload = src.read_bytes()
    name = _fake_entry(monkeypatch, payload, experiment='parseq-tiny', stem='parseq_tiny')
    (tmp_path / name).write_bytes(payload)
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(tmp_path))
    img = tmp_path / 'a.png'
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (32, 100, 3), dtype=np.uint8)).save(img)
    read_cli.main(['pretrained=parseq-tiny', '--images', str(img), '--device', 'cpu'])
    out = capsys.readouterr().out
    assert f'{img}: ' in out and 'conf=' in out


# The download (ROADMAP A13), from file:// URLs on a monkeypatched table.

def _served(tmp_path, monkeypatch, payload, experiment, stem, name_payload=None):
    """`payload` behind a file:// URL in the table under `experiment`, named
    by the sha256 prefix of `name_payload` (default: of the payload), and an
    empty cache; returns the cache directory the download lands in."""
    name = _fake_entry(monkeypatch, payload if name_payload is None else name_payload,
                       experiment=experiment, stem=stem)
    src = tmp_path / 'release' / name
    src.parent.mkdir()
    src.write_bytes(payload)
    monkeypatch.setitem(pretrained.WEIGHTS_URL, experiment, src.as_uri())
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(tmp_path / 'empty'))
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'xdg'))
    return tmp_path / 'xdg' / 'parseq_tpu' / 'checkpoints'


def test_download_lands_in_the_cache_and_loads(tmp_path, monkeypatch):
    tb = registry.create_model('parseq-tiny', seed=5, device='cpu', dtype=torch.float32)
    with torch.no_grad():
        want = tb(_images())
    buf = tmp_path / 'w.pt'
    torch.save(tb.module.state_dict(), buf)
    cache = _served(tmp_path, monkeypatch, buf.read_bytes(), 'parseq-tiny', 'parseq_tiny')
    path = pretrained.get_pretrained_path('parseq-tiny')
    assert path.parent == cache and path.read_bytes() == buf.read_bytes()
    assert [p.name for p in cache.iterdir()] == [path.name]  # no .partial left
    assert pretrained.find_cached('parseq-tiny') == path
    torch.testing.assert_close(_logits('pretrained=parseq-tiny'), want, rtol=0, atol=0)


def test_download_with_a_bad_hash_raises_and_leaves_nothing(tmp_path, monkeypatch):
    cache = _served(tmp_path, monkeypatch, b'tampered weights', 'fake-model', 'fake_model',
                    name_payload=b'released weights')
    with pytest.raises(pretrained.PretrainedWeightsError, match='sha256'):
        pretrained.get_pretrained_path('fake-model')
    assert list(cache.iterdir()) == []
    with pytest.raises(pretrained.PretrainedWeightsError, match='sha256'):
        pretrained.download('fake-model', dest_dir=tmp_path / 'dest')
    assert list((tmp_path / 'dest').iterdir()) == []


def test_no_download_when_the_flag_is_off(tmp_path, monkeypatch):
    _served(tmp_path, monkeypatch, b'weights', 'fake-model', 'fake_model')
    fetched = []
    monkeypatch.setattr(pretrained, 'download', lambda *a, **k: fetched.append(a))
    with pytest.raises(pretrained.PretrainedWeightsError, match='not found in cache'):
        pretrained.get_pretrained_path('fake-model', download_if_missing=False)
    with pytest.raises(pretrained.PretrainedWeightsError, match='not found in cache'):
        pretrained.load_pretrained('fake-model', download_if_missing=False, device='cpu')
    assert fetched == []
