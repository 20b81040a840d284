"""The port's native host helpers (utils/native_build.py, utils/editdist.cpp,
data/native/lmdb_reader.cpp and jpeg_decode.cpp) against their plain
versions (the Python DP, the Python LMDB reader, PIL) and against the JAX
package's native helpers, on seeded inputs. This host has g++ and
jpeglib.h, so every helper must build here: nothing skips. Also the
narrow fallback (no g++ on PATH: a WARNING and status()) and a planted
syntax error, which must raise."""

import io
import logging
import random
import shutil

import numpy as np
import pytest
from PIL import Image

from parseq_tpu.data import lmdb as jlmdb
from parseq_tpu.data import native as jnative
from parseq_tpu.utils import metrics as jmetrics
from parseq_tpu_torch.data import lmdb as tlmdb
from parseq_tpu_torch.data import native
from parseq_tpu_torch.data.module import get_transform
from parseq_tpu_torch.data.transforms import decode_u8, preprocess_pil_u8
from parseq_tpu_torch.utils import metrics, native_build

from .test_lmdb_fuzz import PAGE_HDR, PAGE_SIZE, _random_kv


@pytest.fixture(autouse=True)
def _fresh_helpers():
    """Each test decides the route again (one test takes g++ off PATH)."""
    native_build.reset()
    yield
    native_build.reset()


def test_every_helper_builds_into_build_native():
    assert metrics.load() is not None
    assert native.load() is not None and native.load_jpeg() is not None
    st = native_build.status()
    assert st['g++'] and st['jpeglib.h']
    assert {k: v['route'] for k, v in st['helpers'].items()} == {
        'editdist': 'native', 'lmdb_reader': 'native', 'jpeg_decode': 'native'}
    for v in st['helpers'].values():
        assert v['library'].startswith(str(native_build.BUILD_DIR) + '/')
    turbo = native.jpeg_lib_version()
    assert turbo is not None and turbo[0] >= 62


# ------------------------------------------------------------ edit distance --

ASTRAL = '\U0001F600\U00010348\U0001D11E'


def _pairs(seed, n=300):
    rng = random.Random(seed)
    alphabet = 'abcde' + ASTRAL + 'éß'
    out = [('', ''), ('', 'abc'), ('xyz', ''), (ASTRAL, ASTRAL[::-1]), ('kitten', 'sitting')]
    while len(out) < n:
        a = ''.join(rng.choice(alphabet) for _ in range(rng.randint(0, 30)))
        b = ''.join(rng.choice(alphabet) for _ in range(rng.randint(0, 30)))
        out.append((a, b))
    return [p for p, _ in out], [g for _, g in out]


@pytest.mark.parametrize('seed', range(3))
def test_edit_distance_batch_equals_the_dp_and_jax(seed):
    preds, gts = _pairs(seed)
    assert metrics.load() is not None
    got = metrics.edit_distance_batch(preds, gts)
    assert got.dtype == np.int32
    want = [metrics.edit_distance(p, g) for p, g in zip(preds, gts)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jmetrics.edit_distance_batch(preds, gts))
    np.testing.assert_array_equal(metrics.ned_batch(preds, gts), jmetrics.ned_batch(preds, gts))


def test_edit_distance_batch_empty_batch_and_length_mismatch():
    assert metrics.edit_distance_batch([], []).shape == (0,)
    with pytest.raises(ValueError, match='predictions'):
        metrics.edit_distance_batch(['a'], [])


# ------------------------------------------------------------------- LMDB ---


def _boundary_kv():
    key = b'k' * 8
    sizes = set()
    for base in (0, 1, 2, 100, 2000, 2010, 2020, 2022, 2023, 2024, 2030,
                 PAGE_SIZE - PAGE_HDR, PAGE_SIZE, 2 * PAGE_SIZE - PAGE_HDR,
                 2 * PAGE_SIZE, 5 * PAGE_SIZE + 1):
        for d in (-1, 0, 1):
            if base + d >= 0:
                sizes.add(base + d)
    return {b'%s%06d' % (key, s): bytes((s + i) % 256 for i in range(s)) for s in sorted(sizes)}


def _key_shapes_kv():
    kv = {b'\x00': b'nul', b'\xff' * 511: b'max', b'a' * 511: b'longa', b'a' * 510 + b'b': b'lb'}
    for i in range(256):
        kv[bytes([i]) + b'\x00' * 3] = b'v%d' % i
    prefix = b'p' * 300
    for i in range(64):
        kv[prefix + bytes([i])] = prefix + b'=%d' % i
    return kv


LMDB_CASES = {
    'empty': lambda: {},
    'single': lambda: {b'only': b'x' * 10},
    'overflow_boundaries': _boundary_kv,
    'key_shapes': _key_shapes_kv,
    'deep_tree': lambda: {b'%0507d-' % i + b'kkk': b'v%d' % i for i in range(600)},
    'fuzz_150': lambda: _random_kv(random.Random(7), 150),
    'fuzz_800': lambda: _random_kv(random.Random(8), 800),
}


@pytest.mark.parametrize('case', sorted(LMDB_CASES))
def test_native_lmdb_reader_equals_python_and_jax_readers(tmp_path, case):
    """An LMDB from the JAX package's writer: the port's native reader, its
    Python reader and both JAX readers give the same values, lengths and
    misses (probes: each key with a byte added or dropped, random keys)."""
    kv = LMDB_CASES[case]()
    path = tmp_path / case
    with jlmdb.LmdbWriter(path) as w:
        for k, v in kv.items():
            w.put(k, v)
    rng = random.Random(0)
    probes = list(kv) + [k + b'\x00' for k in list(kv)[:50]] + [k[:-1] for k in list(kv)[:50]
                                                                  if len(k) > 1]
    probes += [rng.randbytes(rng.randint(1, 64)) for _ in range(50)]
    with native.NativeLmdbReader(path) as nat, tlmdb.LmdbReader(path) as py, \
            jlmdb.LmdbReader(path) as jpy, jnative.NativeLmdbReader(path) as jnat:
        assert len(nat) == len(py) == len(jpy) == len(jnat) == len(kv)
        for k in probes:
            got = nat.get(k)
            assert got == py.get(k) == jpy.get(k) == jnat.get(k) == kv.get(k), k


def test_open_reader_prefers_the_native_reader(tmp_path):
    path = tmp_path / 'db'
    with tlmdb.LmdbWriter(path) as w:
        w.put(b'num-samples', b'0')
    with tlmdb.open_reader(path) as r:
        assert isinstance(r, native.NativeLmdbReader) and r.get(b'num-samples') == b'0'
    bad = tmp_path / 'bad'
    bad.mkdir()
    (bad / 'data.mdb').write_bytes(b'\x00' * 3 * PAGE_SIZE)
    with pytest.raises(tlmdb.LmdbError):  # the Python reader names the fault
        tlmdb.open_reader(bad)


# ------------------------------------------------------------------- JPEG ---


def _jpeg(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, 'JPEG', **kw)
    return buf.getvalue()


# (w, h, mode, save options): gray and YCbCr sources, baseline and
# progressive, sizes on both sides of the DCT-scaled (draft) decode's
# thresholds at 32x128 (2x, 4x, 8x the target).
JPEG_CASES = {
    'rgb_small': (90, 28, 'RGB', {}),
    'gray': (100, 32, 'L', {}),
    'rgb_odd': (257, 65, 'RGB', {}),
    'rgb_2x': (256, 64, 'RGB', {}),
    'gray_4x': (520, 130, 'L', {}),
    'rgb_8x': (1030, 260, 'RGB', {}),
    'progressive': (300, 80, 'RGB', {'progressive': True}),
    'progressive_gray': (600, 150, 'L', {'progressive': True}),
    'subsampling_444': (200, 50, 'RGB', {'subsampling': 0, 'quality': 95}),
}


@pytest.mark.parametrize('case', sorted(JPEG_CASES))
def test_jpeg_decode_bit_equal_to_pil_and_jax(case):
    w, h, mode, kw = JPEG_CASES[case]
    rng = np.random.default_rng(sorted(JPEG_CASES).index(case))
    arr = rng.integers(0, 256, (h, w) if mode == 'L' else (h, w, 3), dtype=np.uint8)
    data = _jpeg(arr, mode, quality=kw.pop('quality', 85), **kw)
    pil = preprocess_pil_u8(Image.open(io.BytesIO(data)))
    got = native.jpeg_decode_resize(data, (32, 128))
    assert got is not None and got.shape == (32, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jnative.jpeg_decode_resize(data, (32, 128)))
    full = native.jpeg_decode(data)
    np.testing.assert_array_equal(full, np.asarray(Image.open(io.BytesIO(data)).convert('RGB')))
    np.testing.assert_array_equal(full, jnative.jpeg_decode(data))
    resized = native.bicubic_resize_u8(full, (32, 128))
    np.testing.assert_array_equal(resized, np.asarray(
        Image.fromarray(full).resize((128, 32), Image.Resampling.BICUBIC)))


def test_non_jpeg_and_cmyk_go_to_pil():
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (20, 40, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'PNG')
    png = buf.getvalue()
    assert native.jpeg_decode_resize(png) is None and native.jpeg_decode(png) is None
    np.testing.assert_array_equal(decode_u8(png), preprocess_pil_u8(Image.open(io.BytesIO(png))))
    buf = io.BytesIO()
    Image.fromarray(arr).convert('CMYK').save(buf, 'JPEG')
    cmyk = buf.getvalue()
    assert native.jpeg_decode_resize(cmyk) is None and native.jpeg_decode(cmyk) is None
    np.testing.assert_array_equal(decode_u8(cmyk),
                                  preprocess_pil_u8(Image.open(io.BytesIO(cmyk))))
    assert native.bicubic_resize_u8(np.zeros((4, 4), np.uint8)) is None


def test_transform_routes_jpegs_through_the_native_decoder(monkeypatch):
    """Eval u8 path: the fused decode+resize, equal to PIL's; augment path:
    the full-resolution decode; a rotation takes PIL."""
    rng = np.random.default_rng(1)
    data = _jpeg(rng.integers(0, 256, (70, 260, 3), dtype=np.uint8), 'RGB')
    pil = preprocess_pil_u8(Image.open(io.BytesIO(data)))
    calls = []
    for name in ('jpeg_decode_resize', 'jpeg_decode'):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n)
                            or _f(*a, **k))
    np.testing.assert_array_equal(get_transform((32, 128), u8=True)(data), pil)
    assert calls == ['jpeg_decode_resize']
    out = get_transform((32, 128), augment=True, u8=True)(data)
    assert calls == ['jpeg_decode_resize', 'jpeg_decode'] and out.shape == (32, 128, 3)
    get_transform((32, 128), u8=True, rotation=90)(data)
    assert calls == ['jpeg_decode_resize', 'jpeg_decode']
    np.testing.assert_array_equal(decode_u8(data), pil)


# --------------------------------------------------------------- fallback ---


def test_without_gxx_each_helper_warns_and_falls_back(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv('PATH', str(tmp_path))  # an empty directory: no g++
    caplog.set_level(logging.WARNING, logger=native_build.__name__)
    assert metrics.load() is None and native.load() is None and native.load_jpeg() is None
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 3 and all('no g++ on PATH' in r.getMessage() for r in warned)
    st = native_build.status()
    assert st['g++'] is None and st['jpeglib.h'] is False
    assert all(v == {'route': 'python', 'reason': 'no g++ on PATH'}
               for v in st['helpers'].values()) and len(st['helpers']) == 3
    # the plain versions carry on
    preds, gts = _pairs(0, 40)
    np.testing.assert_array_equal(metrics.edit_distance_batch(preds, gts),
                                  [metrics.edit_distance(p, g) for p, g in zip(preds, gts)])
    path = tmp_path / 'db'
    with tlmdb.LmdbWriter(path) as w:
        w.put(b'k', b'v')
    with tlmdb.open_reader(path) as r:
        assert isinstance(r, tlmdb.LmdbReader) and r.get(b'k') == b'v'
    assert len(caplog.records) == 3  # one WARNING a helper, not one a call


def test_missing_header_falls_back_and_is_reported(caplog):
    caplog.set_level(logging.WARNING, logger=native_build.__name__)
    assert native_build.load('needs_header', native.__file__,
                             headers=('no_such_header_for_parseq.h',)) is None
    reason = native_build.status()['helpers']['needs_header']['reason']
    assert 'no_such_header_for_parseq.h' in reason and reason in caplog.text


def test_a_planted_syntax_error_raises(tmp_path):
    src = tmp_path / 'editdist.cpp'
    shutil.copy(metrics._SRC, src)
    src.write_text(src.read_text().replace('out[i] = prev[lb];', 'out[i] = prev[lb]'))
    with pytest.raises(native_build.NativeBuildError, match='g\\+\\+ failed'):
        native_build.load('editdist_planted', src)
    assert 'editdist_planted' not in native_build.status()['helpers']
    assert not list(native_build.BUILD_DIR.glob('libeditdist_planted.so*'))
    with pytest.raises(native_build.NativeBuildError, match='missing'):
        native_build.ensure_built('nothing', tmp_path / 'missing.cpp')
