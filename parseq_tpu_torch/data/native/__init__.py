"""ctypes bindings for the port's native LMDB reader and JPEG decoder
(counterpart of parseq_tpu/data/native/__init__.py).

`lmdb_reader.cpp` and `jpeg_decode.cpp` are built with g++ on first use
into build/native/ (utils/native_build.py), each loaded on its own.
`load()` / `load_jpeg()` return None only when the toolchain is absent (no
g++, or no jpeglib.h for the decoder): callers then take the pure-Python
LMDB reader or PIL. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from parseq_tpu_torch.utils import native_build

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / 'lmdb_reader.cpp'
_JPEG_SRC = _HERE / 'jpeg_decode.cpp'


def load():
    """-> ctypes CDLL with the parseq_lmdb_* symbols, or None without g++."""
    lib = native_build.load('lmdb_reader', _SRC)
    if lib is not None and not getattr(lib, '_bound', False):
        lib.parseq_lmdb_open.argtypes = [ctypes.c_char_p]
        lib.parseq_lmdb_close.argtypes = [ctypes.c_void_p]
        lib.parseq_lmdb_close.restype = None
        lib.parseq_lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.parseq_lmdb_entries.restype = ctypes.c_uint64
        lib.parseq_lmdb_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.parseq_lmdb_get.restype = ctypes.c_void_p
        lib.parseq_lmdb_open.restype = ctypes.c_void_p
        lib._bound = True
    return lib


def load_jpeg():
    """-> ctypes CDLL with the parseq_jpeg_* / parseq_bicubic_u8 symbols, or
    None without g++ or jpeglib.h."""
    lib = native_build.load('jpeg_decode', _JPEG_SRC, ('-O3', '-ljpeg'), headers=('jpeglib.h',))
    if lib is not None and not getattr(lib, '_bound', False):
        lib.parseq_jpeg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p]
        lib.parseq_jpeg_decode_resize.restype = ctypes.c_int
        lib.parseq_bicubic_u8.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        lib.parseq_bicubic_u8.restype = None
        lib.parseq_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
        lib.parseq_jpeg_dims.restype = ctypes.c_int
        lib.parseq_jpeg_lib_version.argtypes = [ctypes.POINTER(ctypes.c_char_p)]
        lib.parseq_jpeg_lib_version.restype = ctypes.c_int
        lib.parseq_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.parseq_jpeg_decode.restype = ctypes.c_int
        lib._bound = True
    return lib


def jpeg_lib_version():
    """(JPEG_LIB_VERSION, LIBJPEG_TURBO_VERSION) of the decoder's build, or
    None when it is not built."""
    lib = load_jpeg()
    if lib is None:
        return None
    turbo = ctypes.c_char_p()
    return int(lib.parseq_jpeg_lib_version(ctypes.byref(turbo))), turbo.value.decode()


def jpeg_decode_resize(data, img_size=(32, 128)):
    """JPEG bytes -> (H, W, 3) uint8 resized with PIL-exact bicubic, or None
    (not a JPEG, CMYK/YCCK, a decode error, or no native decoder: the caller
    uses PIL).

    Bit-identical to Image.open + draft + convert('RGB') + BICUBIC resize
    (preprocess_pil_u8's default path, libjpeg's DCT-scaled decode on) when
    the build links the libjpeg-turbo that Pillow bundles
    (tests/test_torch_native.py)."""
    lib = load_jpeg()
    if lib is None:
        return None
    data = bytes(data)
    h, w = img_size
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.parseq_jpeg_decode_resize(data, len(data), w, h, 1,
                                       out.ctypes.data_as(ctypes.c_char_p))
    return out if rc == 0 else None


def jpeg_decode(data):
    """JPEG bytes -> full-resolution (H, W, 3) uint8 RGB, or None.

    The training path's decode: augmentation must see the full-resolution
    image before any resize (reference transform order, strhub/data/
    module.py:68-82). Grayscale sources come back as replicated-channel RGB,
    as Image.convert('RGB') gives them."""
    lib = load_jpeg()
    if lib is None:
        return None
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.parseq_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.parseq_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.c_char_p))
    return out if rc == 0 else None


def bicubic_resize_u8(arr, img_size=(32, 128)):
    """(H, W, 3) uint8 RGB -> PIL-exact bicubic resize to img_size, or None
    (not (H, W, 3), or no native decoder)."""
    lib = load_jpeg()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return None
    in_h, in_w = arr.shape[:2]
    h, w = img_size
    out = np.empty((h, w, 3), np.uint8)
    lib.parseq_bicubic_u8(arr.ctypes.data_as(ctypes.c_char_p), in_w, in_h, w, h,
                          out.ctypes.data_as(ctypes.c_char_p))
    return out


class NativeLmdbReader:
    """Same read API as data.lmdb.LmdbReader, backed by the C++ core."""

    def __init__(self, path, lib=None):
        self._lib = lib or load()
        if self._lib is None:
            raise RuntimeError('native LMDB reader unavailable (no g++)')
        p = Path(path)
        if p.is_dir():
            p = p / 'data.mdb'
        self.path = p
        self._h = self._lib.parseq_lmdb_open(str(p).encode())
        if not self._h:
            raise OSError(f'{p}: not a readable LMDB database')

    def close(self):
        if self._h:
            self._lib.parseq_lmdb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        return int(self._lib.parseq_lmdb_entries(self._h))

    def get(self, key: bytes):
        vlen = ctypes.c_size_t()
        ptr = self._lib.parseq_lmdb_get(self._h, key, len(key), ctypes.byref(vlen))
        if not ptr:
            return None
        return ctypes.string_at(ptr, vlen.value)
