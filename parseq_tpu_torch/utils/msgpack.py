"""Read-only decoder of the msgpack that flax.serialization.msgpack_serialize
writes (the JAX package's `.ckpt`, parseq_tpu/utils/checkpoint.py), without
the `msgpack` package, which the GPU host lacks.

Decodes maps, arrays, str, bin, nil, bools, ints and floats as
msgpack.unpackb(raw=False) does (arrays as lists), and flax's two extension
types of a checkpoint:

  * ext 1, an ndarray: a packed (shape, dtype name, C-order bytes), read as a
    read-only numpy array over those bytes; a `bfloat16` leaf (no numpy
    dtype) as a torch.bfloat16 tensor viewed from uint16;
  * ext 3, a numpy scalar: the same payload at shape ().

`restore` also reassembles flax's chunked arrays (the
'__msgpack_chunked_array__' maps that leaves over 2**30 bytes are split
into). Anything else (ext 2, a complex number; other ext types; the unused
code 0xc1; a truncated or trailing buffer) raises MsgpackError.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

CHUNKED = '__msgpack_chunked_array__'
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class MsgpackError(ValueError):
    pass


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast('B')
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise MsgpackError(f'truncated msgpack: {n} bytes wanted at offset {self.pos} '
                               f'of {len(self.buf)}')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def str(self, n):
        return str(self.take(n), 'utf-8')

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code, n):
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f'msgpack ext type {code} is not one a flax checkpoint holds '
                               f'(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})')
        arr = _ndarray(data)
        return arr if code == EXT_NDARRAY else arr[()]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.str(c & 0x1f)
        if c in _FIXED:
            return _FIXED[c]
        if c in _SCALARS:
            return self.unpack(_SCALARS[c])
        if c in _SIZED:
            kind, fmt = _SIZED[c]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'ext':
                return self.ext(self.unpack('>b'), n)
            return getattr(self, kind)(n)
        if 0xd4 <= c <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack('>b'), 1 << (c - 0xd4))
        raise MsgpackError(f'msgpack code {c:#04x} at offset {self.pos - 1} is not valid')


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_SCALARS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
            0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
_SIZED = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
          0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
          0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
          0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
          0xde: ('map', '>H'), 0xdf: ('map', '>I')}


def _ndarray(data):
    """flax's ndarray payload -> numpy array (a torch bf16 tensor for bfloat16)."""
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    if not (isinstance(shape, list) and isinstance(name, str) and isinstance(buf, bytes)):
        raise MsgpackError(f'malformed flax ndarray payload: {type(shape).__name__}, '
                           f'{type(name).__name__}, {type(buf).__name__}')
    if name == 'bfloat16':
        return torch.from_numpy(np.frombuffer(buf, np.uint16).reshape(shape).copy()).view(
            torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f'flax ndarray of dtype {name!r}, which numpy does not know') from e
    return np.frombuffer(buf, dtype).reshape(shape)


def unpackb(data):
    """msgpack bytes -> Python objects (flax ndarray / numpy-scalar leaves
    decoded). Raises MsgpackError on anything else."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise MsgpackError(f'{len(r.buf) - r.pos} bytes after the msgpack object')
    return out


def _unchunk(d):
    """flax's chunked-array map -> the array it was split from."""
    try:
        shape = [d['shape'][str(i)] for i in range(len(d['shape']))]
        chunks = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    except (KeyError, TypeError) as e:
        raise MsgpackError(f'malformed {CHUNKED} map (keys {sorted(d)})') from e
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _restore_chunks(obj):
    if isinstance(obj, dict):
        if CHUNKED in obj:
            return _unchunk(obj)
        return {k: _restore_chunks(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_chunks(v) for v in obj]
    return obj


def restore(data):
    """flax.serialization.msgpack_restore's counterpart: unpackb, then every
    chunked array reassembled."""
    return _restore_chunks(unpackb(data))


def looks_like_msgpack_map(head: bytes) -> bool:
    """True if `head` (a file's first bytes) starts a non-empty msgpack map,
    as a flax checkpoint does (a legacy torch.save pickle starts
    b'\\x80\\x02', which would be an empty map followed by more)."""
    return bool(head) and (0x81 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))
