"""Minimal TensorBoard event-file writer (no tensorflow/tensorboard dep).

The reference logs scalars through Lightning's TensorBoardLogger
(reference train.py:101-107); this module reproduces the on-disk format
from scratch so runs are viewable in TensorBoard without pulling the
tensorflow stack into the training process:

- TFRecord framing: little-endian uint64 length, masked CRC32C of the
  length bytes, payload, masked CRC32C of the payload.
- Payloads are hand-encoded `tensorflow.Event` protobufs: wall_time
  (field 1, double), step (field 2, varint), and either file_version
  (field 3, string — first record, "brain.Event:2") or summary
  (field 5) holding Summary.Value{tag, simple_value} messages.

Validated round-trip against the real TensorBoard reader in
tests/test_tbevents.py.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------- crc32c ---

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord CRC mask: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding ---


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_summary_value(tag: str, value: float) -> bytes:
    """Summary.Value: tag (field 1, string) + simple_value (field 2, float)."""
    t = tag.encode('utf-8')
    return (_len_delim(1, t)
            + _tag(2, 5) + struct.pack('<f', float(value)))


def encode_event(wall_time: float, step: int | None = None,
                 scalars: dict[str, float] | None = None,
                 file_version: str | None = None) -> bytes:
    ev = _tag(1, 1) + struct.pack('<d', wall_time)  # wall_time: double
    if step is not None:
        ev += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)  # step: int64
    if file_version is not None:
        ev += _len_delim(3, file_version.encode('utf-8'))
    if scalars:
        summary = b''.join(_len_delim(1, encode_summary_value(k, v))
                           for k, v in scalars.items())
        ev += _len_delim(5, summary)
    return ev


def frame_record(payload: bytes) -> bytes:
    """TFRecord: len(8) + masked_crc(len)(4) + payload + masked_crc(payload)(4)."""
    header = struct.pack('<Q', len(payload))
    return (header + struct.pack('<I', masked_crc(header))
            + payload + struct.pack('<I', masked_crc(payload)))


# ---------------------------------------------------------------- writer ---


class TBEventWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    Usage:
        w = TBEventWriter(logdir)
        w.add_scalars(step, {'train/loss': 1.2, 'lr': 3e-4})
        w.close()
    """

    def __init__(self, logdir: str | os.PathLike):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        self.path = logdir / f'events.out.tfevents.{int(time.time())}.{host}'
        self._f = open(self.path, 'ab')
        # The version record must be first in the file.
        self._write(encode_event(time.time(), file_version='brain.Event:2'))

    def _write(self, payload: bytes):
        self._f.write(frame_record(payload))

    def add_scalar(self, step: int, tag: str, value: float):
        self.add_scalars(step, {tag: value})

    def add_scalars(self, step: int, scalars: dict[str, float]):
        # float(v) handles numpy/device scalars too (np.float32 is not a
        # builtin-float subclass); non-numerics and NaN are dropped.
        vals = {}
        for k, v in scalars.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if f == f:  # drop NaN
                vals[k] = f
        if vals:
            self._write(encode_event(time.time(), step=int(step), scalars=vals))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------- reader ---
# Own-format reader used by tests and the jsonl converter's --check mode; the
# authoritative cross-check in tests uses TensorBoard's EventAccumulator.


def read_events(path: str | os.PathLike):
    """Parse a tfevents file back into (step, {tag: value}) tuples."""
    raw = Path(path).read_bytes()
    out = []
    off = 0
    while off < len(raw):
        (n,) = struct.unpack_from('<Q', raw, off)
        (len_crc,) = struct.unpack_from('<I', raw, off + 8)
        if len_crc != masked_crc(raw[off:off + 8]):
            raise ValueError(f'bad length crc at offset {off}')
        payload = raw[off + 12:off + 12 + n]
        (data_crc,) = struct.unpack_from('<I', raw, off + 12 + n)
        if data_crc != masked_crc(payload):
            raise ValueError(f'bad payload crc at offset {off}')
        off += 16 + n
        ev = _parse_event(payload)
        if ev is not None:
            out.append(ev)
    return out


def _read_varint(buf, off):
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _parse_event(buf: bytes):
    step, scalars = 0, {}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
            if field == 2:
                step = val
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            n, off = _read_varint(buf, off)
            payload = buf[off:off + n]
            off += n
            if field == 5:  # summary
                scalars.update(_parse_summary(payload))
        else:
            raise ValueError(f'unsupported wire type {wire}')
    return (step, scalars) if scalars else None


def _parse_summary(buf: bytes):
    scalars = {}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire != 2:
            raise ValueError('unexpected non-message field in Summary')
        n, off = _read_varint(buf, off)
        if field == 1:
            scalars.update(_parse_value(buf[off:off + n]))
        off += n
    return scalars


def _parse_value(buf: bytes):
    tag, val = None, None
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 2:
            n, off = _read_varint(buf, off)
            if field == 1:
                tag = buf[off:off + n].decode('utf-8')
            off += n
        elif wire == 5:
            if field == 2:
                (val,) = struct.unpack_from('<f', buf, off)
            off += 4
        elif wire == 0:
            _, off = _read_varint(buf, off)
        elif wire == 1:
            off += 8
    return {tag: val} if tag is not None and val is not None else {}
