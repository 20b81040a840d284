"""Evaluation metrics (port of parseq_tpu/utils/metrics.py; reference
base.py:112-143 semantics).

`edit_distance_batch` scores a whole batch through the C++ core
`utils/editdist.cpp` (built with g++ on first use into build/native/,
utils/native_build.py): strings go in as UTF-32 code points, concatenated,
with offsets. The per-pair Python DP `edit_distance` is its plain version,
used only when the toolchain is absent.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from parseq_tpu_torch.utils import native_build

_SRC = Path(__file__).resolve().parent / 'editdist.cpp'


def load():
    """The editdist library (built on first use), or None without g++."""
    lib = native_build.load('editdist', _SRC)
    if lib is not None and not getattr(lib, '_bound', False):
        u32p = np.ctypeslib.ndpointer(np.uint32, flags='C_CONTIGUOUS')
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        lib.parseq_editdist_batch.argtypes = [u32p, i64p, u32p, i64p, ctypes.c_int64, i32p]
        lib.parseq_editdist_batch.restype = None
        lib._bound = True
    return lib


def _pack(strings):
    """list[str] -> (flat uint32 code points, int64 offsets[n+1])."""
    offsets = np.zeros(len(strings) + 1, np.int64)
    np.cumsum([len(s) for s in strings], out=offsets[1:])
    flat = np.frombuffer(''.join(strings).encode('utf-32-le'), np.uint32)
    return np.ascontiguousarray(flat), offsets


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (insert/delete/substitute, unit costs) — the same
    metric as nltk.edit_distance used by the reference (base.py:21,138)."""
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_distance_batch(preds, gts) -> np.ndarray:
    """Levenshtein distance for each (pred, gt) pair -> int32 (N,)."""
    if len(preds) != len(gts):
        raise ValueError(f'{len(preds)} predictions for {len(gts)} labels')
    lib = load()
    if lib is None:
        return np.asarray([edit_distance(p, g) for p, g in zip(preds, gts)], np.int32)
    a, ao = _pack(preds)
    b, bo = _pack(gts)
    out = np.empty(len(preds), np.int32)
    lib.parseq_editdist_batch(a, ao, b, bo, len(preds), out)
    return out


def ned_batch(preds, gts) -> np.ndarray:
    """ICDAR 2019 normalized edit distance terms, batched."""
    d = edit_distance_batch(preds, gts).astype(np.float64)
    denom = np.asarray([max(len(p), len(g)) for p, g in zip(preds, gts)], np.float64)
    return np.where(denom > 0, d / np.maximum(denom, 1), 0.0)
