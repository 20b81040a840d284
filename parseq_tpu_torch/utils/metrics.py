"""Evaluation metrics (port of parseq_tpu/utils/metrics.py; reference
base.py:112-143 semantics). Edit distances use the pure-Python DP; the JAX
package's native editdist.cpp batch core is not ported yet (ROADMAP)."""

from __future__ import annotations

import numpy as np


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
    return np.asarray([edit_distance(p, g) for p, g in zip(preds, gts)], np.int32)


def ned_batch(preds, gts) -> np.ndarray:
    """ICDAR 2019 normalized edit distance terms, batched."""
    d = edit_distance_batch(preds, gts).astype(np.float64)
    denom = np.asarray([max(len(p), len(g)) for p, g in zip(preds, gts)], np.float64)
    return np.where(denom > 0, d / np.maximum(denom, 1), 0.0)
