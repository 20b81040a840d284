"""Evaluation: accuracy / NED / confidence accumulation (port of
parseq_tpu/train/evaluate.py; reference base.py:112-164 and test.py:30-66)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from parseq_tpu_torch.utils.metrics import ned_batch


@dataclass
class BatchResult:
    num_samples: int = 0
    correct: int = 0
    ned: float = 0.0
    confidence: float = 0.0
    label_length: int = 0
    loss: float = 0.0
    loss_numel: int = 0

    def add(self, other: 'BatchResult'):
        self.num_samples += other.num_samples
        self.correct += other.correct
        self.ned += other.ned
        self.confidence += other.confidence
        self.label_length += other.label_length
        self.loss += other.loss * other.loss_numel
        self.loss_numel += other.loss_numel


@dataclass
class Result:
    dataset: str
    num_samples: int
    accuracy: float
    ned: float
    confidence: float
    label_length: float


def score_decoded(charset_adapter, preds, pred_probs, labels, valid=None,
                  loss=0.0, loss_numel=0) -> BatchResult:
    """Score already-decoded predictions against ground truth."""
    r = BatchResult(loss=float(loss), loss_numel=int(loss_numel))
    keep = [i for i in range(len(labels)) if valid is None or valid[i]]
    kept_preds = [charset_adapter(preds[i]) for i in keep]
    kept_gts = [labels[i] for i in keep]
    neds = ned_batch(kept_preds, kept_gts)
    for pred, gt, nd, i in zip(kept_preds, kept_gts, neds, keep):
        r.confidence += float(np.prod(pred_probs[i]))
        r.ned += float(nd)
        if pred == gt:
            r.correct += 1
        r.num_samples += 1
        r.label_length += len(pred)
    return r


def summarize(name: str, t: BatchResult) -> Result:
    n = max(t.num_samples, 1)
    return Result(
        dataset=name,
        num_samples=t.num_samples,
        accuracy=100.0 * t.correct / n,
        ned=100.0 * (1 - t.ned / n),
        confidence=100.0 * t.confidence / n,
        label_length=t.label_length / n,
    )
