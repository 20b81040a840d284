"""Evaluation: accuracy / NED / confidence accumulation, evaluation of a
model over a loader, and the results table (port of
parseq_tpu/train/evaluate.py; reference base.py:112-164 and test.py:30-66).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from parseq_tpu_torch.train.steps import normalize_u8
from parseq_tpu_torch.utils import trace
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


def score_batch(tokenizer, charset_adapter, probs, labels, valid=None,
                loss=0.0, loss_numel=0) -> BatchResult:
    """probs: (B, L, C) softmax outputs; labels: list[str] ground truth."""
    preds, pred_probs = tokenizer.decode(np.asarray(probs))
    return score_decoded(charset_adapter, preds, pred_probs, labels, valid,
                         loss, loss_numel)


def _device_post(logits):
    """Softmax, argmax and the picked probability on the logits' device, so
    only ids and probabilities (B, L) go to the host."""
    probs = torch.softmax(logits.float(), dim=-1)
    ids = probs.argmax(-1)
    return ids, probs.gather(-1, ids[..., None])[..., 0]


def eval_dataset(model, loader, name='val') -> Result:
    """Run a ModelBundle over a loader of (images (B, H, W, 3) uint8 or
    float, labels, valid); returns the aggregated Result.

    On the device: u8 -> [-1, 1] normalisation, the bundle's forward,
    softmax, argmax and gather. The ids and picked
    probabilities are copied to the host without blocking, so the next
    batch is queued on the device while the host decodes and scores this
    one (one batch in flight). Each stage is a span (utils/trace.py):
    eval.next, eval.h2d, eval.forward, and for the batch in flight
    eval.wait, eval.decode and eval.score, each with the batch's index."""
    total = BatchResult()
    pending = None

    def finish(item):
        i, done, ids, conf, labels, valid = item
        with trace.span('eval.wait', batch=i):
            if done is not None:
                done.synchronize()
        with trace.span('eval.decode', batch=i):
            preds, pred_probs = model.tokenizer.decode_ids(ids.numpy(), conf.numpy())
        with trace.span('eval.score', batch=i):
            total.add(score_decoded(model.charset_adapter, preds, pred_probs, labels, valid))

    it = iter(loader)
    for i in itertools.count():
        with trace.span('eval.next', batch=i):
            item = next(it, None)
        if item is None:
            break
        images, labels, valid = item
        with trace.span('eval.h2d', batch=i):
            x = torch.as_tensor(images).to(model.device)
        with trace.span('eval.forward', batch=i), torch.inference_mode():
            if x.dtype == torch.uint8:
                x = normalize_u8(x)
            ids, conf = _device_post(model(x))
            ids, conf = ids.to('cpu', non_blocking=True), conf.to('cpu', non_blocking=True)
            done = None
            if model.device.type == 'cuda':
                done = torch.cuda.Event()
                done.record()
        if pending is not None:
            finish(pending)
        pending = (i, done, ids, conf, labels, valid)
    if pending is not None:
        finish(pending)
    return summarize(name, total)


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


def print_results_table(results: list[Result], file=None):
    """Markdown results table, reference format (test.py:40-66)."""
    w = max([len(r.dataset) for r in results] + [len('Dataset'), len('Combined')])
    print('| {:<{w}} | # samples | Accuracy | 1 - NED | Confidence | Label Length |'.format('Dataset', w=w), file=file)
    print('|:{:-<{w}}:|----------:|---------:|--------:|-----------:|-------------:|'.format('----', w=w), file=file)
    c = Result('Combined', 0, 0.0, 0.0, 0.0, 0.0)
    for res in results:
        c.num_samples += res.num_samples
        c.accuracy += res.num_samples * res.accuracy
        c.ned += res.num_samples * res.ned
        c.confidence += res.num_samples * res.confidence
        c.label_length += res.num_samples * res.label_length
        print(
            f'| {res.dataset:<{w}} | {res.num_samples:>9} | {res.accuracy:>8.2f} | {res.ned:>7.2f} '
            f'| {res.confidence:>10.2f} | {res.label_length:>12.2f} |',
            file=file,
        )
    n = max(c.num_samples, 1)
    c.accuracy /= n
    c.ned /= n
    c.confidence /= n
    c.label_length /= n
    print('|-{:-<{w}}-|-----------|----------|---------|------------|--------------|'.format('----', w=w), file=file)
    print(
        f'| {c.dataset:<{w}} | {c.num_samples:>9} | {c.accuracy:>8.2f} | {c.ned:>7.2f} '
        f'| {c.confidence:>10.2f} | {c.label_length:>12.2f} |',
        file=file,
    )
