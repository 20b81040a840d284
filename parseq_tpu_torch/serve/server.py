"""Batching inference server of the port (counterpart of
parseq_tpu/serve/server.py): coalesces single-image requests into batches
over a registry ModelBundle.

- **The rung ladder.** Requests are coalesced into batch sizes of a fixed
  ladder (powers of two up to ``max_batch``) and right-padded, as the JAX
  server does, so ``stats`` ('batches', 'requests', 'padded') mean what
  they mean there. On the card no compile is saved by it; whether to serve
  exact batch sizes, or to capture a CUDA graph per rung, is for a
  measurement to decide (ROADMAP.md, A12).
- **One dispatcher thread issues all device work.** It stacks a batch on
  the host, moves it to ``bundle.device``, normalises uint8 there
  (train/steps.py:normalize_u8's op order), runs the bundle's forward and
  train/evaluate.py:_device_post (softmax, argmax, picked probability),
  and queues the copy of ids and probabilities to the host without
  blocking, with a CUDA event recorded behind it. A pool of drain threads
  waits on each batch's event, decodes with the tokenizer and resolves the
  requests' futures, so host decode of one batch overlaps device work of
  the next.
- **Failures.** A batch that fails (a malformed request, or a kernel that
  does not build or launch) fails the futures of its requests, and the
  server keeps serving. Nothing reroutes to a plain path: on the card the
  model runs its kernels or raises.

Usage:
    bundle = load_from_checkpoint('model.pt', device='cuda')
    srv = InferenceServer(bundle, max_batch=32).start()
    text, conf = srv.submit(image_u8_hwc).result()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from parseq_tpu_torch.data.transforms import decode_u8
from parseq_tpu_torch.train.evaluate import _device_post
from parseq_tpu_torch.train.steps import normalize_u8


def _rungs(max_batch):
    r, b = [], 1
    while b < max_batch:
        r.append(b)
        b *= 2
    r.append(max_batch)
    return r


@dataclass
class _Request:
    image: np.ndarray  # (H, W, 3): uint8 resized (preferred) or f32 normalized
    future: Future = field(default_factory=Future)


class InferenceServer:
    """Coalescing batch server over a registry ModelBundle."""

    def __init__(self, bundle, *, max_batch=32, max_wait_ms=2.0, pipeline_depth=4,
                 drain_threads=4):
        self.bundle = bundle
        self.rungs = _rungs(int(max_batch))
        self.max_wait = float(max_wait_ms) / 1e3
        self.n_drainers = int(drain_threads)
        self._q: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._dispatcher = None
        self._drainers = []
        # batches dispatched and not yet taken by a drain thread; the
        # dispatcher blocks while `pipeline_depth` of them wait
        self._inflight: queue.Queue = queue.Queue(maxsize=int(pipeline_depth))
        self.stats = {'batches': 0, 'requests': 0, 'padded': 0}

    # -- public API ---------------------------------------------------------

    def start(self):
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name='serve-dispatch', daemon=True)
        self._drainers = [threading.Thread(target=self._drain_loop,
                                           name=f'serve-drain-{i}', daemon=True)
                          for i in range(self.n_drainers)]
        self._dispatcher.start()
        for t in self._drainers:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in [self._dispatcher, *self._drainers]:
            if t is not None:
                t.join(timeout=10)

    def warmup(self, rungs=None):
        """Run every ladder rung once, to its end, before serving: the first
        call builds the kernels' library and the first call of each shape
        sets up cuBLAS and the allocator. Call it before the server takes
        traffic (the CLI does): it issues device work from the calling
        thread, which is safe only while the dispatcher is idle."""
        h, w = self.bundle.img_size
        for b in rungs or self.rungs:
            done, _, _ = self._forward(np.zeros((b, h, w, 3), np.uint8))
            if done is not None:
                done.synchronize()

    def submit(self, image: np.ndarray) -> Future:
        """image: (H, W, 3), uint8 resized (normalised on the device) or
        float32 already normalised. Returns Future[(str, float)]."""
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = np.asarray(image, np.float32)
        req = _Request(image)
        if self._stop.is_set():
            req.future.set_exception(RuntimeError('InferenceServer stopped'))
            return req.future
        self._q.put(req)
        return req.future

    def read_files(self, paths):
        """Decode, resize to the model's size, submit; returns the results in
        order. JPEGs go through the native decode+resize (bit-identical to
        the PIL path, data/native/jpeg_decode.cpp), anything else via PIL."""
        futures = [self.submit(decode_u8(Path(p).read_bytes(), self.bundle.img_size))
                   for p in paths]
        return [f.result() for f in futures]

    # -- internals ----------------------------------------------------------

    def _forward(self, batch):
        """One batch through the bundle on its device. Returns (event, ids,
        conf): ids and picked probabilities (B, L) on the host, complete once
        the event has (None on the CPU, where they are complete at once)."""
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(self.bundle.device)
            if x.dtype == torch.uint8:
                x = normalize_u8(x)
            ids, conf = _device_post(self.bundle(x))
            ids, conf = ids.to('cpu', non_blocking=True), conf.to('cpu', non_blocking=True)
        done = None
        if self.bundle.device.type == 'cuda':
            done = torch.cuda.Event()
            done.record()
        return done, ids, conf

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.max_wait
            # coalesce until the biggest rung is full or the wait budget ends
            while len(reqs) < self.rungs[-1]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                rung = next(r for r in self.rungs if r >= len(reqs))
                h, w = self.bundle.img_size
                # one dtype per batch: uint8 unless an f32 request is present
                # (then the uint8 members are normalised on the host)
                u8 = all(r.image.dtype == np.uint8 for r in reqs)
                batch = np.zeros((rung, h, w, 3), np.uint8 if u8 else np.float32)
                for i, r in enumerate(reqs):
                    im = r.image  # raises on wrong-shape submissions
                    if not u8 and im.dtype == np.uint8:
                        im = (im.astype(np.float32) / 255.0 - 0.5) / 0.5
                    batch[i] = im
                out = self._forward(batch)
            except Exception as e:  # noqa: BLE001 - fail THESE requests, keep serving
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            self.stats['batches'] += 1
            self.stats['requests'] += len(reqs)
            self.stats['padded'] += rung - len(reqs)
            self._inflight.put((out, reqs))
        # shutdown: fail anything still queued so no caller waits on a
        # Future that will never resolve
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError('InferenceServer stopped'))

    def _drain_loop(self):
        while True:
            try:
                (done, ids, conf), reqs = self._inflight.get(timeout=0.05)
            except queue.Empty:
                # every batch the dispatcher put is drained before this ends
                if self._stop.is_set() and not self._dispatcher.is_alive():
                    return
                continue
            try:
                if done is not None:
                    done.synchronize()
                self._resolve(reqs, ids.numpy(), conf.numpy())
            except Exception as e:  # noqa: BLE001 - fail the batch, keep serving
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _resolve(self, reqs, ids, conf):
        """Decode a batch's first len(reqs) rows and resolve its requests."""
        preds, tok_probs = self.bundle.tokenizer.decode_ids(ids[:len(reqs)], conf[:len(reqs)])
        for r, text, p in zip(reqs, preds, tok_probs):
            r.future.set_result((text, float(np.prod(p))))


# -- the check of served results (chip_smoke.py phase 10, tests) ------------

# A served (text, confidence) against a read of the same image alone: the
# text must be equal wherever the direct read's smallest top-1 - top-2
# probability gap over the steps that decide it exceeds 'gap', and where the
# texts are equal (the same steps decided) the confidence within
# 'confidence' of the direct one, relative to the larger. PARSeq-S in bf16
# on an H100, batches of up to 32 against reads of one, 26 decided steps a
# read (chip_smoke.py phase 10): no text differs, most confidences are
# bit-equal and the worst differs by 2.183e-3 relative, so 'confidence' is
# about 4.6x that; 'gap' is the least probability margin at which a
# different pick is a fault.
CHECK_LIMITS = {'gap': 1e-2, 'confidence': 1e-2}


def direct_reads(bundle, images):
    """Each image read alone by ModelBundle.read (uint8 normalised on the
    device as the server does). Returns (texts, confidences, gaps)."""
    texts, confs, gaps = [], [], []
    for image in images:
        with torch.inference_mode():
            x = torch.from_numpy(np.array(image)[None]).to(bundle.device)
            if x.dtype == torch.uint8:
                x = normalize_u8(x)
        (text,), (conf,), (gap,) = bundle.read(x, gaps=True)
        texts.append(text)
        confs.append(conf)
        gaps.append(gap)
    return texts, confs, gaps


def check_served(served, direct):
    """served: [(text, confidence)] in the order of `direct`, direct_reads()
    of the same images. Returns (passes, texts that differ where the gap is
    clear, the worst relative confidence difference where the texts are
    equal), by CHECK_LIMITS."""
    texts, confs, gaps = direct
    wrong = sum(1 for (text, _), want, gap in zip(served, texts, gaps)
                if gap > CHECK_LIMITS['gap'] and text != want)
    worst = max([abs(c - want) / max(abs(c), abs(want)) if c != want else 0.0
                 for (text, c), want, want_text in zip(served, confs, texts)
                 if text == want_text] or [0.0])
    return wrong == 0 and worst <= CHECK_LIMITS['confidence'], wrong, worst
