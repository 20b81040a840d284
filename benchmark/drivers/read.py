"""Bulk reading through the program's evaluation loop.

The traffic file gives `batch`, `pool_batches` (distinct batches of uint8
crops made at set-up from the seed, handed out in a seeded cyclic order),
`warmup_batches`, the traced span (`trace_start`, `trace_iters`) and the
correctness sample (`sample_rows` rows of the batches b with b %
`sample_every` equal to an offset drawn from the seed). The loader yields
(images, labels, None) to `train/evaluate.py:eval_dataset` on a registry
`ModelBundle` until the window's seconds are up; eval_dataset decodes the
last batch and returns. The model's plain reference and the program's side
of it come by the configuration's `reference` and `adapter` keys.

What is measured:
- read_img_s: images whose strings decode_ids returned in the window, over
  the window (the loader's first hand-over to eval_dataset's return);
- read_batch_p95_ms: the 95th percentile over the window's batches of the
  time from the loader handing a batch over to decode_ids returning its
  strings;
- in a traced run: host ms a batch inside decode_ids, device ms a batch of
  the encoder's blocks (CUDA events at forward hooks on its first and last
  block), and the profiler over the traced span.
"""

from __future__ import annotations

import time

import numpy as np

from harness import compare, program, seeds, spec, weights
from harness.context import Outcome
from reference.tokenizer import Ids


class Record:
    """What the window's wrappers record. Batch b is sampled (its ids,
    probabilities and strings kept, and its AR picks taken) where
    b % every == offset, the offset drawn from the seed."""

    def __init__(self, every, offset):
        self.every, self.offset = every, offset
        self.handed = []  # (time, pool index) a batch
        self.decoded = []  # (return time, seconds inside decode_ids) a batch
        self.kept = {}  # sampled batch -> (ids, probs, strings) handed to and by decode_ids
        self.picks = {}  # sampled batch -> the AR pass's picks, on the device
        self.ar_calls = 0
        self.enc_events = []  # (start, end) CUDA events a batch

    def sampled(self, b):
        return b % self.every == self.offset

    def clear(self):
        self.__init__(self.every, self.offset)


def make_weights(ctx, ref):
    m = ctx.cell.config['model']
    ids = Ids(m['charset_train'])
    return ids, weights.draw(ref.param_shapes(m, ids), ctx.seed, ctx.device, ref.init_kind)


def make_pool(ctx, n, batch, img_size):
    """n batches of uint8 crops (host numpy, as a loader yields them) and
    their labels: 1 to 25 characters of the test charset."""
    import torch

    gen = seeds.generator(ctx.seed, 'images', ctx.device)
    pool = torch.randint(0, 256, (n, batch, *img_size, 3), generator=gen, device=ctx.device,
                         dtype=torch.uint8).cpu().numpy()
    rng = np.random.default_rng(seeds.sub(ctx.seed, 'labels'))
    chars = ctx.cell.config['model']['charset_test']
    labels = [[''.join(rng.choice(list(chars), size=rng.integers(1, 26)))
               for _ in range(batch)] for _ in range(n)]
    return pool, labels


def hook(bundle, rec, ctx, ref, adapter):
    """Wrap decode_ids (its host time; what a sampled batch was handed and
    returned), the AR pass (a sampled batch's picks) and, in a traced run,
    the encoder blocks (CUDA events)."""
    import torch

    tok = bundle.tokenizer
    orig_decode = tok.decode_ids

    def decode_ids(ids, probs, raw=False):
        t0 = time.perf_counter()
        out = orig_decode(ids, probs, raw=raw)
        t1 = time.perf_counter()
        b = len(rec.decoded)
        rec.decoded.append((t1, t1 - t0))
        if rec.sampled(b):
            rec.kept[b] = (ids, probs, out[0])
        return out

    tok.decode_ids = decode_ids
    undo = [lambda: delattr(tok, 'decode_ids')]
    if ref.AR:
        def on_logits(logits):
            b = rec.ar_calls
            rec.ar_calls += 1
            if rec.sampled(b):
                rec.picks[b] = logits.argmax(-1)

        undo += adapter.wrap_ar(bundle, on_logits)
    if ctx.trace and ctx.device == 'cuda':
        blocks = adapter.encoder_blocks(bundle)

        def pre(_m, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.enc_events.append([ev, None])

        def post(_m, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.enc_events[-1][1] = ev

        handles = [blocks[0].register_forward_pre_hook(pre),
                   blocks[-1].register_forward_hook(post)]
        undo += [h.remove for h in handles]
    return undo


def run(ctx, tracer):
    import torch
    from parseq_tpu_torch.train.evaluate import eval_dataset

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    ref, adapter = spec.reference(ctx.cell), spec.adapter(ctx.cell)
    B = tr['batch']
    ids, sd = make_weights(ctx, ref)
    bundle = program.bundle(ctx, sd)
    img_size = tuple(cfg['model']['img_size'])
    pool, labels = make_pool(ctx, tr['pool_batches'], B, img_size)
    order = np.random.default_rng(seeds.sub(ctx.seed, 'order')).permutation(tr['pool_batches'])
    sample_rng = np.random.default_rng(seeds.sub(ctx.seed, 'sample'))
    rec = Record(tr['sample_every'], int(sample_rng.integers(tr['sample_every'])))
    undo = hook(bundle, rec, ctx, ref, adapter)
    state = {'t_start': 0.0}

    def loader(n_batches=None, seconds=None, trace=False):
        i = 0
        while (n_batches is None or i < n_batches) and (
                seconds is None or time.perf_counter() - state['t_start'] < seconds):
            if trace:
                tracer.tick(i)
            k = int(order[i % len(order)])
            rec.handed.append((time.perf_counter(), k))
            yield pool[k], labels[k], None
            i += 1

    eval_dataset(bundle, loader(n_batches=tr['warmup_batches']), name='warmup')
    if ctx.device == 'cuda':
        torch.cuda.synchronize()
    rec.clear()
    setup_s = time.perf_counter() - ctx.t_process

    tracer.warm()
    state['t_start'] = time.perf_counter()
    eval_dataset(bundle, loader(seconds=ctx.seconds, trace=True), name='window')
    t_end = time.perf_counter()
    tracer.finish()
    window = t_end - state['t_start']
    for u in undo:
        u()

    n_batches = len(rec.handed)
    if ref.AR and rec.ar_calls != n_batches:
        raise RuntimeError(f'the AR pass ({adapter.AR_ENTRIES}) ran {rec.ar_calls} times for '
                           f'{n_batches} batches; the read driver takes its picks there')
    decoded = B * len(rec.decoded)
    lat_ms = [(d[0] - h[0]) * 1e3 for h, d in zip(rec.handed, rec.decoded)]
    metrics = {'read_img_s': (decoded / window, 'img/s'),
               'read_batch_p95_ms': (float(np.percentile(lat_ms, 95)), 'ms'),
               'setup_s': (setup_s, 's')}
    layer = {'batches': n_batches, 'batch': B, 'window_s': window,
             'host_decode_ms': [d[1] * 1e3 for d in rec.decoded], 'latency_ms': lat_ms,
             'handed_s': [h[0] - state['t_start'] for h in rec.handed]}
    if rec.enc_events:
        torch.cuda.synchronize()
        layer['encoder_ms'] = [a.elapsed_time(b) for a, b in rec.enc_events if b is not None]
    peak = int(torch.cuda.max_memory_allocated()) if ctx.device == 'cuda' else 0

    # the sample: rows of the sampled batches drawn from the seed, with the
    # longest of their reads in it
    batches = sorted(rec.kept)
    notes = [f'batches: {n_batches} of {B} in {window:.3f} s; decoded {decoded}; '
             f'{len(batches)} sampled (every {rec.every}th from {rec.offset})']
    readings = {}
    if batches:
        cand = [(b, r) for b in batches for r in range(B)]
        lengths = [len(rec.kept[b][2][r]) for b, r in cand]
        rows = compare.sample_rows(sample_rng, len(cand), tr['sample_rows'],
                                   int(np.argmax(lengths)))
        sel = [cand[i] for i in rows]
        images = torch.as_tensor(np.stack([pool[rec.handed[b][1]][r] for b, r in sel]))
        images = images.to(ctx.device)
        got_ids = np.stack([rec.kept[b][0][r] for b, r in sel])
        got_probs = np.stack([rec.kept[b][1][r] for b, r in sel])
        got_strings = [rec.kept[b][2][r] for b, r in sel]
        picks = (np.stack([rec.picks[b][r].cpu().numpy() for b, r in sel]) if ref.AR else None)
        # what the control (harness/control.py) reads again in the program's place
        ctx.keep['sample'] = {'images': images, 'picks': picks, 'params': sd}
        del bundle, rec.picks
        if ctx.device == 'cuda':
            torch.cuda.empty_cache()
        readings = compare.read_readings(ref, sd, cfg['model'], ids, images, picks, got_ids,
                                         got_probs, got_strings)
        notes.append(f'sampled {len(rows)} reads, longest {max(lengths)} characters')
    return Outcome(attempted=n_batches * B, failed=n_batches * B - decoded, metrics=metrics,
                   readings=readings, layer=layer, memory_peak_bytes=peak, notes=notes)
