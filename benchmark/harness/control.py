"""The control: the reference put in the program's place, computed with
float8 products (reference/ops.py, the precision below the configuration's
bf16), and judged by the same comparison and limits as the program
(harness/compare.py, report.judge). It has to come out not correct."""

from __future__ import annotations

import numpy as np
import torch

from harness import compare, env, spec
from reference.ops import Ops, normalize_u8, strict_f32
from reference.tokenizer import Ids


def _greedy_picks(ref, params, cfg, ids, x, ops):
    """The greedy AR picks of the model in `ops`' precision, one position a
    teacher-forced pass: pass i takes position i's pick from the logits
    under the picks already made (the later positions are hidden)."""
    n = cfg['max_label_length'] + 1
    picks = torch.zeros(len(x), n, dtype=torch.long, device=x.device)
    for i in range(n):
        picks[:, i] = ref.read(params, cfg, ids, x, picks, ops)[0][:, i].argmax(-1)
    return picks


def fp8_reading(ctx):
    """A read cell's control on the run's own sample (its images and
    weights): the float8 reference decodes each image greedily as the
    program does and hands its picks, ids, picked probabilities and strings
    to the comparison. Returns the readings."""
    s = ctx.keep['sample']
    cell = ctx.cell
    ref, m = spec.reference(cell), cell.config['model']
    ids = Ids(m['charset_train'])
    strict_f32()
    ops = Ops('fp8')
    picks, got_ids, got_probs = [], [], []
    with torch.no_grad():
        for a in range(0, len(s['images']), compare.CHUNK):
            x = normalize_u8(s['images'][a:a + compare.CHUNK])
            pk = _greedy_picks(ref, s['params'], m, ids, x, ops) if ref.AR else None
            fin = ref.read(s['params'], m, ids, x, pk, ops)[1]
            probs = torch.softmax(fin, -1)
            top = probs.argmax(-1)
            got_ids.append(top.cpu().numpy())
            got_probs.append(probs.gather(-1, top[..., None])[..., 0].cpu().numpy())
            if ref.AR:
                picks.append(pk.cpu().numpy())
    got_ids = np.concatenate(got_ids)
    return compare.read_readings(ref, s['params'], m, ids, s['images'],
                                 np.concatenate(picks) if ref.AR else None, got_ids,
                                 np.concatenate(got_probs), ids.decode(got_ids))


def fp8_training(ctx):
    """The training cell's control: the reference's steps in float8 products
    in the program's place, against the float32 reference's, from the same
    weights on the cell's own data. Returns (readings, detail)."""
    train = spec.load_module(env.BENCH / 'drivers' / 'train.py')
    ref, m = spec.reference(ctx.cell), ctx.cell.config['model']
    ids, sd = train.make_weights(ctx, ref)
    pool, labels, order = train.make_data(ctx)
    steps = [(pool[int(order[i % len(order)])], labels[int(order[i % len(order)])])
             for i in range(ctx.cell.traffic['check_steps'])]
    batches = train.reference_batches(ctx, ref, steps)
    opt = train.reference_opt(ctx)
    runs = {p: compare.reference_steps(ref, sd, m, ids, batches, opt, precision=p)
            for p in ('fp8', 'f32')}
    (lo, go, ao), (lr, gr, ar) = runs['fp8'], runs['f32']
    readings, detail = compare.train_readings(lo, go, {k: ao[k] - sd[k] for k in ao}, lr, gr,
                                              {k: ar[k] - sd[k] for k in ar})
    if ctx.device == 'cuda':
        torch.cuda.empty_cache()
    return readings, detail
