"""The comparisons that decide `correct`, between what the timed path
produced and the plain reference (benchmark/reference/), computed after the
window in float32 with TF32 off, in blocks of rows.

Reads: for each sampled image, the configuration's reference model runs,
teacher-forced on the program's own AR picks where it has an AR pass.
Readings (max over the sample):
- `ar_logit_gap` (a model with an AR pass): how far the reference's logit of
  the program's AR pick lies below the reference's best, at each step;
- `logit_gap`: the same for the ids handed to decode_ids (after refinement);
- `logprob_err`: |log p| of the picked probability handed to decode_ids
  against the reference's softmax at that id;
- `strings_wrong`: reads whose string differs from the reference's decode of
  the program's ids (an exact comparison).

Training: three steps of the reference from the same initial weights, on the
same images and labels and what the model's `train_extras` draws again from
the same seeds (PARSeq: permutations and dropout bits). Readings:
- `loss_gap`: the largest |loss - reference| / reference over the steps;
- `grad_gap`: over the leaves (each parameter; a packed q|k|v projection
  as three), |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median
  leaf's ‖g_ref‖), with g the first step's clipped gradient as AdamW took it
  (from the program's first moment: mu_1 / (1 - b1));
- `change_gap`: the same for each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by rounding alone).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import ops as rops
from reference import train as rtrain
from reference.tokenizer import Ids

CHUNK = 128  # rows of the reference at a time


def read_readings(ref, params, cfg, ids: Ids, images_u8, picks, got_ids, got_probs,
                  got_strings):
    """ref: the reference model's module; images_u8 (N, H, W, 3) uint8 tensor
    on the reference's device; picks, got_ids, got_probs (N, n) numpy (picks
    None for a model without an AR pass); got_strings: N strings. Returns
    the readings."""
    rops.strict_f32()
    ops = rops.Ops('f32')
    dev = images_u8.device
    out = {'logit_gap': 0.0, 'logprob_err': 0.0}
    if ref.AR:
        out['ar_logit_gap'] = 0.0
    with torch.no_grad():
        for s in range(0, len(images_u8), CHUNK):
            x = rops.normalize_u8(images_u8[s:s + CHUNK])
            g_ids = torch.as_tensor(got_ids[s:s + CHUNK], device=dev).long()
            pk = (torch.as_tensor(picks[s:s + CHUNK], device=dev).long() if ref.AR else None)
            ar, fin = ref.read(params, cfg, ids, x, pk, ops)
            if ref.AR:
                gap = ar.max(-1).values - ar.gather(-1, pk[..., None])[..., 0]
                out['ar_logit_gap'] = max(out['ar_logit_gap'], float(gap.max()))
            gap = fin.max(-1).values - fin.gather(-1, g_ids[..., None])[..., 0]
            out['logit_gap'] = max(out['logit_gap'], float(gap.max()))
            ref_lp = torch.log_softmax(fin, -1).gather(-1, g_ids[..., None])[..., 0]
            got_lp = torch.log(torch.as_tensor(got_probs[s:s + CHUNK], device=dev).double())
            out['logprob_err'] = max(out['logprob_err'],
                                     float((got_lp - ref_lp.double()).abs().max()))
    out['strings_wrong'] = float(sum(a != b for a, b in zip(ids.decode(got_ids), got_strings)))
    return out


def sample_rows(rng: np.random.Generator, n_rows, size, longest):
    """`size` distinct row numbers of n_rows drawn from rng, with `longest` in."""
    rows = set(rng.choice(n_rows, size=min(size, n_rows), replace=False).tolist())
    rows.discard(longest)
    rows = sorted(rows)[:max(0, min(size, n_rows) - 1)] + [longest]
    return sorted(rows)


PACKED = ('in_proj_weight', 'in_proj_bias', 'attn.qkv.weight', 'attn.qkv.bias')


def leaves(tensors: dict):
    """The comparison's leaves: each parameter, with a packed q|k|v projection
    (nn.MultiheadAttention's in_proj, timm's qkv) split into its three."""
    out = {}
    for k, v in tensors.items():
        if k.endswith(PACKED):
            for part, t in zip('qkv', v.chunk(3)):
                out[f'{k}[{part}]'] = t
        else:
            out[k] = v
    return out


def leaf_gaps(got: dict, want: dict, keep=None):
    """Per leaf |‖got‖ - ‖want‖| / max(‖want‖, median leaf ‖want‖)."""
    names = [k for k in want if keep is None or keep[k]]
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in names}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in names}
    med = float(np.median(list(w.values())))
    return {k: abs(g[k] - w[k]) / max(w[k], med) for k in names}


def reference_steps(ref, params0, cfg, ids: Ids, batches, opt_cfg, *, precision='f32'):
    """The reference model's steps from params0 (name -> float32 tensor, not
    modified). batches: [(images_u8, labels, extras)] one a step, extras
    from the model's `train_extras`. Returns (losses, first clipped
    gradients, parameters after the steps)."""
    rops.strict_f32()
    ops = rops.Ops(precision)
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    opt = rtrain.AdamW({k: v.detach() for k, v in params.items()}, opt_cfg)
    losses, first = [], None
    for images_u8, labels, extras in batches:
        tgt = torch.as_tensor(ids.encode(labels, cfg['max_label_length']),
                              device=images_u8.device)
        loss = ref.train_loss(params, cfg, ids, rops.normalize_u8(images_u8), tgt, extras, ops)
        grads = torch.autograd.grad(loss, list(params.values()))
        clipped = opt.step({k: v.data for k, v in params.items()},
                           dict(zip(params, grads)))
        if first is None:
            first = clipped
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}


def train_readings(losses, grads, changes, ref_losses, ref_grads, ref_changes):
    """The training readings; grads and changes: name -> tensor."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grads, changes, ref_grads, ref_changes = map(leaves, (grads, changes, ref_grads, ref_changes))
    g = leaf_gaps(grads, ref_grads)
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    c = leaf_gaps(changes, ref_changes, keep={k: norms[k] >= floor for k in norms})
    worst_g, worst_c = max(g, key=g.get), max(c, key=c.get)
    return ({'loss_gap': loss_gap, 'grad_gap': g[worst_g], 'change_gap': c[worst_c]},
            {'grad_gap_leaf': worst_g, 'change_gap_leaf': worst_c,
             'left_out': sorted(k for k in norms if norms[k] < floor)})
