"""CTC loss and greedy best-path ids (port of parseq_tpu/ops/ctc.py).

The JAX package runs the log-alpha recursion as a lax.scan; here
`F.ctc_loss` runs it (the JAX package's tests hold the two equal). The
semantics are the JAX package's: targets padded to a fixed width and
masked by `target_lengths`, every input length the full T, an empty target
allowed, non-finite (infeasible) sample losses zeroed with their gradient,
and reduction 'mean' dividing each sample by max(length, 1) before the
batch mean.

`F.ctc_loss`'s backward returns the gradient with respect to the logits
that a log_softmax made `log_probs` from (it adds exp(log_probs) on every
row it keeps), not with respect to `log_probs` itself. `ctc_loss` subtracts
that term again, so its gradient is the true one for any finite
`log_probs`; through a log_softmax the added term had contributed nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(log_probs, targets, target_lengths, *, blank=0, zero_infinity=True,
             reduction='mean'):
    """log_probs (B, T, C) log-softmax outputs; targets (B, L) int ids
    (anything past target_lengths is ignored); target_lengths (B,).
    Returns the scalar loss ('mean') or the per-sample losses ('none')."""
    dtype = torch.promote_types(log_probs.dtype, torch.float32)
    log_probs = log_probs.to(dtype)
    B, T, _ = log_probs.shape
    targets = targets.long()
    target_lengths = target_lengths.long()
    input_lengths = torch.full((B,), T, dtype=torch.long, device=log_probs.device)
    nll = F.ctc_loss(log_probs.transpose(0, 1), targets, input_lengths, target_lengths,
                     blank=blank, reduction='none', zero_infinity=zero_infinity)
    # The rows F.ctc_loss keeps: with finite log_probs a row is infeasible
    # exactly when its labels and the blanks between repeats outnumber T.
    kept = torch.ones_like(target_lengths, dtype=torch.bool)
    if zero_infinity:
        with torch.no_grad():
            pos = torch.arange(1, targets.shape[1], device=targets.device)
            repeats = ((targets[:, 1:] == targets[:, :-1]) & (pos < target_lengths[:, None])).sum(1)
            kept = target_lengths + repeats <= T
    # d/d log_probs of `added` is exp(log_probs); its value is 0, so the loss
    # is unchanged.
    added = (log_probs.detach().exp() * log_probs).sum((1, 2))
    nll = nll - torch.where(kept, added - added.detach(), 0.0)
    if reduction == 'none':
        return nll
    return (nll / target_lengths.clamp(min=1).to(dtype)).mean()


def greedy_decode_ids(logits):
    """(B, T, C) -> per-position argmax ids (B, T); the CTCTokenizer collapses
    repeats and drops blanks (best-path decode)."""
    return logits.argmax(-1)
