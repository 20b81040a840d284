"""Per-family training adapters (port of parseq_tpu/train/families.py).

Each family supplies
  prepare(tokenizer, labels, cfg, rng) -> dict of host numpy arrays
  loss(model, cfg, batch, rng, dtype, **static) -> (loss, loss_numel)
  count(cfg, batch) -> the loss_numel that loss will return, from the
    targets alone (0-dim int64): what the loss's mean divides by, which
    on several ranks train/steps.py sums over them before the forward
  val: 'ce' | 'ctc', the validation loss of the train loop.
The model is in train mode: batch norms use batch statistics and move their
running statistics in place (the JAX package threads them as `stats`).
rng is None (no dropout) or a torch.Generator on the batch's device. Loss
semantics follow each reference system's training_step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from parseq_tpu_torch.models.parseq import gen_tgt_perms
from parseq_tpu_torch.ops.ctc import ctc_loss
from parseq_tpu_torch.ops.layers import ce_ignore_pad
from parseq_tpu_torch.utils import trace

# --- PARSeq -------------------------------------------------------------------


def _parseq_prepare(tok, labels, cfg, rng):
    return {'tgt': tok.encode(labels, cfg.max_label_length), 'perms': gen_tgt_perms(rng, cfg)}


def _parseq_loss(model, cfg, batch, rng, dtype):
    return model.multi_perm_loss(batch['images'], batch['tgt'], batch['perms'], dtype=dtype,
                                 rng=rng)


def _parseq_count(cfg, batch):
    """multi_perm_loss's tokens: non-PAD targets in every permutation, EOS
    only in the first two."""
    tgt_out, K = batch['tgt'][:, 1:], batch['perms'].shape[0]
    chars = (tgt_out != cfg.pad_id) & (tgt_out != cfg.eos_id)
    eos = tgt_out == cfg.eos_id
    return K * chars.sum() + min(K, 2) * eos.sum()


# --- ViTSTR -------------------------------------------------------------------


def _vitstr_prepare(tok, labels, cfg, rng):
    return {'tgt': tok.encode(labels, cfg.max_label_length)}


def _vitstr_loss(model, cfg, batch, rng, dtype):
    _, loss, numel = model.logits_loss(batch['images'], batch['tgt'], dtype=dtype)
    return loss, numel


def _vitstr_count(cfg, batch):
    return (batch['tgt'][:, 1:cfg.num_steps + 1] != cfg.pad_id).sum()


# --- CRNN / TRBC (CTC) --------------------------------------------------------


def _ctc_prepare(tok, labels, cfg, rng):
    return {'targets': tok.encode(labels, cfg.max_label_length),
            'lengths': tok.lengths(labels, cfg.max_label_length)}


def _crnn_loss(model, cfg, batch, rng, dtype):
    _, loss, n = model.logits_loss(batch['images'], batch['targets'], batch['lengths'],
                                   dtype=dtype)
    return loss, n


def _ctc_count(cfg, batch):
    """CTC's loss is a batch mean: it divides by the rows."""
    images = batch['images']
    return torch.full((), images.shape[0], dtype=torch.long, device=images.device)


def _trbc_loss(model, cfg, batch, rng, dtype):
    logits = model(batch['images'], dtype)
    loss = ctc_loss(torch.log_softmax(logits, dim=-1), batch['targets'], batch['lengths'],
                    blank=0)
    return loss, batch['images'].shape[0]


# --- TRBA (teacher-forced attention) ------------------------------------------


def _trba_prepare(tok, labels, cfg, rng):
    enc = tok.encode(labels, cfg.max_label_length)  # (B, L + 2)
    return {'inputs': enc[:, :-1], 'targets': enc[:, 1:]}


def _trba_loss(model, cfg, batch, rng, dtype):
    logits = model(batch['images'], dtype, text=batch['inputs'])
    return ce_ignore_pad(logits, batch['targets'][:, :logits.shape[1]], cfg.pad_id,
                         cfg.num_tokens)


def _trba_count(cfg, batch):
    return (batch['targets'][:, :cfg.num_steps] != cfg.pad_id).sum()


# --- ABINet (staged) ----------------------------------------------------------


def _abinet_prepare(tok, labels, cfg, rng):
    enc = tok.encode(labels, cfg.max_label_length)
    targets = enc[:, 1:cfg.max_length + 1]  # (B, T) [chars..., EOS, PAD...]
    inputs = np.where(targets == cfg.pad_id, cfg.null_label, targets)
    lengths = np.asarray([len(label) + 1 for label in labels], np.int32)
    return {'targets': targets, 'lm_inputs': inputs, 'lengths': lengths}


def _abinet_count(cfg, batch):
    """Every one of ABINet's losses is a token mean over the same targets."""
    return (batch['targets'] != cfg.pad_id).sum()


def _abinet_res_loss(res_list, targets, cfg):
    """Mean CE over a list of results (abinet/system.py:147-159)."""
    if isinstance(res_list, dict):
        res_list = [res_list]
    loss, numel = 0.0, 0
    for res in res_list:
        one, numel = ce_ignore_pad(res['logits'], targets, cfg.pad_id, cfg.num_classes)
        loss = loss + one
    return loss / len(res_list), numel


def _abinet_loss(model, cfg, batch, rng, dtype, *, pretraining=False, lm_only=False):
    images = batch['images'].to(dtype)
    targets = batch['targets']
    onehot = F.one_hot(batch['lm_inputs'].long(), cfg.num_classes).to(dtype)

    if lm_only:
        # The language model alone on ground-truth inputs (system.py:100-104,
        # 183-185): vision and alignment get no gradient.
        l_res = model.language_forward(onehot, batch['lengths'], rng)
        loss, numel = _abinet_res_loss(l_res, targets, cfg)
        return cfg.l_loss_weight * loss, numel

    if pretraining:
        # Each sub-model trained on its own (system.py:187-195).
        v_res = model.vision_forward(images, rng)
        l_res = model.language_forward(onehot, batch['lengths'], rng)
        a_res = model.alignment_forward(l_res['feature'].detach(), v_res['feature'].detach())
        v_loss, numel = _abinet_res_loss(v_res, targets, cfg)
        l_loss, _ = _abinet_res_loss(l_res, targets, cfg)
        a_loss, _ = _abinet_res_loss(a_res, targets, cfg)
    else:
        all_a, all_l, v_res = model.forward_iterations(images, dtype, rng)
        v_loss, numel = _abinet_res_loss(v_res, targets, cfg)
        l_loss, _ = _abinet_res_loss(all_l, targets, cfg)
        a_loss, _ = _abinet_res_loss(all_a, targets, cfg)
    loss = cfg.v_loss_weight * v_loss + cfg.l_loss_weight * l_loss + cfg.a_loss_weight * a_loss
    return loss, numel


# --- registry -----------------------------------------------------------------


class TrainFamily:
    def __init__(self, prepare, loss, count, val='ce'):
        self._prepare = prepare
        self.loss = loss
        self.count = count
        self.val = val  # 'ce' | 'ctc'

    def prepare(self, tokenizer, labels, cfg, rng):
        """The family's host preparation of a batch's labels (the span
        train.prepare)."""
        with trace.span('train.prepare', rows=len(labels)):
            return self._prepare(tokenizer, labels, cfg, rng)


FAMILIES = {
    'parseq': TrainFamily(_parseq_prepare, _parseq_loss, _parseq_count),
    'vitstr': TrainFamily(_vitstr_prepare, _vitstr_loss, _vitstr_count),
    'crnn': TrainFamily(_ctc_prepare, _crnn_loss, _ctc_count, val='ctc'),
    'trba': TrainFamily(_trba_prepare, _trba_loss, _trba_count),
    'trbc': TrainFamily(_ctc_prepare, _trbc_loss, _ctc_count, val='ctc'),
    'abinet': TrainFamily(_abinet_prepare, _abinet_loss, _abinet_count),
}


def get_family(name: str) -> TrainFamily:
    for key in ('abinet', 'crnn', 'parseq', 'trbc', 'trba', 'vitstr'):
        if key in name:
            return FAMILIES[key]
    raise KeyError(name)
