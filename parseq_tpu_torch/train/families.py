"""Per-family training adapters (port of parseq_tpu/train/families.py).

Each family supplies
  prepare(tokenizer, labels, cfg, rng) -> dict of host numpy arrays
  loss(model, cfg, batch, rng, dtype) -> (loss, loss_numel)
Only PARSeq is ported; the other families raise, naming their ROADMAP item.
"""

from __future__ import annotations

from parseq_tpu_torch.models.parseq import gen_tgt_perms


def _parseq_prepare(tok, labels, cfg, rng):
    return {'tgt': tok.encode(labels, cfg.max_label_length), 'perms': gen_tgt_perms(rng, cfg)}


def _parseq_loss(model, cfg, batch, rng, dtype):
    return model.multi_perm_loss(batch['images'], batch['tgt'], batch['perms'], dtype=dtype,
                                 rng=rng)


class TrainFamily:
    def __init__(self, prepare, loss):
        self.prepare = prepare
        self.loss = loss


FAMILIES = {'parseq': TrainFamily(_parseq_prepare, _parseq_loss)}

# families not ported yet -> where ROADMAP.md queues their training
_QUEUED = {'vitstr': 'queue A item 14', 'abinet': 'queue A item 15',
           'crnn': 'queue A item 16', 'trba': 'queue A item 16', 'trbc': 'queue A item 16'}


def get_family(name: str) -> TrainFamily:
    for key in ('abinet', 'crnn', 'parseq', 'trbc', 'trba', 'vitstr'):
        if key in name:
            if key in FAMILIES:
                return FAMILIES[key]
            raise NotImplementedError(f"training of the '{key}' family is not ported to "
                                      f"PyTorch yet (ROADMAP.md {_QUEUED[key]})")
    raise KeyError(name)
