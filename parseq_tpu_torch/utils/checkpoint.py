"""Checkpoint I/O of the port (counterpart of parseq_tpu/utils/checkpoint.py).

One `torch.save` file per checkpoint: the model's reference-schema
state_dict (CPU tensors), the model config and training metadata as JSON
strings. `utils.registry.load_from_checkpoint` reads these files (`.ckpt`).

`load_jax_checkpoint` reads the JAX package's msgpack `.ckpt`
(parseq_tpu/utils/checkpoint.py:save_checkpoint: the numpy param tree,
`config` and `meta` as JSON) through the port's own decoder
(utils/msgpack.py); the registry converts the tree to a state_dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch


def _config_dict(config):
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


def save_checkpoint(path, state_dict, config=None, meta=None):
    """Save a state_dict (+ config dataclass/dict, + meta dict) to one file,
    atomically (written under a temporary name, then renamed)."""
    payload = {
        'state_dict': {k: v.detach().cpu() for k, v in state_dict.items()},
        'config': json.dumps(_config_dict(config)) if config is not None else '',
        'meta': json.dumps(meta or {}),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path):
    """-> (state_dict, config_dict or None, meta_dict)."""
    return read_payload(torch.load(path, map_location='cpu', weights_only=True))


def read_payload(payload):
    """A loaded checkpoint payload -> (state_dict, config_dict or None, meta_dict)."""
    config = json.loads(payload['config']) if payload.get('config') else None
    return payload['state_dict'], config, json.loads(payload.get('meta') or '{}')


def save_topk(out_dir, step, metric_value, state_dict, config=None, meta=None, k=3, mode='max'):
    """ModelCheckpoint-style top-k retention (reference train.py:86-92): keep
    the k best checkpoints by metric, plus 'last.ckpt'. Returns the best
    surviving checkpoint's path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = dict(meta or {}, step=int(step), metric=float(metric_value))
    name = f'step={int(step)}-metric={float(metric_value):.4f}.ckpt'
    save_checkpoint(out_dir / name, state_dict, config, meta)
    save_checkpoint(out_dir / 'last.ckpt', state_dict, config, meta)
    cands = []
    for p in out_dir.glob('step=*.ckpt'):
        try:
            m = float(p.stem.split('metric=')[1])
        except (IndexError, ValueError):
            continue
        cands.append((m, p))
    cands.sort(key=lambda t: t[0], reverse=(mode == 'max'))
    for _, p in cands[k:]:
        p.unlink()
    return cands[0][1] if cands else out_dir / 'last.ckpt'


def load_jax_checkpoint(path):
    """A JAX package checkpoint -> (param tree, config_dict or None,
    meta_dict). Leaves are numpy arrays (torch.bfloat16 tensors for bf16)."""
    from parseq_tpu_torch.utils.msgpack import restore

    payload = restore(Path(path).read_bytes())
    if not (isinstance(payload, dict) and 'params' in payload):
        raise ValueError(f'{path}: a msgpack file, but not a JAX package checkpoint '
                         f'(top-level keys {sorted(payload) if isinstance(payload, dict) else []})')
    config = json.loads(payload['config']) if payload.get('config') else None
    return payload['params'], config, json.loads(payload.get('meta') or '{}')
