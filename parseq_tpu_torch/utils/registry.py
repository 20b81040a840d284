"""Model registry: experiment name -> config + module + inference bundle
(port of parseq_tpu/utils/registry.py, PARSeq family).

Configs are composed from the repository's `configs/` groups by the shared,
framework-free `parseq_tpu.utils.config`. Checkpoints: reference PyTorch
`.pt` state_dicts load with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from parseq_tpu.data.charset import CharsetAdapter
from parseq_tpu.data.tokenizer import Tokenizer
from parseq_tpu.utils import config as config_lib
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig


class InvalidModelError(RuntimeError):
    pass


@dataclass
class ModelBundle:
    """Everything needed to run a model: config, module, tokenizer, device."""

    name: str
    cfg: Any
    module: torch.nn.Module
    tokenizer: Any
    charset_adapter: CharsetAdapter
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    raw_config: dict = field(default_factory=dict)

    def __call__(self, images):
        """images (B, H, W, 3) in [-1, 1] (numpy or tensor) -> f32 logits
        (B, num_steps, num_classes) on the bundle's device."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self.module(x, dtype=self.dtype)

    @property
    def img_size(self):
        return tuple(self.raw_config.get('img_size', (32, 128)))

    def read(self, images):
        """images (B, H, W, 3) in [-1, 1] -> (labels, confidences)."""
        probs = torch.softmax(self(images), dim=-1).cpu().numpy()
        labels, probs = self.tokenizer.decode(probs)
        return labels, [float(np.prod(p)) for p in probs]


def _family(name: str) -> str:
    for key in ('abinet', 'crnn', 'parseq', 'trbc', 'trba', 'vitstr'):
        if key in name:
            return key
    raise InvalidModelError(f"Unable to find model family for '{name}'")


# Trainer-level keys that legitimately live in the model config node
# (configs/model/*.yaml feed the trainer, not the network).
_TRAINER_KEYS = frozenset({
    'name', 'lr', 'l_lr', 'batch_size', 'weight_decay', 'warmup_pct',
    'charset_train', 'charset_test', 'lm_only',
})


class _TrackedCfg(dict):
    """Dict view that records which keys a family builder consumed, so an
    unknown model.* key fails loudly instead of being silently dropped."""

    def __init__(self, d):
        super().__init__(d)
        self.consumed = set()

    def get(self, key, default=None):
        self.consumed.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


def _build_parseq(model_cfg: dict):
    tok = Tokenizer(model_cfg['charset_train'])
    cfg = PARSeqConfig(
        num_tokens=len(tok),
        max_label_length=model_cfg.get('max_label_length', 25),
        img_size=tuple(model_cfg.get('img_size', (32, 128))),
        patch_size=tuple(model_cfg.get('patch_size', (4, 8))),
        embed_dim=model_cfg.get('embed_dim', 384),
        enc_num_heads=model_cfg.get('enc_num_heads', 6),
        enc_mlp_ratio=model_cfg.get('enc_mlp_ratio', 4),
        enc_depth=model_cfg.get('enc_depth', 12),
        dec_num_heads=model_cfg.get('dec_num_heads', 12),
        dec_mlp_ratio=model_cfg.get('dec_mlp_ratio', 4),
        dec_depth=model_cfg.get('dec_depth', 1),
        decode_ar=model_cfg.get('decode_ar', True),
        refine_iters=model_cfg.get('refine_iters', 1),
        dropout=model_cfg.get('dropout', 0.1),
        perm_num=model_cfg.get('perm_num', 6),
        perm_forward=model_cfg.get('perm_forward', True),
        perm_mirrored=model_cfg.get('perm_mirrored', True),
        shared_perm_dropout=model_cfg.get('shared_perm_dropout', False),
        bulk_dropout_bits=model_cfg.get('bulk_dropout_bits', True),
        bulk_bits_uint8=model_cfg.get('bulk_bits_uint8', True),
    )
    return cfg, tok


def _bundle(name, model_cfg, *, seed=0, dtype=torch.bfloat16, device='cuda', state_dict=None):
    family = _family(name)
    if family != 'parseq':
        raise NotImplementedError(
            f"Model family '{family}' is not ported to PyTorch yet (ROADMAP queue A, slice 4)")
    tracked = _TrackedCfg(model_cfg)
    cfg, tok = _build_parseq(tracked)
    unknown = set(model_cfg) - tracked.consumed - _TRAINER_KEYS
    if unknown:
        raise InvalidModelError(
            f"Unknown model config key(s) for family '{family}': "
            f"{sorted(unknown)}. Accepted model keys: "
            f"{sorted(tracked.consumed)}; trainer-level keys: "
            f"{sorted(_TRAINER_KEYS)}. (Refusing to silently drop them — "
            f"an ignored override builds a different model than requested.)")
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is available')
    module = PARSeq(cfg)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        module.init_weights(torch.Generator().manual_seed(seed))
    module = module.to(device).eval()
    adapter = CharsetAdapter(model_cfg.get('charset_test') or model_cfg['charset_train'])
    return ModelBundle(name=model_cfg.get('name', name), cfg=cfg, module=module, tokenizer=tok,
                       charset_adapter=adapter, device=device, dtype=dtype,
                       raw_config=model_cfg)


def create_model(experiment: str, *, seed: int = 0, dtype=torch.bfloat16, device='cuda',
                 config_root=None, **kwargs) -> ModelBundle:
    """Compose the config for `experiment` and build a model with random
    weights drawn from `seed`."""
    full = config_lib.compose(experiment, config_root=config_root)
    model_cfg = dict(full['model'])
    model_cfg.update(kwargs)
    return _bundle(experiment, model_cfg, seed=seed, dtype=dtype, device=device)


def load_from_checkpoint(path: str, *, dtype=torch.bfloat16, device='cuda', config_root=None,
                         **kwargs) -> ModelBundle:
    """Load a reference PyTorch `.pt` state_dict (model family from the file
    name; a Lightning 'state_dict' wrapper and 'model.' prefixes are stripped)."""
    if not path.endswith('.pt'):
        raise NotImplementedError(
            f'{path}: only reference PyTorch .pt files load in the port; native msgpack '
            '.ckpt loading is queued in ROADMAP.md')
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    if any(k.startswith('model.') for k in obj):
        obj = {k.removeprefix('model.'): v for k, v in obj.items() if k.startswith('model.')}
    name = _family(os.path.basename(path).lower())
    full = config_lib.compose(name, config_root=config_root)
    model_cfg = dict(full['model'])
    model_cfg.update(kwargs)
    return _bundle(name, model_cfg, dtype=dtype, device=device, state_dict=obj)
