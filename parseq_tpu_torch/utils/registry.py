"""Model registry: experiment name -> config + module + inference bundle
(port of parseq_tpu/utils/registry.py: the PARSeq, ViTSTR, CRNN, TRBA,
TRBC and ABINet families).

Configs are composed from the repository's `configs/` groups by the port's
`utils/config.py`. Checkpoints: reference PyTorch `.pt` state_dicts load
with `load_state_dict(strict=True)`; the port's own training checkpoints
(`utils/checkpoint.py`, `.ckpt`) and the JAX package's msgpack `.ckpt` load
with their stored model config.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from parseq_tpu_torch.data.charset import CharsetAdapter
from parseq_tpu_torch.data.tokenizer import CTCTokenizer, Tokenizer
from parseq_tpu_torch.utils import config as config_lib
from parseq_tpu_torch.models.abinet import ABINet, ABINetConfig
from parseq_tpu_torch.models.crnn import CRNN, CRNNConfig
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.models.trba import TRBA, TRBAConfig
from parseq_tpu_torch.models.vitstr import ViTSTR, ViTSTRConfig


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

    def read(self, images, *, gaps=False):
        """images (B, H, W, 3) in [-1, 1] -> (labels, confidences); with
        gaps, also each read's smallest top-1 - top-2 probability over the
        steps that decide it (through EOS; every step of CTC)."""
        probs = torch.softmax(self(images), dim=-1).cpu().numpy()
        labels, step_probs = self.tokenizer.decode(probs)
        confs = [float(np.prod(p)) for p in step_probs]
        if not gaps:
            return labels, confs
        top2 = np.sort(probs, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        return labels, confs, [float(m[:len(p)].min()) for m, p in zip(margin, step_probs)]


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


def _build_vitstr(model_cfg: dict):
    tok = Tokenizer(model_cfg['charset_train'])
    cfg = ViTSTRConfig(
        num_tokens=len(tok),
        max_label_length=model_cfg.get('max_label_length', 25),
        img_size=tuple(model_cfg.get('img_size', (224, 224))),
        patch_size=tuple(model_cfg.get('patch_size', (16, 16))),
        embed_dim=model_cfg.get('embed_dim', 384),
        num_heads=model_cfg.get('num_heads', 6),
        depth=model_cfg.get('depth', 12),
    )
    return cfg, tok


def _build_crnn(model_cfg: dict):
    tok = CTCTokenizer(model_cfg['charset_train'])
    cfg = CRNNConfig(
        num_tokens=len(tok),
        max_label_length=model_cfg.get('max_label_length', 25),
        img_size=tuple(model_cfg.get('img_size', (32, 128))),
        hidden_size=model_cfg.get('hidden_size', 256),
        leaky_relu=model_cfg.get('leaky_relu', False),
    )
    return cfg, tok


def _build_trba(model_cfg: dict, use_ctc=False):
    charset = model_cfg['charset_train']
    tok = CTCTokenizer(charset) if use_ctc else Tokenizer(charset)
    cfg = TRBAConfig(
        num_tokens=len(tok),
        max_label_length=model_cfg.get('max_label_length', 25),
        img_size=tuple(model_cfg.get('img_size', (32, 128))),
        num_fiducial=model_cfg.get('num_fiducial', 20),
        output_channel=model_cfg.get('output_channel', 512),
        hidden_size=model_cfg.get('hidden_size', 256),
        use_ctc=use_ctc,
    )
    return cfg, tok


def _build_abinet(model_cfg: dict):
    tok = Tokenizer(model_cfg['charset_train'])
    cfg = ABINetConfig(
        num_tokens=len(tok),
        max_label_length=model_cfg.get('max_label_length', 25),
        img_size=tuple(model_cfg.get('img_size', (32, 128))),
        d_model=model_cfg.get('d_model', 512),
        nhead=model_cfg.get('nhead', 8),
        d_inner=model_cfg.get('d_inner', 2048),
        dropout=model_cfg.get('dropout', 0.1),
        activation=model_cfg.get('activation', 'relu'),
        v_backbone=model_cfg.get('v_backbone', 'transformer'),
        v_num_layers=model_cfg.get('v_num_layers', 3),
        v_attention=model_cfg.get('v_attention', 'position'),
        v_attention_mode=model_cfg.get('v_attention_mode', 'nearest'),
        l_num_layers=model_cfg.get('l_num_layers', 4),
        l_use_self_attn=model_cfg.get('l_use_self_attn', False),
        l_detach=model_cfg.get('l_detach', True),
        iter_size=model_cfg.get('iter_size', 3),
        v_loss_weight=model_cfg.get('v_loss_weight', 1.0),
        l_loss_weight=model_cfg.get('l_loss_weight', 1.0),
        a_loss_weight=model_cfg.get('a_loss_weight', 1.0),
    )
    return cfg, tok


# family -> (config builder, module class)
_BUILDERS = {
    'parseq': (_build_parseq, PARSeq),
    'vitstr': (_build_vitstr, ViTSTR),
    'crnn': (_build_crnn, CRNN),
    'trba': (_build_trba, TRBA),
    'trbc': (lambda model_cfg: _build_trba(model_cfg, use_ctc=True), TRBA),
    'abinet': (_build_abinet, ABINet),
}


def _bundle(name, model_cfg, *, seed=0, dtype=torch.bfloat16, device='cuda', state_dict=None):
    family = _family(name)
    build, module_cls = _BUILDERS[family]
    tracked = _TrackedCfg(model_cfg)
    cfg, tok = build(tracked)
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
    module = module_cls(cfg)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        module.init_weights(torch.Generator().manual_seed(seed))
    module = module.to(device).eval()
    adapter = CharsetAdapter(model_cfg.get('charset_test') or model_cfg['charset_train'])
    return ModelBundle(name=model_cfg.get('name', name), cfg=cfg, module=module, tokenizer=tok,
                       charset_adapter=adapter, device=device, dtype=dtype,
                       raw_config=model_cfg)


def build_model(name: str, model_cfg: dict, *, seed: int = 0, dtype=torch.bfloat16,
                device='cuda') -> ModelBundle:
    """A model with random weights from `seed` built from an already composed
    model config (the train loop's: `name`, e.g. 'abinet-lm', names no
    experiment file of its own)."""
    return _bundle(name, dict(model_cfg), seed=seed, dtype=dtype, device=device)


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
    """Load a model from
    - `pretrained=<experiment>`: the released weights of the experiment,
      resolved offline from the checksum cache (utils/pretrained.py);
    - a checkpoint the port's trainer wrote (utils/checkpoint.py; a dict
      of 'state_dict', 'config' and 'meta'): its stored model config
      builds the model; or
    - any other PyTorch file (`.pt` or `.ckpt`), a reference state_dict:
      the model family from the file name, a Lightning 'state_dict' wrapper
      and 'model.' prefixes stripped; or
    - a JAX package checkpoint (msgpack, parseq_tpu/utils/checkpoint.py):
      its stored model config builds the model and its param tree is
      converted by the family's utils/convert.py function.
    Both packages write `.ckpt`, so the format is told by the file's first
    bytes, never by its extension."""
    if path.startswith('pretrained='):
        from parseq_tpu_torch.utils.pretrained import load_pretrained

        return load_pretrained(path.split('=', 1)[1], dtype=dtype, device=device,
                               config_root=config_root, **kwargs)
    with open(path, 'rb') as f:
        head = f.read(4)
    if not _looks_like_torch(head):
        from parseq_tpu_torch.utils.msgpack import looks_like_msgpack_map

        if looks_like_msgpack_map(head):
            return _from_jax(path, dtype=dtype, device=device, **kwargs)
        raise ValueError(f'{path}: neither a torch.save file nor a JAX package msgpack '
                         f'checkpoint (first bytes {head!r})')
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if _is_port_checkpoint(obj):
        from parseq_tpu_torch.utils.checkpoint import read_payload

        sd, _, meta = read_payload(obj)
        model_cfg = dict(meta.get('model_config') or {})
        model_cfg.update(kwargs)
        name = meta.get('name') or model_cfg.get('name') or 'parseq'
        return _bundle(name, model_cfg, dtype=dtype, device=device, state_dict=sd)
    return _from_reference(obj, _family(os.path.basename(path).lower()), dtype=dtype,
                           device=device, config_root=config_root, **kwargs)


def _from_reference(obj, experiment, *, dtype=torch.bfloat16, device='cuda', config_root=None,
                    **kwargs):
    """Build `experiment` (its composed config, e.g. parseq-tiny's 192-dim
    geometry) with the reference state_dict `obj` (bare or Lightning-wrapped)."""
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    if any(k.startswith('model.') for k in obj):
        obj = {k.removeprefix('model.'): v for k, v in obj.items() if k.startswith('model.')}
    full = config_lib.compose(experiment, config_root=config_root)
    model_cfg = dict(full['model'])
    model_cfg.update(kwargs)
    return _bundle(experiment, model_cfg, dtype=dtype, device=device, state_dict=obj)


def _as_numpy(tree):
    """A JAX checkpoint's param tree with every leaf a numpy array (bf16
    leaves, torch tensors from utils/msgpack.py, widened to float32)."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree)


def _state_dict_from_jax_tree(family, params, model_cfg):
    """A JAX package param tree of `family` -> the port's state_dict. The CNN
    families and ABINet were saved as {'params', 'stats'}, PARSeq and ViTSTR
    as bare params (parseq_tpu/train/loop.py:_maybe_flatten)."""
    from parseq_tpu_torch.utils import convert

    params = _as_numpy(params)
    tree, stats = ((params['params'], params['stats'])
                   if isinstance(params, dict) and set(params) == {'params', 'stats'}
                   else (params, None))
    if (stats is None) != (family in ('parseq', 'vitstr')):
        raise InvalidModelError(f'a {family} JAX checkpoint whose tree is '
                                f'{"bare params" if stats is None else "params and stats"}')
    if family == 'parseq':
        return convert.state_dict_from_jax(tree, tuple(model_cfg.get('patch_size', (4, 8))))
    if family == 'vitstr':
        return convert.vitstr_state_dict_from_jax(tree,
                                                  tuple(model_cfg.get('patch_size', (16, 16))))
    if family == 'abinet':
        return convert.abinet_state_dict_from_jax(
            tree, stats, img_size=tuple(model_cfg.get('img_size', (32, 128))),
            max_label_length=model_cfg.get('max_label_length', 25))
    if family == 'crnn':
        return convert.crnn_state_dict_from_jax(tree, stats)
    return convert.trba_state_dict_from_jax(tree, stats, use_ctc=family == 'trbc')


def _from_jax(path, *, dtype=torch.bfloat16, device='cuda', **kwargs):
    """A JAX package checkpoint: its meta's model config (updated by
    `kwargs`) builds the model, its params converted to a state_dict."""
    from parseq_tpu_torch.utils.checkpoint import load_jax_checkpoint

    params, _, meta = load_jax_checkpoint(path)
    model_cfg = dict(meta.get('model_config') or {})
    model_cfg.update(kwargs)
    name = meta.get('name') or model_cfg.get('name') or 'parseq'
    sd = _state_dict_from_jax_tree(_family(name), params, model_cfg)
    return _bundle(name, model_cfg, dtype=dtype, device=device, state_dict=sd)


def _is_port_checkpoint(obj) -> bool:
    """A payload of utils/checkpoint.py: 'state_dict', 'config' and 'meta',
    the last two JSON strings (a Lightning file's 'state_dict' has no such
    siblings)."""
    return (isinstance(obj, dict) and {'state_dict', 'config', 'meta'} <= set(obj)
            and isinstance(obj['config'], str) and isinstance(obj['meta'], str))


def _looks_like_torch(head: bytes) -> bool:
    """A torch.save file by its first bytes: a zip archive, or the legacy
    pickle's protocol 2 header b'\\x80\\x02' (the JAX package's check,
    parseq_tpu/utils/registry.py:_looks_like_torch, compares four bytes to
    b'\\x80\\x02\\x00\\x00', which no legacy file begins with)."""
    return head[:2] in (b'PK', b'\x80\x02')
