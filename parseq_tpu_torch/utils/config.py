"""YAML config system mirroring the reference's Hydra group layout.

Groups (reference configs/: main + model/ + charset/ + dataset/ +
experiment/) compose the same way Hydra does for this repo
(strhub/models/utils.py:25-44 re-implements exactly this
resolution for hub use): main -> charset -> model -> experiment overlay ->
CLI overrides. No Hydra dependency; plain YAML + deep merge.

Also provides the reference's typed `key:type=value` CLI kwarg parser
(models/utils.py:96-104) used for checkpoint-time model overrides.
"""

from __future__ import annotations

import copy
from pathlib import Path

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / 'configs'


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def compose(experiment: str | None = None, config_root=None, overrides: dict | None = None,
            charset: str | None = None, dataset: str | None = None) -> dict:
    """Resolve the full config for an experiment (or the default model)."""
    root = Path(config_root or CONFIG_ROOT)
    cfg = _load(root / 'main.yaml')

    exp = {}
    if experiment:
        exp = _load(root / 'experiment' / f'{experiment}.yaml')
    model_group = exp.get('defaults', {}).get('model', cfg.get('defaults', {}).get('model', 'parseq'))
    charset_group = charset or exp.get('defaults', {}).get('charset', cfg.get('defaults', {}).get('charset', '94_full'))
    dataset_group = dataset or exp.get('defaults', {}).get('dataset', cfg.get('defaults', {}).get('dataset', 'real'))

    cfg['model'] = deep_merge(cfg.get('model', {}), _load(root / 'charset' / f'{charset_group}.yaml').get('model', {}))
    cfg['model'] = deep_merge(cfg['model'], _load(root / 'model' / f'{model_group}.yaml'))
    cfg['data'] = deep_merge(cfg.get('data', {}), _load(root / 'dataset' / f'{dataset_group}.yaml').get('data', {}))
    # experiment overlay: every top-level key except 'defaults' deep-merges
    for k, v in exp.items():
        if k == 'defaults':
            continue
        cfg[k] = deep_merge(cfg.get(k, {}), v) if isinstance(v, dict) else v
    # CLI overrides, then the reference main.yaml interpolations
    # (data.batch_size: ${model.batch_size} etc.): data.* always tracks
    # model.* unless data.* itself was overridden explicitly.
    overrides = overrides or {}
    if overrides:
        cfg = apply_dotted_overrides(cfg, overrides)
    cfg.setdefault('data', {})
    for key in ('batch_size', 'img_size', 'max_label_length'):
        if key in cfg['model'] and f'data.{key}' not in overrides:
            cfg['data'][key] = cfg['model'][key]
    cfg['data'].setdefault('charset_train', cfg['model'].get('charset_train'))
    cfg['data'].setdefault('charset_test', cfg['model'].get('charset_test'))
    if 'lr' in cfg.get('model', {}):
        cfg['model']['lr'] = float(cfg['model']['lr'])
    return cfg


def apply_dotted_overrides(cfg: dict, overrides: dict) -> dict:
    """{'model.lr': 1e-3, 'trainer.devices': 4} -> nested merge."""
    for dotted, value in overrides.items():
        node = cfg
        keys = dotted.split('.')
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return cfg


def parse_model_args(args):
    """Reference `name:type=value` parser (models/utils.py:96-104)."""
    kwargs = {}
    arg_types = {t.__name__: t for t in [int, float, str]}
    arg_types['bool'] = lambda v: v.lower() == 'true'
    for arg in args:
        name, value = arg.split('=', maxsplit=1)
        name, arg_type = name.split(':', maxsplit=1)
        kwargs[name] = arg_types[arg_type](value)
    return kwargs


def parse_cli_overrides(tokens):
    """Hydra-style `a.b=value` tokens -> dict with YAML-typed values."""
    out = {}
    for tok in tokens:
        if '=' not in tok:
            raise ValueError(f'override must be key=value, got {tok!r}')
        k, v = tok.split('=', 1)
        out[k] = yaml.safe_load(v)
    return out
