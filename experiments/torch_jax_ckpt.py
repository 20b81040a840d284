"""Write a PARSeq state_dict as a JAX package checkpoint, without jax, flax or
msgpack (the GPU host has none of them).

    from experiments.torch_jax_ckpt import save_parseq_as_jax
    save_parseq_as_jax('parseq-jax.ckpt', module.state_dict(), model_config)

The file is what parseq_tpu/utils/checkpoint.py:save_checkpoint writes for
PARSeq: a msgpack map {'params', 'config', 'meta'} in the encoding of
flax.serialization.msgpack_serialize (numpy leaves as ext type 1, a packed
(shape, dtype name, bytes)), the params in the JAX package's layout
(parseq_tpu/utils/torch_convert.py:convert_parseq's, kept here in numpy).
chip_smoke.py phase 12 loads it through the port's reader
(utils/registry.py:load_from_checkpoint) on the card;
tests/test_torch_jax_checkpoint.py holds it to flax's reader and to the
JAX package's load on the CPU.
"""

from __future__ import annotations

import json
import struct

import numpy as np


def _np(x):
    return x.detach().float().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)


def _lin(sd, prefix):
    p = {'w': np.ascontiguousarray(_np(sd[f'{prefix}.weight']).T)}
    if f'{prefix}.bias' in sd:
        p['b'] = _np(sd[f'{prefix}.bias'])
    return p


def _ln(sd, prefix):
    return {'scale': _np(sd[f'{prefix}.weight']), 'bias': _np(sd[f'{prefix}.bias'])}


def _qkvo(w, b, out):
    d = w.shape[1]
    ws, bs = w.reshape(3, d, d), b.reshape(3, d)
    tree = {k: {'w': np.ascontiguousarray(ws[i].T), 'b': bs[i]} for i, k in enumerate('qkv')}
    tree['out'] = out
    return tree


def _depth(sd, prefix):
    return 1 + max(int(k[len(prefix):].split('.')[0]) for k in sd if k.startswith(prefix))


def parseq_tree(sd):
    """A reference-schema PARSeq state_dict -> the JAX package's parseq.init
    param tree (numpy f32 leaves, encoder blocks stacked on a depth axis)."""
    blocks = []
    for i in range(_depth(sd, 'encoder.blocks.')):
        bp = f'encoder.blocks.{i}'
        blocks.append({
            'norm1': _ln(sd, f'{bp}.norm1'),
            'attn': _qkvo(_np(sd[f'{bp}.attn.qkv.weight']), _np(sd[f'{bp}.attn.qkv.bias']),
                          _lin(sd, f'{bp}.attn.proj')),
            'norm2': _ln(sd, f'{bp}.norm2'),
            'mlp': {'fc1': _lin(sd, f'{bp}.mlp.fc1'), 'fc2': _lin(sd, f'{bp}.mlp.fc2')},
        })

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    conv = _np(sd['encoder.patch_embed.proj.weight'])  # (D, C, ph, pw)
    layers = []
    for i in range(_depth(sd, 'decoder.layers.')):
        lp = f'decoder.layers.{i}'
        layer = {a: _qkvo(_np(sd[f'{lp}.{a}.in_proj_weight']), _np(sd[f'{lp}.{a}.in_proj_bias']),
                          _lin(sd, f'{lp}.{a}.out_proj')) for a in ('self_attn', 'cross_attn')}
        layer.update({'linear1': _lin(sd, f'{lp}.linear1'), 'linear2': _lin(sd, f'{lp}.linear2')})
        layer.update({n: _ln(sd, f'{lp}.{n}') for n in ('norm1', 'norm2', 'norm_q', 'norm_c')})
        layers.append(layer)
    return {
        'encoder': {
            'patch_embed': {'w': np.ascontiguousarray(conv.transpose(2, 3, 1, 0).reshape(
                -1, conv.shape[0])), 'b': _np(sd['encoder.patch_embed.proj.bias'])},
            'pos_embed': _np(sd['encoder.pos_embed']),
            'blocks': stack(*blocks),
            'norm': _ln(sd, 'encoder.norm'),
        },
        'decoder': {'layers': layers, 'norm': _ln(sd, 'decoder.norm')},
        'head': _lin(sd, 'head'),
        'text_embed': {'w': _np(sd['text_embed.embedding.weight'])},
        'pos_queries': _np(sd['pos_queries']),
    }


def _head(n, fix, fix_limit, codes):
    """A msgpack length header: the fix form below fix_limit, else the
    first of `codes` (8, 16, 32-bit lengths) that holds n."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'msgpack length {n} too large')


def packb(obj) -> bytes:
    """msgpack-encode the subset a flax checkpoint holds: dict, list/tuple,
    str, bytes, bool, None, int, float (float64) and numpy arrays (flax's
    ext type 1)."""
    if obj is None:
        return b'\xc0'
    if obj is True or obj is False:
        return b'\xc3' if obj else b'\xc2'
    if isinstance(obj, int):
        if 0 <= obj < 128:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack('>b', obj)
        return b'\xd3' + struct.pack('>q', obj)
    if isinstance(obj, float):
        return b'\xcb' + struct.pack('>d', obj)
    if isinstance(obj, str):
        b = obj.encode()
        return _head(len(b), 0xa0, 32, ((0xd9, '>B'), (0xda, '>H'), (0xdb, '>I'))) + b
    if isinstance(obj, bytes):
        return _head(len(obj), None, 0, ((0xc4, '>B'), (0xc5, '>H'), (0xc6, '>I'))) + obj
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), 0x90, 16, ((0xdc, '>H'), (0xdd, '>I'))) + b''.join(
            packb(v) for v in obj)
    if isinstance(obj, dict):
        return _head(len(obj), 0x80, 16, ((0xde, '>H'), (0xdf, '>I'))) + b''.join(
            packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        payload = packb([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()])
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(payload) in fixext:
            return bytes([fixext[len(payload)], 1]) + payload
        return _head(len(payload), None, 0, ((0xc7, '>B'), (0xc8, '>H'), (0xc9, '>I'))) \
            + b'\x01' + payload
    raise TypeError(f'cannot msgpack {type(obj).__name__}')


def save_parseq_as_jax(path, state_dict, model_config, name='parseq'):
    """Write `state_dict` (PARSeq, reference schema) as the JAX package's
    trainer writes a checkpoint (meta: name and model_config)."""
    payload = {'params': parseq_tree(state_dict), 'config': json.dumps(model_config),
               'meta': json.dumps({'name': name, 'model_config': model_config})}
    with open(path, 'wb') as f:
        f.write(packb(payload))
