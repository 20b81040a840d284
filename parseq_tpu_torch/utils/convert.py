"""JAX PARSeq parameters -> reference-schema state_dict (inverse of
parseq_tpu/utils/torch_convert.py:convert_vit_encoder / convert_parseq).

This is how weights move from the JAX package to the port:

    sd = state_dict_from_jax(params)        # params: parseq.init / convert_parseq tree
    model.load_state_dict(sd, strict=True)

Per leaf: JAX linear weights (in, out) are transposed to torch (out, in);
separate q/k/v projections are packed into `qkv` (timm) and `in_proj_*`
(nn.MultiheadAttention); the patch matmul weight (ph*pw*C, D), flattened
in (ph, pw, C) order, is permuted back to the Conv2d layout (D, C, ph, pw);
the depth-stacked encoder blocks are unstacked. Leaves may be numpy or jax
arrays (anything np.asarray takes); no jax import is needed.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _lin(sd, prefix, p):
    sd[f'{prefix}.weight'] = _t(np.asarray(p['w']).T)
    if 'b' in p:
        sd[f'{prefix}.bias'] = _t(p['b'])


def _ln(sd, prefix, p):
    sd[f'{prefix}.weight'] = _t(p['scale'])
    sd[f'{prefix}.bias'] = _t(p['bias'])


def _packed(p):
    """q/k/v (in, out) weights -> packed (3D, D) torch weight and (3D,) bias."""
    w = np.concatenate([np.asarray(p[k]['w']).T for k in 'qkv'], axis=0)
    b = np.concatenate([np.asarray(p[k]['b']) for k in 'qkv'], axis=0)
    return _t(w), _t(b)


def vit_state_dict(enc, prefix='encoder', patch_size=(4, 8), in_chans=3):
    """vit.init-layout encoder params -> timm VisionTransformer state_dict."""
    pre = f'{prefix}.' if prefix else ''
    sd = {}
    ph, pw = patch_size
    w = np.asarray(enc['patch_embed']['w'])
    D = w.shape[1]
    sd[f'{pre}patch_embed.proj.weight'] = _t(w.reshape(ph, pw, in_chans, D).transpose(3, 2, 0, 1))
    sd[f'{pre}patch_embed.proj.bias'] = _t(enc['patch_embed']['b'])
    sd[f'{pre}pos_embed'] = _t(enc['pos_embed'])
    blocks = enc['blocks']
    depth = np.asarray(blocks['norm1']['scale']).shape[0]
    for i in range(depth):
        bp = f'{pre}blocks.{i}'
        blk = _index_tree(blocks, i)
        _ln(sd, f'{bp}.norm1', blk['norm1'])
        sd[f'{bp}.attn.qkv.weight'], sd[f'{bp}.attn.qkv.bias'] = _packed(blk['attn'])
        _lin(sd, f'{bp}.attn.proj', blk['attn']['out'])
        _ln(sd, f'{bp}.norm2', blk['norm2'])
        _lin(sd, f'{bp}.mlp.fc1', blk['mlp']['fc1'])
        _lin(sd, f'{bp}.mlp.fc2', blk['mlp']['fc2'])
    _ln(sd, f'{pre}norm', enc['norm'])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(params, patch_size=(4, 8), in_chans=3):
    """JAX PARSeq param tree -> reference PARSeq state_dict (float32 tensors)."""
    sd = vit_state_dict(params['encoder'], 'encoder', patch_size, in_chans)
    for i, lp in enumerate(params['decoder']['layers']):
        pre = f'decoder.layers.{i}'
        for attn in ('self_attn', 'cross_attn'):
            w, b = _packed(lp[attn])
            sd[f'{pre}.{attn}.in_proj_weight'] = w
            sd[f'{pre}.{attn}.in_proj_bias'] = b
            _lin(sd, f'{pre}.{attn}.out_proj', lp[attn]['out'])
        _lin(sd, f'{pre}.linear1', lp['linear1'])
        _lin(sd, f'{pre}.linear2', lp['linear2'])
        for norm in ('norm1', 'norm2', 'norm_q', 'norm_c'):
            _ln(sd, f'{pre}.{norm}', lp[norm])
    _ln(sd, 'decoder.norm', params['decoder']['norm'])
    _lin(sd, 'head', params['head'])
    sd['text_embed.embedding.weight'] = _t(params['text_embed']['w'])
    sd['pos_queries'] = _t(params['pos_queries'])
    return sd
