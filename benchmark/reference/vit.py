"""ViT encoder (timm's VisionTransformer as PARSeq and ViTSTR use it): patch
projection, [class token,] positional table, pre-LN blocks, final LayerNorm.

`p` maps the port's state_dict names to float32 tensors; `prefix` is
'encoder.' for PARSeq and '' for ViTSTR (flat keys).
"""

from __future__ import annotations

from .ops import attend, gelu, layer_norm, merge_heads, split_heads


def patchify(x, ph, pw):
    """(B, H, W, C) -> (B, N, C * ph * pw), rows of patches in row-major
    order, each patch flattened in the (C, ph, pw) order of a Conv2d weight."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ph, ph, W // pw, pw, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // ph) * (W // pw), C * ph * pw)


def encode(ops, p, prefix, images, *, patch, depth, heads, class_token=False):
    """images (B, H, W, 3) float32 in [-1, 1] -> tokens (B, N[+1], D)."""
    w = p[prefix + 'patch_embed.proj.weight']
    x = ops.linear(patchify(images, *patch), w.reshape(w.shape[0], -1),
                   p[prefix + 'patch_embed.proj.bias'])
    if class_token:
        import torch

        x = torch.cat([p[prefix + 'cls_token'].expand(x.shape[0], 1, x.shape[-1]), x], dim=1)
    x = x + p[prefix + 'pos_embed']
    for i in range(depth):
        b = f'{prefix}blocks.{i}.'
        h = layer_norm(x, p[b + 'norm1.weight'], p[b + 'norm1.bias'])
        q, k, v = (split_heads(t, heads) for t in
                   ops.linear(h, p[b + 'attn.qkv.weight'], p[b + 'attn.qkv.bias']).chunk(3, -1))
        x = x + ops.linear(merge_heads(attend(ops, q, k, v)), p[b + 'attn.proj.weight'],
                           p[b + 'attn.proj.bias'])
        h = layer_norm(x, p[b + 'norm2.weight'], p[b + 'norm2.bias'])
        h = gelu(ops.linear(h, p[b + 'mlp.fc1.weight'], p[b + 'mlp.fc1.bias']))
        x = x + ops.linear(h, p[b + 'mlp.fc2.weight'], p[b + 'mlp.fc2.bias'])
    return layer_norm(x, p[prefix + 'norm.weight'], p[prefix + 'norm.bias'])


def init_kind(name):
    """How timm's ViT initialises a parameter (harness/weights.py draws it):
    'zero' biases, 'one' LayerNorm scales, 'cls' the class token (N(0,
    1e-6)), 'tn' the rest (truncated normal, std 0.02, cut at 2 std)."""
    if name.endswith('bias'):
        return 'zero'
    if 'norm' in name and name.endswith('weight'):
        return 'one'
    if name.endswith('cls_token'):
        return 'cls'
    return 'tn'


def param_shapes(prefix, *, img, patch, dim, depth, mlp_ratio, class_token=False):
    """The encoder's parameter names and shapes."""
    D, F_ = dim, int(dim * mlp_ratio)
    n = (img[0] // patch[0]) * (img[1] // patch[1]) + int(class_token)
    out = {'patch_embed.proj.weight': (D, 3, *patch), 'patch_embed.proj.bias': (D,),
           'pos_embed': (1, n, D), 'norm.weight': (D,), 'norm.bias': (D,)}
    if class_token:
        out['cls_token'] = (1, 1, D)
    for i in range(depth):
        b = f'blocks.{i}.'
        out.update({b + 'norm1.weight': (D,), b + 'norm1.bias': (D,),
                    b + 'attn.qkv.weight': (3 * D, D), b + 'attn.qkv.bias': (3 * D,),
                    b + 'attn.proj.weight': (D, D), b + 'attn.proj.bias': (D,),
                    b + 'norm2.weight': (D,), b + 'norm2.bias': (D,),
                    b + 'mlp.fc1.weight': (F_, D), b + 'mlp.fc1.bias': (F_,),
                    b + 'mlp.fc2.weight': (D, F_), b + 'mlp.fc2.bias': (D,)})
    return {prefix + k: v for k, v in out.items()}
