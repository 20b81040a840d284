"""ViTSTR (Atienza, ICDAR 2021): a ViT with a class token whose first
max_label_length + 2 tokens go through one linear head; the class token's
position is dropped."""

from __future__ import annotations

from .ops import Ops
from .vit import encode
from .vit import init_kind  # noqa: F401  (timm's ViT init, as the released code)

# one parallel read: no AR picks to teacher-force on
AR = False


def logits(p, images, cfg, ops=None):
    """images (B, H, W, 3) float32 in [-1, 1] -> (B, max_label_length + 1,
    num_classes) float32."""
    ops = ops or Ops()
    x = encode(ops, p, '', images, patch=tuple(cfg['patch_size']), depth=cfg['depth'],
               heads=cfg['num_heads'], class_token=True)
    x = x[:, 1:cfg['max_label_length'] + 2]
    return ops.linear(x, p['head.weight'], p['head.bias'])


def read(p, cfg, ids, images, picks=None, ops=None):
    """(None, the logits): there is no AR pass."""
    return None, logits(p, images, cfg, ops)


def param_shapes(cfg, ids):
    from .vit import param_shapes as vit_shapes

    out = vit_shapes('', img=cfg['img_size'], patch=cfg['patch_size'], dim=cfg['embed_dim'],
                     depth=cfg['depth'], mlp_ratio=cfg.get("mlp_ratio", 4), class_token=True)
    out.update({'head.weight': (ids.num_classes, cfg['embed_dim']),
                'head.bias': (ids.num_classes,)})
    return out
