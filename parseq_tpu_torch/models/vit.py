"""Vision Transformer encoder (port of parseq_tpu/models/vit.py).

Parameter names follow timm's VisionTransformer, so the encoder part of a
reference state_dict loads as is: patch_embed.proj (Conv2d), pos_embed,
blocks.{i}.norm1, .attn.qkv (packed), .attn.proj, .norm2, .mlp.fc1,
.mlp.fc2, norm. Images are NHWC at the public interface, as in the JAX
package, and are permuted to NCHW for the patch Conv2d (a stride==kernel
convolution, i.e. the patch matmul). With `class_token` (ViTSTR) a
`cls_token` (1, 1, D) is prepended before the positional table, which then
covers cls + patches (timm's default); the PARSeq encoder has none.

Forward semantics: patch_embed -> [cls ;] -> +pos_embed -> pre-LN blocks
(x += attn(ln(x)); x += mlp(ln(x))) -> final LayerNorm. Self-attention at
L >= KERNEL_MIN_LEN runs kernel B2 (ops/attention.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch.ops.attention import encoder_self_attention
from parseq_tpu_torch.ops.layers import layer_norm, mlp
from parseq_tpu_torch.utils import trace


@dataclass(frozen=True)
class ViTConfig:
    img_size: tuple[int, int] = (32, 128)  # (H, W)
    patch_size: tuple[int, int] = (4, 8)  # (ph, pw)
    in_chans: int = 3
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    class_token: bool = False  # PARSeq encoder: False; ViTSTR: True
    remat: bool = False  # JAX training-memory lever; the port trains without it

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.img_size[0] // self.patch_size[0], self.img_size[1] // self.patch_size[1])

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def num_tokens(self) -> int:
        return self.num_patches + int(self.class_token)


class _Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(d)
        self.attn = _Attention(d)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))

    def forward(self, x):
        h = layer_norm(x, self.norm1.weight, self.norm1.bias)
        x = x + encoder_self_attention(h, self.attn.qkv.weight, self.attn.qkv.bias,
                                       self.attn.proj.weight, self.attn.proj.bias,
                                       self.num_heads)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias)
        return x + mlp(h, self.mlp.fc1.weight, self.mlp.fc1.bias,
                       self.mlp.fc2.weight, self.mlp.fc2.bias)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.class_token = cfg.class_token
        d = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg)
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d)

    def patch_embedding(self, images):
        """images (B, H, W, C) -> tokens (B, N, D) in the images' dtype."""
        x = images.permute(0, 3, 1, 2)
        proj = self.patch_embed.proj
        out = F.conv2d(x, proj.weight.to(x.dtype), stride=proj.stride)
        out = out.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major patch order
        return out + proj.bias.to(x.dtype)

    def forward(self, images):
        """images (B, H, W, C) -> tokens (B, N[+1], D), final LN applied;
        the span vit.encoder, with device events."""
        with trace.span('vit.encoder', device=True, rows=images.shape[0]):
            x = self.patch_embedding(images)
            if self.class_token:
                cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
                x = torch.cat([cls, x], dim=1)
            x = x + self.pos_embed.to(x.dtype)
            for blk in self.blocks:
                x = blk(x)
            return layer_norm(x, self.norm.weight, self.norm.bias)
