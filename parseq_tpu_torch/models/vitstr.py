"""ViTSTR inference (port of parseq_tpu/models/vitstr.py).

A ViT with a class token whose first ``max_label_length + 2`` output tokens
go through one shared linear head; the class-token position is dropped,
giving the same (B, max_label_length + 1, num_classes) logits as PARSeq.
One parallel forward pass, no decoding loop. At 224x224 with 16x16 patches
the encoder runs L = 197, so every self-attention goes through kernel B2.

Parameters use the reference's flat keys (a timm ViT plus `head`):
patch_embed.proj, cls_token, pos_embed, blocks.{i}.*, norm, head — the keys
parseq_tpu/utils/torch_convert.py:convert_vitstr reads. `logits_loss` is
the training and validation loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from parseq_tpu_torch.models.vit import ViTConfig, VisionTransformer
from parseq_tpu_torch.ops.layers import ce_ignore_pad, linear


@dataclass(frozen=True)
class ViTSTRConfig:
    num_tokens: int = 97
    max_label_length: int = 25
    img_size: tuple[int, int] = (224, 224)
    patch_size: tuple[int, int] = (16, 16)
    embed_dim: int = 384
    num_heads: int = 6
    depth: int = 12
    mlp_ratio: float = 4.0

    @property
    def vit(self) -> ViTConfig:
        return ViTConfig(img_size=self.img_size, patch_size=self.patch_size,
                         embed_dim=self.embed_dim, depth=self.depth,
                         num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
                         class_token=True)

    @property
    def num_classes(self) -> int:
        return self.num_tokens - 2  # BOS/PAD never predicted

    @property
    def num_steps(self) -> int:
        return self.max_label_length + 1

    @property
    def eos_id(self) -> int:
        return 0

    @property
    def pad_id(self) -> int:
        return self.num_tokens - 1


class ViTSTR(VisionTransformer):
    """The encoder's parameters sit at the top level (flat reference keys)."""

    def __init__(self, cfg: ViTSTRConfig):
        super().__init__(cfg.vit)
        self.cfg = cfg
        self.head = nn.Linear(cfg.embed_dim, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights from `generator` with the JAX package's schemes:
        truncated normal (std 0.02, cut at 2 std) for linear, patch and
        positional weights, N(0, 1e-6) class token, zero biases, unit LN."""

        def tn(t):
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                tn(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        tn(self.pos_embed)
        nn.init.normal_(self.cls_token, std=1e-6, generator=generator)

    def forward(self, images, dtype=torch.float32):
        """images (B, H, W, 3) NHWC -> logits (B, max_label_length + 1,
        num_classes) f32."""
        x = super().forward(images.to(dtype))
        x = x[:, 1: self.cfg.max_label_length + 2]
        return linear(x, self.head.weight, self.head.bias).float()

    def logits_loss(self, images, tgt_ids, dtype=torch.float32):
        """CE against [chars..., EOS, PAD...] (tgt_ids (B, L + 2) with BOS
        first, dropped here), PAD ignored. Returns (logits, loss, numel)."""
        logits = self(images, dtype)
        targets = tgt_ids[:, 1: self.cfg.num_steps + 1]
        loss, numel = ce_ignore_pad(logits, targets, self.cfg.pad_id, self.cfg.num_classes)
        return logits, loss, numel
