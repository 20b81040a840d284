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

Where `takes_encoder_kernel` holds (bf16 tokens on a CUDA device, no
autograd, outside kernels.plain(), no int8 weight, shapes that kernel B5
takes: PARSeq-S's L = 128 encoder in inference), all blocks run as one launch of B5
(ops/encoder_kernel.py) on operands stacked once and kept between calls;
everything else runs the eager blocks. B5 wins at every batch, one image
included: wall ms a call at L 128, D 384, 6 heads, MLP 1536, depth 12,
bf16, host work included, on an NVIDIA H100 80GB HBM3 at 700 W
(experiments/torch_encoder_kernel_bench.py --sweep; B5 with its operands
built, the route = the kept operands' check + B5):

    B       1      8     32     64    128    256    512
    B5      4.21   4.20   4.32   4.28   4.78   6.81  13.35
    route   4.29   4.54   4.53   4.67   5.05   7.30  14.10
    eager   8.43   8.61  10.29   8.00  13.18  25.45  48.06

At B = 1 one block runs all twelve layers; the eager blocks' ~300 launches
take longer on the host.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops import encoder_kernel, quant
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
        self._stacked = None  # (parameters, their state, operands) of stacked_blocks

    def patch_embedding(self, images):
        """images (B, H, W, C) -> tokens (B, N, D) in the images' dtype."""
        x = images.permute(0, 3, 1, 2)
        proj = self.patch_embed.proj
        out = F.conv2d(x, proj.weight.to(x.dtype), stride=proj.stride)
        out = out.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major patch order
        return out + proj.bias.to(x.dtype)

    def tokens(self, images):
        """images (B, H, W, C) -> the blocks' input (B, N[+1], D) in the
        images' dtype: patch embedding, [cls ;] and positions."""
        x = self.patch_embedding(images)
        if self.class_token:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([cls, x], dim=1)
        return x + self.pos_embed.to(x.dtype)

    def eager_blocks(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x

    def fused_blocks(self, x):
        """Every block on x (B, L, D) in one launch of kernel B5."""
        return encoder_kernel.fused_encoder_blocks(self.stacked_blocks(), x,
                                                   num_heads=self.blocks[0].num_heads)

    def stacked_blocks(self):
        """B5's operands (encoder_kernel.stack_block_params) of the blocks,
        kept while every block parameter is the same object (held by a weak
        reference, so a replaced Parameter never matches, whatever address
        its storage takes) with the device, storage and version it was
        stacked from: an optimizer step or load_state_dict (in place), .to()
        (new tensors) or a Parameter set anew make them stale, and they are
        stacked anew. Inference tensors (parameters made or moved inside
        torch.inference_mode()) keep no version, so nothing would tell an
        in-place change: their operands are stacked on every call."""
        params = [p for m in self.blocks.modules() for p in m._parameters.values()
                  if p is not None]
        if any(p.is_inference() for p in params):
            self._stacked = None
            with torch.no_grad():
                return encoder_kernel.stack_block_params(self.blocks)
        state = [(p.device, p.data_ptr(), p._version) for p in params]
        kept = self._stacked
        if (kept is None or kept[1] != state or len(kept[0]) != len(params)
                or any(ref() is not p for ref, p in zip(kept[0], params))):
            self._stacked = None
            with torch.no_grad():
                self._stacked = ([weakref.ref(p) for p in params], state,
                                 encoder_kernel.stack_block_params(self.blocks))
        return self._stacked[2]

    def __getstate__(self):
        # pickling (torch.save of the module) drops the kept operands and
        # their weak references, which cannot be pickled
        state = super().__getstate__()
        state['_stacked'] = None
        return state

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .cpu(): drop the stacked operands with the tensors
        # they were made from, which frees them on the device the module
        # leaves, and no later tensor at a reused address and version can
        # match their key
        self._stacked = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, images):
        """images (B, H, W, C) -> tokens (B, N[+1], D), final LN applied;
        the span vit.encoder, with device events, its attribute `fused` True
        where the blocks ran as one launch of kernel B5."""
        # the tokens' shape is the positional table's (a subclass's cfg may
        # be another config: ViTSTR's counts characters in num_tokens)
        shape = (images.shape[0], *self.pos_embed.shape[1:])
        fused = (len(self.blocks) > 0 and takes_encoder_kernel(
            images.device, images.dtype, shape, self.blocks[0].num_heads, self.blocks))
        with trace.span('vit.encoder', device=True, rows=images.shape[0], fused=fused):
            x = self.tokens(images)
            x = self.fused_blocks(x) if fused else self.eager_blocks(x)
            return layer_norm(x, self.norm.weight, self.norm.bias)


def takes_encoder_kernel(device, dtype, shape, num_heads, blocks):
    """Whether `blocks` run as one launch of kernel B5 on tokens of this
    device, dtype and (B, L, D) shape: a CUDA device, bf16, autograd off,
    kernels.enabled(), no block weight an int8 Int8Weight, and
    shapes the kernel takes (encoder_kernel.takes). Anything else (the CPU,
    training, f32, the int8 path, ViTSTR's L = 197, widths other than 64 a
    head up to 512) runs the eager blocks."""
    _, L, D = shape
    if (device.type != 'cuda' or dtype != torch.bfloat16 or torch.is_grad_enabled()
            or not kernels.enabled()):
        return False
    if any(quant.is_quantized(lin.weight) for b in blocks
           for lin in (b.attn.qkv, b.attn.proj, b.mlp.fc1, b.mlp.fc2)):
        return False
    return encoder_kernel.takes(L, D, num_heads, blocks[0].mlp.fc1.weight.shape[0])
