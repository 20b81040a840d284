"""PARSeq inference (port of the inference half of parseq_tpu/models/parseq.py).

Parameters are held under the reference module names (the keys
parseq_tpu/utils/torch_convert.py:convert_parseq reads), so a released
PARSeq state_dict loads with `load_state_dict(strict=True)`:
decoder.layers.{i}.{self_attn,cross_attn}.{in_proj_weight,in_proj_bias,
out_proj.*}, .linear1, .linear2, .norm1, .norm2, .norm_q, .norm_c,
decoder.norm, head, text_embed.embedding.weight, pos_queries. The
computation goes through the port's own `ops.layers`, never through
nn.MultiheadAttention.forward.

Two-stream decoder layer (XLNet-style, pre-LN): the query stream attends
over the content stream; the content stream is updated by every layer
except the last. Decoding always covers the full num_steps positions; the
tokenizer truncates at the first EOS.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from parseq_tpu_torch.models.vit import ViTConfig, VisionTransformer
from parseq_tpu_torch.ops import layers
from parseq_tpu_torch.ops.layers import NEG_INF, layer_norm, linear


@dataclass(frozen=True)
class PARSeqConfig:
    """Same fields, defaults and properties as parseq_tpu's PARSeqConfig.
    The training-only fields are carried so one config dict builds both."""

    num_tokens: int = 97  # len(charset) + 3 specials (EOS/BOS/PAD)
    max_label_length: int = 25
    img_size: tuple[int, int] = (32, 128)
    patch_size: tuple[int, int] = (4, 8)
    embed_dim: int = 384
    enc_num_heads: int = 6
    enc_mlp_ratio: float = 4.0
    enc_depth: int = 12
    dec_num_heads: int = 12
    dec_mlp_ratio: float = 4.0
    dec_depth: int = 1
    decode_ar: bool = True
    refine_iters: int = 1
    dropout: float = 0.1
    remat: bool = False
    shared_perm_dropout: bool = False
    bulk_dropout_bits: bool = True
    bulk_bits_uint8: bool = True
    perm_num: int = 6
    perm_forward: bool = True
    perm_mirrored: bool = True

    @property
    def vit(self) -> ViTConfig:
        return ViTConfig(
            img_size=self.img_size,
            patch_size=self.patch_size,
            embed_dim=self.embed_dim,
            depth=self.enc_depth,
            num_heads=self.enc_num_heads,
            mlp_ratio=self.enc_mlp_ratio,
            remat=self.remat,
        )

    @property
    def num_steps(self) -> int:
        return self.max_label_length + 1  # +1 for EOS

    @property
    def num_classes(self) -> int:
        return self.num_tokens - 2  # BOS and PAD are never predicted

    @property
    def eos_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return self.num_tokens - 2

    @property
    def pad_id(self) -> int:
        return self.num_tokens - 1


class MultiheadAttentionParams(nn.Module):
    """Parameter holder with nn.MultiheadAttention's state_dict names."""

    def __init__(self, d):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, *, num_heads, attn_bias=None, key_padding_mask=None):
        return layers.mha(q, k, v, self.in_proj_weight, self.in_proj_bias,
                          self.out_proj.weight, self.out_proj.bias, num_heads=num_heads,
                          attn_bias=attn_bias, key_padding_mask=key_padding_mask)


def _ln(x, norm: nn.LayerNorm):
    return layer_norm(x, norm.weight, norm.bias)


class DecoderLayer(nn.Module):
    def __init__(self, d, nhead, dff):
        super().__init__()
        self.nhead = nhead
        self.self_attn = MultiheadAttentionParams(d)
        self.cross_attn = MultiheadAttentionParams(d)
        self.linear1 = nn.Linear(d, dff)
        self.linear2 = nn.Linear(dff, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm_q = nn.LayerNorm(d)
        self.norm_c = nn.LayerNorm(d)

    def forward_stream(self, tgt, tgt_norm, tgt_kv, memory, bias, key_padding_mask):
        """One stream of the two-stream layer."""
        tgt = tgt + self.self_attn(tgt_norm, tgt_kv, tgt_kv, num_heads=self.nhead,
                                   attn_bias=bias, key_padding_mask=key_padding_mask)
        tgt = tgt + self.cross_attn(_ln(tgt, self.norm1), memory, memory, num_heads=self.nhead)
        h = layers.gelu(linear(_ln(tgt, self.norm2), self.linear1.weight, self.linear1.bias))
        return tgt + linear(h, self.linear2.weight, self.linear2.bias)


class Decoder(nn.Module):
    def __init__(self, d, nhead, dff, depth):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d, nhead, dff) for _ in range(depth))
        self.norm = nn.LayerNorm(d)

    def forward(self, query, content, memory, *, query_bias=None, content_bias=None,
                padding_mask=None):
        """Content updated by all but the last layer; final LN on the query stream."""
        for i, lp in enumerate(self.layers):
            query_norm = _ln(query, lp.norm_q)
            content_norm = _ln(content, lp.norm_c)
            query = lp.forward_stream(query, query_norm, content_norm, memory,
                                      query_bias, padding_mask)
            if i != len(self.layers) - 1:
                content = lp.forward_stream(content, content_norm, content_norm, memory,
                                            content_bias, padding_mask)
        return _ln(query, self.norm)


class TokenEmbedding(nn.Module):
    def __init__(self, num_tokens, d):
        super().__init__()
        self.embedding = nn.Embedding(num_tokens, d)


def _causal_bias(n, device=None, dtype=torch.float32):
    """Forward-AR bias: query i may see keys <= i (triu(1) masked)."""
    r = torch.arange(n, device=device)
    return torch.where(r[None, :] > r[:, None], NEG_INF, 0.0).to(dtype)


class PARSeq(nn.Module):
    def __init__(self, cfg: PARSeqConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.encoder = VisionTransformer(cfg.vit)
        self.decoder = Decoder(d, cfg.dec_num_heads, int(d * cfg.dec_mlp_ratio), cfg.dec_depth)
        self.head = nn.Linear(d, cfg.num_classes)
        self.text_embed = TokenEmbedding(cfg.num_tokens, d)
        self.pos_queries = nn.Parameter(torch.zeros(1, cfg.num_steps, d))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights drawn from `generator` with the JAX package's
        schemes: truncated normal (std 0.02, cut at 2 std) for linear, conv,
        embedding and positional tables; xavier-uniform q/k/v projections;
        zero biases; unit LayerNorm scales."""

        def tn(t):
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                tn(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                tn(m.weight)
            elif isinstance(m, MultiheadAttentionParams):
                for w in m.in_proj_weight.view(3, -1, m.in_proj_weight.shape[1]):
                    nn.init.xavier_uniform_(w, generator=generator)
                nn.init.zeros_(m.in_proj_bias)
        tn(self.pos_queries)
        tn(self.encoder.pos_embed)

    # -- building blocks ---------------------------------------------------

    def encode(self, images):
        return self.encoder(images)

    def embed_context(self, tgt_ids, dtype):
        """Content-stream embeddings: sqrt(D)-scaled token embedding; tokens
        after BOS (position 0, the null context) get pos_queries[k-1] added."""
        emb = math.sqrt(self.cfg.embed_dim) * layers.embedding(
            tgt_ids, self.text_embed.embedding.weight, dtype)
        L = tgt_ids.shape[1]
        if L > 1:
            pos = self.pos_queries[:, : L - 1].to(dtype)
            emb = torch.cat([emb[:, :1], emb[:, 1:] + pos], dim=1)
        return emb

    def decode(self, tgt_ids, memory, *, query=None, query_bias=None, content_bias=None,
               padding_mask=None, dtype=torch.float32):
        content = self.embed_context(tgt_ids, dtype)
        if query is None:
            B, L = tgt_ids.shape
            query = self.pos_queries[:, :L].to(dtype).expand(B, L, self.cfg.embed_dim)
        return self.decoder(query, content, memory, query_bias=query_bias,
                            content_bias=content_bias, padding_mask=padding_mask)

    def decoder_head(self, x):
        return linear(x, self.head.weight, self.head.bias)

    # -- inference -----------------------------------------------------------

    def ar_decode(self, memory, dtype=torch.float32, early_exit=False):
        """Greedy left-to-right AR decode, the exact scan: each step queries
        one position with keys limited to the prefix. early_exit stops once
        every row has emitted an EOS; positions never decoded stay 0."""
        cfg = self.cfg
        B, n, dev = memory.shape[0], cfg.num_steps, memory.device
        pos_queries = self.pos_queries.to(dtype)
        causal = _causal_bias(n, dev)
        tgt_in = torch.full((B, n), cfg.pad_id, dtype=torch.long, device=dev)
        tgt_in[:, 0] = cfg.bos_id
        logits = torch.zeros(B, n, cfg.num_classes, device=dev)
        keys = torch.arange(n, device=dev)[None, :]
        for i in range(n):
            if early_exit and bool((tgt_in == cfg.eos_id).any(-1).all()):
                break
            q = pos_queries[:, i:i + 1].expand(B, 1, cfg.embed_dim)
            qb = torch.where(keys <= i, 0.0, NEG_INF)
            out = self.decode(tgt_in, memory, query=q, query_bias=qb,
                              content_bias=causal, dtype=dtype)
            logits_i = self.decoder_head(out)[:, 0]
            logits[:, i] = logits_i.float()
            if i + 1 < n:
                tgt_in[:, i + 1] = logits_i.argmax(-1)
        return logits

    def nar_decode(self, memory, dtype=torch.float32):
        """Single parallel decode with BOS-only context."""
        B = memory.shape[0]
        bos = torch.full((B, 1), self.cfg.bos_id, dtype=torch.long, device=memory.device)
        q = self.pos_queries.to(dtype).expand(B, -1, -1)
        return self.decoder_head(self.decode(bos, memory, query=q, dtype=dtype))

    def refine(self, memory, logits, dtype=torch.float32):
        """Iterative cloze refinement. Query i sees every context token except
        its own previous prediction (content position i+1); the reference
        aliases the query and content masks, so the content stream gets the
        cloze mask too (visible only when dec_depth > 1)."""
        cfg = self.cfg
        n, B, dev = cfg.num_steps, memory.shape[0], memory.device
        r = torch.arange(n, device=dev)
        cloze = torch.where(r[None, :] == r[:, None] + 1, NEG_INF, 0.0)
        bos = torch.full((B, 1), cfg.bos_id, dtype=torch.long, device=dev)
        q = self.pos_queries.to(dtype).expand(B, -1, -1)
        for _ in range(cfg.refine_iters):
            tgt_in = torch.cat([bos, logits[:, :-1].argmax(-1)], dim=1)
            # Mask context tokens at and beyond the first EOS.
            padding_mask = (tgt_in == cfg.eos_id).cumsum(-1) > 0
            out = self.decode(tgt_in, memory, query=q, query_bias=cloze,
                              content_bias=cloze, padding_mask=padding_mask, dtype=dtype)
            logits = self.decoder_head(out)
        return logits

    def forward(self, images, dtype=torch.float32, early_exit=False, use_fused_ar=True):
        """images (B, H, W, 3) NHWC -> logits (B, num_steps, num_classes) f32.

        encode -> AR (or NAR) decode -> refinement. On a CUDA tensor the AR
        decode of a one-layer decoder runs the fused kernel (ops/ar_kernel.py)
        on bf16 memory, as the JAX package does on its accelerator; the scan
        serves the CPU, dec_depth > 1, early_exit and use_fused_ar=False."""
        cfg = self.cfg
        memory = self.encode(images.to(dtype))
        if cfg.decode_ar:
            if (use_fused_ar and not early_exit and cfg.dec_depth == 1
                    and memory.device.type == 'cuda'):
                from parseq_tpu_torch.ops.ar_kernel import ar_decode_fused

                logits = ar_decode_fused(self, memory.to(torch.bfloat16))
            else:
                logits = self.ar_decode(memory, dtype, early_exit=early_exit)
        else:
            logits = self.nar_decode(memory, dtype)
        if cfg.refine_iters:
            logits = self.refine(memory, logits, dtype)
        return logits.float()
