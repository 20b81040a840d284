"""PARSeq (port of parseq_tpu/models/parseq.py): inference, and the training
half: permutation sampling, permutation masks, the multi-permutation loss
and the validation loss.

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

Training writes the K permutations out as a leading batch axis: the decoder
runs once on (K, B, L, D) streams, each permutation with its own masks and
its own dropout bits, while the memory (B, T, D) and its cross-attention
keys and values are shared by broadcasting.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from parseq_tpu_torch.models.vit import ViTConfig, VisionTransformer
from parseq_tpu_torch.ops import ar_kernel, layers
from parseq_tpu_torch.ops.layers import NEG_INF, dropout, layer_norm, linear
from parseq_tpu_torch.utils import trace


@dataclass(frozen=True)
class PARSeqConfig:
    """parseq_tpu's PARSeqConfig, less its `remat` (a JAX training-memory
    lever the port has no use for): the same defaults and properties. The
    training-only fields are carried so one config dict builds both."""

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

    def forward(self, q, k, v, *, num_heads, attn_bias=None, key_padding_mask=None,
                dropout_rate=0.0, rng=None):
        return layers.mha(q, k, v, self.in_proj_weight, self.in_proj_bias,
                          self.out_proj.weight, self.out_proj.bias, num_heads=num_heads,
                          attn_bias=attn_bias, key_padding_mask=key_padding_mask,
                          dropout_rate=dropout_rate, rng=rng)


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

    def forward_stream(self, tgt, tgt_norm, tgt_kv, memory, bias, key_padding_mask,
                       drop=0.0, rngs=(None,) * 6):
        """One stream of the two-stream layer. rngs: the 6 dropout sites'
        rngs (self-attn probs, self out, cross probs, cross out, MLP hidden,
        MLP out)."""
        sa = self.self_attn(tgt_norm, tgt_kv, tgt_kv, num_heads=self.nhead, attn_bias=bias,
                            key_padding_mask=key_padding_mask, dropout_rate=drop, rng=rngs[0])
        tgt = tgt + dropout(sa, drop, rngs[1])
        ca = self.cross_attn(_ln(tgt, self.norm1), memory, memory, num_heads=self.nhead,
                             dropout_rate=drop, rng=rngs[2])
        tgt = tgt + dropout(ca, drop, rngs[3])
        h = layers.gelu(linear(_ln(tgt, self.norm2), self.linear1.weight, self.linear1.bias))
        h = linear(dropout(h, drop, rngs[4]), self.linear2.weight, self.linear2.bias)
        return tgt + dropout(h, drop, rngs[5])


class Decoder(nn.Module):
    def __init__(self, d, nhead, dff, depth):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d, nhead, dff) for _ in range(depth))
        self.norm = nn.LayerNorm(d)

    def forward(self, query, content, memory, *, query_bias=None, content_bias=None,
                padding_mask=None, drop=0.0, rngs=None):
        """Content updated by all but the last layer; final LN on the query stream.

        rngs: None, a torch.Generator every site draws from, or the list of
        per-site bits in `dropout_site_shapes` order after the two embedding
        sites (6 for each layer's query stream, then 6 for its content stream
        unless it is the last layer)."""
        bulk = isinstance(rngs, (list, tuple))
        cur = list(rngs) if bulk else []
        for i, lp in enumerate(self.layers):
            last = i == len(self.layers) - 1
            r_q = r_c = (rngs,) * 6
            if bulk:
                r_q, cur = cur[:6], cur[6:]
                if not last:
                    r_c, cur = cur[:6], cur[6:]
            query_norm = _ln(query, lp.norm_q)
            content_norm = _ln(content, lp.norm_c)
            query = lp.forward_stream(query, query_norm, content_norm, memory,
                                      query_bias, padding_mask, drop, r_q)
            if not last:
                content = lp.forward_stream(content, content_norm, content_norm, memory,
                                            content_bias, padding_mask, drop, r_c)
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
        embedding and positional tables; xavier-uniform decoder attention
        projections (q, k, v and out); zero biases; unit LayerNorm scales."""

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
        for m in self.modules():  # attention projections, out_proj included
            if isinstance(m, MultiheadAttentionParams):
                for w in (*m.in_proj_weight.view(3, -1, m.in_proj_weight.shape[1]),
                          m.out_proj.weight):
                    nn.init.xavier_uniform_(w, generator=generator)
                nn.init.zeros_(m.in_proj_bias)
        tn(self.pos_queries)
        tn(self.encoder.pos_embed)

    # -- building blocks ---------------------------------------------------

    def encode(self, images):
        return self.encoder(images)

    def embed_context(self, tgt_ids, dtype, *, drop=0.0, rng=None):
        """Content-stream embeddings: sqrt(D)-scaled token embedding; tokens
        after BOS (position 0, the null context) get pos_queries[k-1] added."""
        emb = math.sqrt(self.cfg.embed_dim) * layers.embedding(
            tgt_ids, self.text_embed.embedding.weight, dtype)
        L = tgt_ids.shape[1]
        if L > 1:
            pos = self.pos_queries[:, : L - 1].to(dtype)
            emb = torch.cat([emb[:, :1], emb[:, 1:] + pos], dim=1)
        return dropout(emb, drop, rng)

    def decode(self, tgt_ids, memory, *, query=None, query_bias=None, content_bias=None,
               padding_mask=None, dtype=torch.float32, drop=0.0, rng=None):
        """rng: None, a torch.Generator (every site draws its own bits from
        it), or the list of per-site bits in `dropout_site_shapes` order."""
        r0, r1, rest = (rng[0], rng[1], rng[2:]) if isinstance(rng, (list, tuple)) else (rng,) * 3
        content = self.embed_context(tgt_ids, dtype, drop=drop, rng=r0)
        if query is None:
            B, L = tgt_ids.shape
            query = self.pos_queries[:, :L].to(dtype).expand(B, L, self.cfg.embed_dim)
        query = dropout(query, drop, r1)
        return self.decoder(query, content, memory, query_bias=query_bias,
                            content_bias=content_bias, padding_mask=padding_mask,
                            drop=drop, rngs=rest)

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

    def forward(self, images, dtype=torch.float32):
        """images (B, H, W, 3) NHWC -> logits (B, num_steps, num_classes) f32.

        encode -> AR (or NAR) decode -> refinement. Where ar_kernel.takes
        holds (a one-layer decoder on a CUDA tensor, outside kernels.plain())
        the AR decode runs kernel B1 (ops/ar_kernel.py) on bf16 memory, as
        the JAX package does on its accelerator; the scan serves the rest."""
        cfg = self.cfg
        memory = self.encode(images.to(dtype))
        if ar_kernel.takes(cfg, memory.device):
            logits = ar_kernel.ar_decode_fused(self, memory.to(torch.bfloat16))
        elif cfg.decode_ar:
            logits = self.ar_decode(memory, dtype)
        else:
            logits = self.nar_decode(memory, dtype)
        if cfg.refine_iters:
            with trace.span('parseq.refine'):
                logits = self.refine(memory, logits, dtype)
        return logits.float()

    # -- training ------------------------------------------------------------

    def multi_perm_loss(self, images, tgt_ids, perms, *, dtype=torch.float32, rng=None):
        """Training loss over K permutations (JAX `multi_perm_loss`).

        images (B, H, W, 3); tgt_ids (B, max_label_length + 2) from
        Tokenizer.encode; perms (K, max_label_length + 2) from gen_tgt_perms.
        rng: None (no dropout) or a torch.Generator on the images' device,
        from which every dropout site draws its bits in one call: uint8 bits
        by default (the rate quantized to round(p*256)/256), 16-bit bits when
        the rate is below 1/512 or bulk_bits_uint8 is off; shape (K, *site) so
        each permutation has its own masks, or (*site) shared by all K with
        shared_perm_dropout. Per-element CE with PAD ignored; EOS counts only
        for the first two permutations. Returns (loss, loss_numel)."""
        cfg = self.cfg
        memory = self.encode(images.to(dtype))
        tgt_ids = tgt_ids.long()
        tgt_in, tgt_out = tgt_ids[:, :-1], tgt_ids[:, 1:]
        padding_mask = (tgt_in == cfg.pad_id) | (tgt_in == cfg.eos_id)
        content_bias, query_bias = perm_attn_masks(torch.as_tensor(perms, device=memory.device))
        K = perms.shape[0]
        bits = None
        if rng is not None and cfg.dropout > 0.0:
            B, L = tgt_in.shape
            u8 = cfg.bulk_dropout_bits and cfg.bulk_bits_uint8 and round(cfg.dropout * 256.0) >= 1
            high, bits_dtype = (256, torch.uint8) if u8 else (65536, torch.int32)
            lead = () if cfg.shared_perm_dropout else (K,)
            bits = [torch.randint(0, high, (*lead, *s), generator=rng, device=memory.device,
                                  dtype=bits_dtype)
                    for s in dropout_site_shapes(cfg, B, L, memory.shape[1])]
        out = self.decode(tgt_in, memory, query_bias=query_bias[:, None, None],
                          content_bias=content_bias[:, None, None], padding_mask=padding_mask,
                          dtype=dtype, drop=cfg.dropout if bits is not None else 0.0, rng=bits)
        logits = self.decoder_head(out)  # (K, B, L, C)

        base_valid = tgt_out != cfg.pad_id
        eos_pos = tgt_out == cfg.eos_id
        k_idx = torch.arange(K, device=memory.device)[:, None, None]
        valid = base_valid[None] & ((k_idx < 2) | ~eos_pos[None])  # (K, B, L)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tgt_safe = tgt_out.clamp(0, cfg.num_classes - 1)
        nll = -torch.gather(logp, -1, tgt_safe[None, ..., None].expand(K, -1, -1, 1))[..., 0]
        loss_numel = valid.sum()
        return (nll * valid).sum() / loss_numel.clamp(min=1), loss_numel

    def logits_loss(self, images, tgt_ids, dtype=torch.float32):
        """Validation loss (JAX `logits_loss`): full inference forward, CE
        against [chars..., EOS] over num_steps positions with PAD ignored.
        Returns (logits, loss, loss_numel)."""
        cfg = self.cfg
        logits = self.forward(images, dtype=dtype)
        targets = tgt_ids.long()[:, 1:][:, : cfg.num_steps]
        valid = targets != cfg.pad_id
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets.clamp(0, cfg.num_classes - 1)[..., None])[..., 0]
        numel = valid.sum()
        return logits, (nll * valid).sum() / numel.clamp(min=1), numel


def dropout_site_shapes(cfg: PARSeqConfig, B, L, T):
    """Ordered shapes of every dropout site one decode() call consumes in
    bulk-bits mode: [context embed, query] then per layer the query stream's
    6 sites (self-attn probs, self out, cross probs, cross out, MLP hidden,
    MLP out), plus the content stream's 6 for every non-last layer."""
    h, D = cfg.dec_num_heads, cfg.embed_dim
    dff = int(D * cfg.dec_mlp_ratio)

    def stream():
        return [(B, h, L, L), (B, L, D), (B, h, L, T), (B, L, D), (B, L, dff), (B, L, D)]

    shapes = [(B, L, D), (B, L, D)]
    for i in range(cfg.dec_depth):
        shapes += stream()
        if i != cfg.dec_depth - 1:
            shapes += stream()
    return shapes


def gen_tgt_perms(rng: np.random.Generator, cfg: PARSeqConfig, max_num_chars=None):
    """Host-side (numpy) permutation sampling, reference semantics (JAX
    `gen_tgt_perms`, the same draws from the same numpy Generator). Returns
    int32 (K, max_num_chars + 2) including the BOS slot (always 0) and the
    EOS slot (always last)."""
    if max_num_chars is None:
        max_num_chars = cfg.max_label_length
    if max_num_chars == 1:
        return np.arange(3, dtype=np.int32)[None]

    max_gen_perms = cfg.perm_num // 2 if cfg.perm_mirrored else cfg.perm_num
    perms = [np.arange(max_num_chars, dtype=np.int64)] if cfg.perm_forward else []
    max_perms = math.factorial(max_num_chars)
    if cfg.perm_mirrored:
        max_perms //= 2
    num_gen_perms = min(max_gen_perms, max_perms)
    if max_num_chars < 5:
        from itertools import permutations as iperms

        if max_num_chars == 4 and cfg.perm_mirrored:
            selector = [0, 3, 4, 6, 9, 10, 12, 16, 17, 18, 19, 21]
        else:
            selector = list(range(max_perms))
        perm_pool = np.asarray(list(iperms(range(max_num_chars))), dtype=np.int64)[selector]
        if cfg.perm_forward:
            perm_pool = perm_pool[1:]
        perms = np.stack(perms) if perms else np.zeros((0, max_num_chars), np.int64)
        if len(perm_pool):
            i = rng.choice(len(perm_pool), size=num_gen_perms - len(perms), replace=False)
            perms = np.concatenate([perms, perm_pool[i]])
    else:
        perms.extend(rng.permutation(max_num_chars) for _ in range(num_gen_perms - len(perms)))
        perms = np.stack(perms)
    if cfg.perm_mirrored:
        comp = perms[:, ::-1]
        # Interleave so that each pair (perm, reversed perm) is adjacent.
        perms = np.stack([perms, comp], axis=1).reshape(-1, max_num_chars)
    bos_idx = np.zeros((len(perms), 1), np.int64)
    eos_idx = np.full((len(perms), 1), max_num_chars + 1, np.int64)
    perms = np.concatenate([bos_idx, perms + 1, eos_idx], axis=1)
    if len(perms) > 1:
        # Second perm: strict reverse ramp -> reverse context for chars and
        # null context for EOS (needed to learn NAR EOS prediction).
        perms[1, 1:] = max_num_chars + 1 - np.arange(max_num_chars + 1)
    return perms.astype(np.int32)


def perm_attn_masks(perm):
    """JAX `perm_attn_masks` over any leading axes. perm: int (..., L), a
    permutation of [0, L) with perm[..., 0] == 0 (BOS). Returns
    (content_bias, query_bias), f32 (..., L-1, L-1): content position k may be
    attended by query position q iff k comes no later than q in the
    permutation order (and q != k for the query stream)."""
    L = perm.shape[-1]
    rank = torch.argsort(perm, dim=-1)
    masked = rank[..., None, :] > rank[..., :, None]  # key strictly later than query
    content_bias = torch.where(masked[..., :-1, :-1], NEG_INF, 0.0)
    masked_self = masked | torch.eye(L, dtype=torch.bool, device=perm.device)
    query_bias = torch.where(masked_self[..., 1:, :-1], NEG_INF, 0.0)
    return content_bias.float(), query_bias.float()
