"""PARSeq (Bautista & Atienza, ECCV 2022; strhub/models/parseq): a ViT
encoder and a two-stream pre-LN decoder (the query stream attends over the
content stream; the content stream is updated by every layer but the last).

Reading: the autoregressive pass teacher-forced on given picks (one parallel
pass under the causal mask gives what the 26 sequential steps give), then
one cloze refinement on those picks. Training: the multi-permutation loss
with dropout bits given in the order of `dropout_site_shapes`.

`cfg` is the configuration's model dict; `ids` the tokenizer's `Ids`.
"""

from __future__ import annotations

import math
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import Ops, attend, gelu, layer_norm, merge_heads, split_heads
from .vit import encode
from .vit import init_kind as vit_init_kind

# read() is teacher-forced on the program's greedy AR picks
AR = True


def mha(ops, p, pre, q, kv, heads, mask=None, drop=None):
    """nn.MultiheadAttention: packed in_proj_weight / in_proj_bias, out_proj.
    mask: bool, True where a key is hidden, broadcast to (..., h, Lq, Lk)."""
    wq, wk, wv = p[pre + 'in_proj_weight'].chunk(3)
    bq, bk, bv = p[pre + 'in_proj_bias'].chunk(3)
    o = attend(ops, split_heads(ops.linear(q, wq, bq), heads),
               split_heads(ops.linear(kv, wk, bk), heads),
               split_heads(ops.linear(kv, wv, bv), heads), mask, drop)
    return ops.linear(merge_heads(o), p[pre + 'out_proj.weight'], p[pre + 'out_proj.bias'])


def _stream(ops, p, pre, tgt, tgt_norm, tgt_kv, memory, mask, heads, drops):
    """One stream of a decoder layer; drops: the 6 sites' functions (self
    probabilities, self out, cross probabilities, cross out, MLP hidden, MLP
    out)."""
    tgt = tgt + drops[1](mha(ops, p, pre + 'self_attn.', tgt_norm, tgt_kv, heads, mask, drops[0]))
    h = layer_norm(tgt, p[pre + 'norm1.weight'], p[pre + 'norm1.bias'])
    tgt = tgt + drops[3](mha(ops, p, pre + 'cross_attn.', h, memory, heads, None, drops[2]))
    h = layer_norm(tgt, p[pre + 'norm2.weight'], p[pre + 'norm2.bias'])
    h = drops[4](gelu(ops.linear(h, p[pre + 'linear1.weight'], p[pre + 'linear1.bias'])))
    return tgt + drops[5](ops.linear(h, p[pre + 'linear2.weight'], p[pre + 'linear2.bias']))


def _identity(x):
    return x


def decode(ops, p, cfg, tgt_in, memory, query_mask, content_mask, drops=None):
    """tgt_in (B, L) ids, memory (B, T, D). Masks: bool, True where a key is
    hidden, broadcast to (B, h, L, L). drops: None, or the list of dropout
    functions of every site (2 embedding sites, then 6 a stream)."""
    D, heads, depth = cfg['embed_dim'], cfg['dec_num_heads'], cfg['dec_depth']
    drops = list(drops) if drops is not None else [_identity] * (2 + 12 * depth)
    L = tgt_in.shape[1]
    content = math.sqrt(D) * p['text_embed.embedding.weight'][tgt_in]
    content = torch.cat([content[:, :1], content[:, 1:] + p['pos_queries'][:, :L - 1]], dim=1)
    content = drops[0](content)
    query = drops[1](p['pos_queries'][:, :L].expand(tgt_in.shape[0], L, D))
    cur = drops[2:]
    for i in range(depth):
        pre = f'decoder.layers.{i}.'
        last = i == depth - 1
        qn = layer_norm(query, p[pre + 'norm_q.weight'], p[pre + 'norm_q.bias'])
        cn = layer_norm(content, p[pre + 'norm_c.weight'], p[pre + 'norm_c.bias'])
        query = _stream(ops, p, pre, query, qn, cn, memory, query_mask, heads, cur[:6])
        cur = cur[6:]
        if not last:
            content = _stream(ops, p, pre, content, cn, cn, memory, content_mask, heads, cur[:6])
            cur = cur[6:]
    out = layer_norm(query, p['decoder.norm.weight'], p['decoder.norm.bias'])
    return ops.linear(out, p['head.weight'], p['head.bias'])


def encode_images(ops, p, cfg, images):
    return encode(ops, p, 'encoder.', images, patch=tuple(cfg['patch_size']),
                  depth=cfg['enc_depth'], heads=cfg['enc_num_heads'])


def init_kind(name):
    """The released init: xavier-uniform for every q, k, v and output
    projection of the decoder's attention, timm's ViT init for the rest."""
    if ('self_attn.' in name or 'cross_attn.' in name) and name.endswith('weight'):
        return 'xavier'
    return vit_init_kind(name)


def read(p, cfg, ids, images, picks, ops=None):
    """images (B, H, W, 3) float32 in [-1, 1]; picks (B, n) the greedy AR
    picks to teacher-force on (n = max_label_length + 1). Returns the AR
    logits and the refined logits, each (B, n, num_classes)."""
    ops = ops or Ops()
    memory = encode_images(ops, p, cfg, images)
    B, n = picks.shape
    dev = images.device
    tgt_in = torch.cat([torch.full((B, 1), ids.bos, dtype=torch.long, device=dev),
                        picks[:, :-1].long()], dim=1)
    r = torch.arange(n, device=dev)
    causal = r[None, :] > r[:, None]  # key later than query: hidden
    ar = decode(ops, p, cfg, tgt_in, memory, causal, causal)
    # cloze: query i hides its own previous pick (content i + 1); context at
    # and after the first EOS hidden
    cloze = r[None, :] == r[:, None] + 1
    pad = ((tgt_in == ids.eos).cumsum(-1) > 0)[:, None, None, :]
    refined = decode(ops, p, cfg, tgt_in, memory, cloze | pad, cloze | pad)
    return ar, refined


# --- training -------------------------------------------------------------------


def gen_tgt_perms(rng: np.random.Generator, perm_num, max_num_chars, forward=True, mirrored=True):
    """PARSeq's permutation sampling with the draws of a numpy Generator, as
    the configuration's training recipe makes them: the canonical order
    first, then random permutations; each followed by its mirror; the second
    a strict reverse order. (K, max_num_chars + 2) int64 with BOS first and
    EOS last."""
    if max_num_chars == 1:
        return np.arange(3)[None]
    max_gen = perm_num // 2 if mirrored else perm_num
    perms = [np.arange(max_num_chars)] if forward else []
    max_perms = math.factorial(max_num_chars) // (2 if mirrored else 1)
    n_gen = min(max_gen, max_perms)
    if max_num_chars < 5:
        if max_num_chars == 4 and mirrored:
            selector = [0, 3, 4, 6, 9, 10, 12, 16, 17, 18, 19, 21]
        else:
            selector = list(range(max_perms))
        pool = np.asarray(list(permutations(range(max_num_chars))))[selector]
        if forward:
            pool = pool[1:]
        perms = np.stack(perms) if perms else np.zeros((0, max_num_chars), np.int64)
        if len(pool):
            i = rng.choice(len(pool), size=n_gen - len(perms), replace=False)
            perms = np.concatenate([perms, pool[i]])
    else:
        perms.extend(rng.permutation(max_num_chars) for _ in range(n_gen - len(perms)))
        perms = np.stack(perms)
    if mirrored:
        perms = np.stack([perms, perms[:, ::-1]], axis=1).reshape(-1, max_num_chars)
    K = len(perms)
    perms = np.concatenate([np.zeros((K, 1), np.int64), perms + 1,
                            np.full((K, 1), max_num_chars + 1, np.int64)], axis=1)
    if K > 1:
        perms[1, 1:] = max_num_chars + 1 - np.arange(max_num_chars + 1)
    return perms


def perm_masks(perm):
    """The released generate_attn_masks: query perm[i] may not see the keys
    that come after it in the permutation; the query stream also not itself.
    Returns (content_mask, query_mask), bool, True where hidden."""
    sz = len(perm)
    mask = torch.zeros(sz, sz, dtype=torch.bool)
    for i in range(sz):
        mask[perm[i], perm[i + 1:]] = True
    content = mask[:-1, :-1].clone()
    mask |= torch.eye(sz, dtype=torch.bool)
    return content, mask[1:, :-1]


def dropout_site_shapes(cfg, B, L, T):
    """Shapes of every dropout site of one decode, in the order the bits are
    drawn: context embedding, query, then per stream: self probabilities,
    self out, cross probabilities, cross out, MLP hidden, MLP out."""
    h, D = cfg['dec_num_heads'], cfg['embed_dim']
    F_ = int(D * cfg['dec_mlp_ratio'])
    stream = [(B, h, L, L), (B, L, D), (B, h, L, T), (B, L, D), (B, L, F_), (B, L, D)]
    shapes = [(B, L, D), (B, L, D)]
    for i in range(cfg['dec_depth']):
        shapes += stream * (1 if i == cfg['dec_depth'] - 1 else 2)
    return shapes


def draw_dropout_bits(cfg, K, B, L, T, generator):
    """Uint8 bits of every site, each (K, *site): one draw a site from the
    step's generator, in `dropout_site_shapes` order."""
    return [torch.randint(0, 256, (K, *s), generator=generator, device=generator.device,
                          dtype=torch.uint8)
            for s in dropout_site_shapes(cfg, B, L, T)]


def bit_dropout(bits, rate):
    """Inverted dropout on uint8 bits: drop where bits < round(256 rate), keep
    the rest scaled by the kept share of the 256 values."""
    thr = int(round(rate * 256.0))
    keep = 1.0 - thr / 256.0

    def drop(x):
        return torch.where(bits >= thr, x / keep, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    return drop


def train_extras(cfg, rng: np.random.Generator, batch, generator):
    """What a step draws besides its images and labels: the permutations
    (from rng, as the program's preparation draws them) and the dropout bits
    of every site (from the step's generator)."""
    (H, W), (ph, pw) = cfg['img_size'], cfg['patch_size']
    perms = gen_tgt_perms(rng, cfg['perm_num'], cfg['max_label_length'], cfg['perm_forward'],
                          cfg['perm_mirrored'])
    bits = draw_dropout_bits(cfg, len(perms), batch, cfg['max_label_length'] + 1,
                             (H // ph) * (W // pw), generator)
    return perms, bits


def train_loss(p, cfg, ids, images, tgt, extras, ops=None):
    """The training loss of a step on `train_extras`' draws."""
    perms, bits = extras
    return multi_perm_loss(p, cfg, ids, images, tgt, perms, bits, ops)


def multi_perm_loss(p, cfg, ids, images, tgt, perms, bits=None, ops=None):
    """images (B, H, W, 3) float32 in [-1, 1]; tgt (B, L + 1) from
    `Ids.encode`; perms (K, L + 1); bits: None or the per-site (K, *site)
    uint8 bits. The token-mean cross entropy over the K permutations, EOS
    counted only in the first two (strhub/models/parseq/system.py)."""
    ops = ops or Ops()
    memory = encode_images(ops, p, cfg, images)
    tgt = tgt.long()
    tgt_in, tgt_out = tgt[:, :-1], tgt[:, 1:]
    pad = ((tgt_in == ids.pad) | (tgt_in == ids.eos))[:, None, None, :]
    total = torch.zeros((), device=images.device)
    count = 0
    for k, perm in enumerate(perms.tolist()):
        content, query = (m.to(images.device) for m in perm_masks(perm))
        drops = None
        if bits is not None:
            drops = [bit_dropout(b[k], cfg['dropout']) for b in bits]
        logits = decode(ops, p, cfg, tgt_in, memory, query | pad, content | pad, drops)
        if k == 2:  # EOS counts only for the canonical and the reverse order
            tgt_out = torch.where(tgt_out == ids.eos, ids.pad, tgt_out)
        n = int((tgt_out != ids.pad).sum())
        total = total + F.cross_entropy(logits.flatten(0, 1), tgt_out.flatten(),
                                        ignore_index=ids.pad, reduction='sum')
        count += n
    return total / count


def param_shapes(cfg, ids):
    """Parameter names (the released state_dict's) and shapes."""
    from .vit import param_shapes as vit_shapes

    D, num_tokens = cfg['embed_dim'], ids.num_tokens
    Fd = int(D * cfg['dec_mlp_ratio'])
    out = vit_shapes('encoder.', img=cfg['img_size'], patch=cfg['patch_size'], dim=D,
                     depth=cfg['enc_depth'], mlp_ratio=cfg['enc_mlp_ratio'])
    for i in range(cfg['dec_depth']):
        b = f'decoder.layers.{i}.'
        for a in ('self_attn.', 'cross_attn.'):
            out.update({b + a + 'in_proj_weight': (3 * D, D), b + a + 'in_proj_bias': (3 * D,),
                        b + a + 'out_proj.weight': (D, D), b + a + 'out_proj.bias': (D,)})
        out.update({b + 'linear1.weight': (Fd, D), b + 'linear1.bias': (Fd,),
                    b + 'linear2.weight': (D, Fd), b + 'linear2.bias': (D,)})
        for nrm in ('norm1', 'norm2', 'norm_q', 'norm_c'):
            out.update({f'{b}{nrm}.weight': (D,), f'{b}{nrm}.bias': (D,)})
    out.update({'decoder.norm.weight': (D,), 'decoder.norm.bias': (D,),
                'head.weight': (num_tokens - 2, D), 'head.bias': (num_tokens - 2,),
                'text_embed.embedding.weight': (num_tokens, D),
                'pos_queries': (1, cfg['max_label_length'] + 1, D)})
    return out
