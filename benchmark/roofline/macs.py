"""Multiply-accumulates of the pieces the FLOP formulas (roofline/flops/)
are made of, from the configuration's sizes: the products of the plain
reference, elementwise work left out."""

from __future__ import annotations


def vit(cfg, L, depth):
    """`depth` pre-LN blocks over L tokens: q|k|v, scores, PV, out, MLP."""
    D = cfg['embed_dim']
    F = int(D * cfg.get('enc_mlp_ratio', cfg.get('mlp_ratio', 4)))
    block = L * D * 3 * D + 2 * L * L * D + L * D * D + 2 * L * D * F
    return depth * block


def patches(cfg):
    """(patches an image, inputs a patch)."""
    (H, W), (ph, pw) = cfg['img_size'], cfg['patch_size']
    return (H // ph) * (W // pw), 3 * ph * pw


def decode(cfg, n, T, C, memory_kv=True):
    """One decode of n positions over memory (T, D) by a one-layer two-stream
    decoder: the query stream's products and the head (the content stream of
    the last layer is never computed)."""
    D = cfg['embed_dim']
    F = int(D * cfg['dec_mlp_ratio'])
    per = (n * D * D + n * D * 2 * D + 2 * n * n * D + n * D * D  # self: q, k|v, scores, PV, out
           + n * D * D + 2 * n * T * D + n * D * D  # cross: q, scores, PV, out
           + 2 * n * D * F + n * D * C)  # MLP, head
    return per + (T * D * 2 * D if memory_kv else 0)  # the memory's keys and values
