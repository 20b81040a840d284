"""ABINet (port of parseq_tpu/models/abinet.py).

Vision model (resnet45 -> post-LN transformer layers -> position attention
or the `-sv` Attention variant) -> BCN cloze language model -> gated
alignment, iterated `iter_size` times. The vision transformer runs at
L = (H/4)*(W/4) = 256 for 32x128 images, so its self-attention goes through
kernel B2 (ops/attention.py:encoder_self_attention).

Parameters and buffers carry the reference state_dict names (the keys
parseq_tpu/utils/torch_convert.py:convert_abinet reads): vision.backbone.
resnet.*, vision.backbone.pos_encoder.pe, vision.backbone.transformer.
layers.{i}.*, vision.attention.{k_encoder,k_decoder,pos_encoder,project}.*
(or f0_embedding/w0/wv/we), vision.cls, language.{proj,token_encoder,
pos_encoder,model.layers.{i},cls}.*, alignment.{w_att,cls}.*. Convolutions
and batch norms are nn.Conv2d / nn.BatchNorm2d (NCHW inside); the
computation goes through the port's ops, never through their forward.

Training: `module.train()` switches the batch norms to batch statistics
(ops/cnn.py:batchnorm), and a torch.Generator passed as `rng` turns on
dropout at `cfg.dropout` at the JAX layers' sites: the encoder layer's
attention probabilities, its two residual branches and its MLP hidden; the
decoder layer's attention probabilities, residual branches and MLP hidden;
the language model's token embedding. Encoder attention with dropout is
plain `layers.mha` (no kernel drops probabilities).

Numerics follow the JAX package: batch norm in f32; PositionAttention's
scores are a product in the compute dtype divided by sqrt(E) in that dtype,
then an f32 softmax; nearest upsampling uses half-pixel centres
(jax.image.resize 'nearest' == F.interpolate 'nearest-exact').

Batch norms: each convolution's batch norm, with the shortcut and the ReLU
after it, is one cnn.conv_bn, which runs as one launch of csrc/bn_act.cu on
the card in eval mode with autograd off (ops/cnn.py:takes_kernel).

Spans (utils/trace.py, each with device events and the attribute `rows`):
abinet.vision around the vision model, holding abinet.backbone (resnet45;
the attribute `bn_kernel`: the launches of csrc/bn_act.cu in it, counted),
abinet.transformer (its layers, kernel B2 inside) and
abinet.position_attention (or abinet.attention, the `-sv` variant); then
one abinet.iteration a language pass and its alignment, with the attribute
`iteration` (0 to iter_size - 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch.models.parseq import MultiheadAttentionParams
from parseq_tpu_torch.ops import cnn, layers
from parseq_tpu_torch.ops.attention import encoder_self_attention
from parseq_tpu_torch.ops.layers import NEG_INF, dropout, layer_norm, linear
from parseq_tpu_torch.utils import trace


@dataclass(frozen=True)
class ABINetConfig:
    """Same fields, defaults and properties as parseq_tpu's ABINetConfig.
    The training-only fields are carried so one config dict builds both."""

    num_tokens: int = 97  # len(charset) + 3; num_classes = num_tokens - 2
    max_label_length: int = 25
    img_size: tuple[int, int] = (32, 128)
    d_model: int = 512
    nhead: int = 8
    d_inner: int = 2048
    dropout: float = 0.1
    activation: str = 'relu'
    v_backbone: str = 'transformer'  # or 'resnet45'
    v_num_layers: int = 3
    v_attention: str = 'position'  # or 'attention'
    v_attention_mode: str = 'nearest'
    l_num_layers: int = 4
    l_use_self_attn: bool = False
    l_detach: bool = True
    iter_size: int = 3
    v_loss_weight: float = 1.0
    l_loss_weight: float = 1.0
    a_loss_weight: float = 1.0

    @property
    def max_length(self) -> int:
        return self.max_label_length + 1  # + stop token

    @property
    def num_classes(self) -> int:
        return self.num_tokens - 2

    @property
    def null_label(self) -> int:
        return 0  # EOS

    @property
    def pad_id(self) -> int:
        return self.num_tokens - 1

    @property
    def feat_hw(self) -> tuple[int, int]:
        return (self.img_size[0] // 4, self.img_size[1] // 4)  # resnet45 /4


def sinusoid_pe(length, d_model):
    """Sinusoidal positional table (length, d_model) float32, computed in
    float64 as the reference's PositionalEncoding does."""
    pos = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


def get_length(logits, null_label=0):
    """First position predicting the null (EOS) label, + 1; T if none."""
    T = logits.shape[1]
    is_null = logits.argmax(-1) == null_label
    first = is_null.int().argmax(-1) + 1  # argmax returns the first maximum
    return torch.where(is_null.any(-1), first, torch.full_like(first, T))


def _act(cfg):
    return F.relu if cfg.activation == 'relu' else layers.gelu


class _PositionalEncoding(nn.Module):
    """Holds the reference's `pe` buffer, (max_len, 1, d_model)."""

    def __init__(self, d_model, max_len):
        super().__init__()
        self.register_buffer('pe', sinusoid_pe(max_len, d_model)[:, None])

    def table(self, length, dtype):
        return self.pe[:length, 0].to(dtype)


# ---------------------------------------------------------------------------
# resnet45
# ---------------------------------------------------------------------------

_R45_PLANES = [32, 64, 128, 256, 512]
_R45_BLOCKS = [3, 4, 6, 6, 3]
_R45_STRIDES = [2, 1, 2, 1, 1]


class _R45Block(nn.Module):
    """1x1 conv1, 3x3 conv2 (with the stride), optional 1x1 downsample."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1, 1, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        """relu(bn1(conv1)), then relu(bn2(conv2) + shortcut): each a
        cnn.conv_bn, one launch after the convolutions on the card."""
        out = cnn.conv_bn(x, self.conv1, self.bn1, relu=True)
        if self.downsample is None:
            return cnn.conv_bn(out, self.conv2, self.bn2, relu=True, residual=x)
        return cnn.conv_bn(out, self.conv2, self.bn2, relu=True,
                           residual=cnn.conv2d(x, self.downsample[0]),
                           residual_bn=self.downsample[1])


class Resnet45(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        cin = 32
        for li, (planes, blocks, stride) in enumerate(zip(_R45_PLANES, _R45_BLOCKS, _R45_STRIDES)):
            setattr(self, f'layer{li + 1}', nn.Sequential(*(
                _R45Block(cin if bi == 0 else planes, planes, stride if bi == 0 else 1)
                for bi in range(blocks))))
            cin = planes

    def forward(self, x):
        """x (B, 3, H, W) -> (B, 512, H/4, W/4)."""
        x = cnn.conv_bn(x, self.conv1, self.bn1, relu=True)
        for li in range(len(_R45_BLOCKS)):
            for block in getattr(self, f'layer{li + 1}'):
                x = block(x)
        return x


# ---------------------------------------------------------------------------
# Post-LN transformer layers (torch defaults; backbone and BCN decoder)
# ---------------------------------------------------------------------------


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: ABINetConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_attn = MultiheadAttentionParams(d)
        self.linear1 = nn.Linear(d, cfg.d_inner)
        self.linear2 = nn.Linear(cfg.d_inner, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, rng=None):
        sa, drop = self.self_attn, self.cfg.dropout
        a = encoder_self_attention(x, sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight,
                                   sa.out_proj.bias, self.cfg.nhead, dropout_rate=drop, rng=rng)
        x = layer_norm(x + dropout(a, drop, rng), self.norm1.weight, self.norm1.bias)
        h = _act(self.cfg)(linear(x, self.linear1.weight, self.linear1.bias))
        h = linear(dropout(h, drop, rng), self.linear2.weight, self.linear2.bias)
        return layer_norm(x + dropout(h, drop, rng), self.norm2.weight, self.norm2.bias)


class _DecoderLayer(nn.Module):
    """The reference's vendored TransformerDecoderLayer: post-LN, optional
    self-attention, cross-attention to the token embeddings."""

    def __init__(self, cfg: ABINetConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        if cfg.l_use_self_attn:
            self.self_attn = MultiheadAttentionParams(d)
            self.norm1 = nn.LayerNorm(d)
        self.multihead_attn = MultiheadAttentionParams(d)
        self.linear1 = nn.Linear(d, cfg.d_inner)
        self.linear2 = nn.Linear(cfg.d_inner, d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, tgt, memory, memory_bias, key_padding_mask, rng=None):
        h, drop = self.cfg.nhead, self.cfg.dropout
        if self.cfg.l_use_self_attn:
            a = self.self_attn(tgt, tgt, tgt, num_heads=h, key_padding_mask=key_padding_mask,
                               dropout_rate=drop, rng=rng)
            tgt = layer_norm(tgt + dropout(a, drop, rng), self.norm1.weight, self.norm1.bias)
        a = self.multihead_attn(tgt, memory, memory, num_heads=h, attn_bias=memory_bias,
                                key_padding_mask=key_padding_mask, dropout_rate=drop, rng=rng)
        tgt = layer_norm(tgt + dropout(a, drop, rng), self.norm2.weight, self.norm2.bias)
        x = _act(self.cfg)(linear(tgt, self.linear1.weight, self.linear1.bias))
        x = linear(dropout(x, drop, rng), self.linear2.weight, self.linear2.bias)
        return layer_norm(tgt + dropout(x, drop, rng), self.norm3.weight, self.norm3.bias)


class _Layers(nn.Module):
    def __init__(self, layer_list):
        super().__init__()
        self.layers = nn.ModuleList(layer_list)


# ---------------------------------------------------------------------------
# Vision attention heads
# ---------------------------------------------------------------------------


class PositionAttention(nn.Module):
    """U-Net key path over the feature map, sinusoidal queries."""

    def __init__(self, cfg: ABINetConfig, num_channels=64):
        super().__init__()
        E = cfg.d_model
        self.max_length = cfg.max_length
        strides = [(1, 2), (2, 2), (2, 2), (2, 2)]

        def cbr(cin, cout, stride):
            return [nn.Conv2d(cin, cout, 3, stride, 1), nn.BatchNorm2d(cout), nn.ReLU()]

        self.k_encoder = nn.Sequential(*(
            nn.Sequential(*cbr(E if i == 0 else num_channels, num_channels, strides[i]))
            for i in range(4)))
        # Index 0 of each decoder stage is the reference's nn.Upsample; the
        # forward resizes with half-pixel centres instead of calling it.
        self.k_decoder = nn.Sequential(*(
            nn.Sequential(nn.Identity(), *cbr(num_channels, E if i == 3 else num_channels, 1))
            for i in range(4)))
        self.pos_encoder = _PositionalEncoding(E, cfg.max_length)
        self.project = nn.Linear(E, E)

    def forward(self, x):
        """x (B, E, H, W) -> attention vectors (B, T, E) in x's dtype."""
        B, E, H, W = x.shape
        k, feats = x, []
        for stage in self.k_encoder:
            k = cnn.conv_bn(k, stage[0], stage[1], relu=True)
            feats.append(k)
        for i in range(3):
            k = F.interpolate(k, size=(k.shape[2] * 2, k.shape[3] * 2), mode='nearest-exact')
            stage = self.k_decoder[i]
            k = cnn.conv_bn(k, stage[1], stage[2], relu=True) + feats[2 - i]
        k = F.interpolate(k, size=(H, W), mode='nearest-exact')
        k = cnn.conv_bn(k, self.k_decoder[3][1], self.k_decoder[3][2], relu=True)

        q = linear(self.pos_encoder.table(self.max_length, x.dtype), self.project.weight,
                   self.project.bias)  # (T, E)
        scores = (q @ k.flatten(2)) / math.sqrt(E)  # (B, T, H*W) in x's dtype
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return attn @ x.flatten(2).transpose(1, 2)


class SVAttention(nn.Module):
    """The `Attention` variant of abinet-sv (needs H*W == n_feature)."""

    def __init__(self, cfg: ABINetConfig, n_feature=256):
        super().__init__()
        E, T = cfg.d_model, cfg.max_length
        self.f0_embedding = nn.Embedding(T, E)
        self.w0 = nn.Linear(T, n_feature)
        self.wv = nn.Linear(E, E)
        self.we = nn.Linear(E, T)

    def forward(self, x):
        """x (B, E, H, W) -> attention vectors (B, T, E) in x's dtype."""
        enc = x.flatten(2).transpose(1, 2)  # (B, H*W, E)
        emb = self.f0_embedding.weight.to(enc.dtype)  # embeddings of positions 0..T-1
        t = linear(emb.t(), self.w0.weight, self.w0.bias)  # (E, n)
        t = torch.tanh(t.t() + linear(enc, self.wv.weight, self.wv.bias))  # (B, n, E)
        scores = linear(t, self.we.weight, self.we.bias).transpose(1, 2)  # (B, T, n)
        attn = torch.softmax(scores.float(), dim=2)
        return attn.to(enc.dtype) @ enc


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


class ABINet(nn.Module):
    def __init__(self, cfg: ABINetConfig):
        super().__init__()
        self.cfg = cfg
        E, T = cfg.d_model, cfg.max_length
        gh, gw = cfg.feat_hw

        self.vision = nn.Module()
        self.vision.backbone = nn.Module()
        self.vision.backbone.resnet = Resnet45()
        if cfg.v_backbone == 'transformer':
            self.vision.backbone.pos_encoder = _PositionalEncoding(E, gh * gw)
            self.vision.backbone.transformer = _Layers(
                _EncoderLayer(cfg) for _ in range(cfg.v_num_layers))
        self.vision.attention = (PositionAttention(cfg) if cfg.v_attention == 'position'
                                 else SVAttention(cfg))
        self.vision.cls = nn.Linear(E, cfg.num_classes)

        self.language = nn.Module()
        self.language.proj = nn.Linear(cfg.num_classes, E, bias=False)
        self.language.token_encoder = _PositionalEncoding(E, T)
        self.language.pos_encoder = _PositionalEncoding(E, T)
        self.language.model = _Layers(_DecoderLayer(cfg) for _ in range(cfg.l_num_layers))
        self.language.cls = nn.Linear(E, cfg.num_classes)

        self.alignment = nn.Module()
        self.alignment.w_att = nn.Linear(2 * E, E)
        self.alignment.cls = nn.Linear(E, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights from `generator` with the JAX package's schemes:
        He-normal (fan_out, relu) convolutions with zero bias; identity batch
        norm (running mean 0, var 1); truncated normal (std 0.02, cut at 2
        std) linears and embeddings with zero bias; xavier-uniform q/k/v/out
        attention projections; unit LayerNorm scales."""

        def tn(t):
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                nn.init.normal_(m.weight, std=math.sqrt(2.0 / (cout * kh * kw)),
                                generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                tn(m.weight)
                if m.bias is not None:
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

    @torch.no_grad()
    def alignment_init(self, generator: torch.Generator):
        """Redraw the alignment model's weights in place (truncated normal,
        std 0.02, zero biases), as the JAX package's `alignment_init` at the
        switch from pretraining to joint training; `generator` may be on
        any device. The parameters stay the same tensors, so an optimizer
        keeps its moments for them."""
        for lin in (self.alignment.w_att, self.alignment.cls):
            w = torch.empty(lin.weight.shape, device=generator.device)
            nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
            lin.weight.copy_(w)
            nn.init.zeros_(lin.bias)

    # -- sub-models (each returns the JAX package's result dict) ------------
    # rng: None (no dropout) or a torch.Generator on the images' device.

    def vision_forward(self, images, rng=None):
        """images (B, H, W, 3) NHWC in the compute dtype -> {'feature' (B, T, E),
        'logits' (B, T, C) f32, 'pt_lengths' (B,)}."""
        cfg, V = self.cfg, self.vision
        rows = images.shape[0]
        heads = ('abinet.position_attention' if isinstance(V.attention, PositionAttention)
                 else 'abinet.attention')
        with trace.span('abinet.vision', device=True, rows=rows):
            launched = cnn.launches
            with trace.span('abinet.backbone', device=True, rows=rows) as backbone:
                x = V.backbone.resnet(images.permute(0, 3, 1, 2))
                backbone.set(bn_kernel=cnn.launches - launched)
            B, E, H, W = x.shape
            if cfg.v_backbone == 'transformer':
                with trace.span('abinet.transformer', device=True, rows=rows):
                    seq = (x.flatten(2).transpose(1, 2)
                           + V.backbone.pos_encoder.table(H * W, x.dtype))
                    for layer in V.backbone.transformer.layers:
                        seq = layer(seq, rng)
                    x = seq.transpose(1, 2).reshape(B, E, H, W)
            with trace.span(heads, device=True, rows=rows):
                vecs = V.attention(x)
            logits = linear(vecs, V.cls.weight, V.cls.bias).float()
            return {'feature': vecs, 'logits': logits,
                    'pt_lengths': get_length(logits, cfg.null_label)}

    def language_forward(self, tokens, lengths, rng=None):
        """BCN language model. tokens (B, T, num_classes) probabilities in the
        compute dtype, detached when cfg.l_detach; lengths (B,) integer."""
        cfg, Lm = self.cfg, self.language
        T = cfg.max_length
        if cfg.l_detach:
            tokens = tokens.detach()
        embed = linear(tokens, Lm.proj.weight)  # no bias
        embed = dropout(embed + Lm.token_encoder.table(T, embed.dtype), cfg.dropout, rng)
        query = Lm.pos_encoder.table(T, embed.dtype).expand_as(embed)
        padding_mask = torch.arange(T, device=tokens.device)[None, :] >= lengths[:, None]
        eye = torch.eye(T, dtype=torch.bool, device=tokens.device)
        loc_bias = torch.where(eye, NEG_INF, 0.0).float()  # no attending to one's own position
        out = query
        for layer in Lm.model.layers:
            out = layer(out, embed, loc_bias, padding_mask, rng)
        logits = linear(out, Lm.cls.weight, Lm.cls.bias).float()
        return {'feature': out, 'logits': logits,
                'pt_lengths': get_length(logits, cfg.null_label)}

    def alignment_forward(self, l_feature, v_feature):
        A = self.alignment
        f = torch.cat([l_feature, v_feature], dim=-1)
        gate = torch.sigmoid(linear(f, A.w_att.weight, A.w_att.bias))
        out = gate * v_feature + (1 - gate) * l_feature
        logits = linear(out, A.cls.weight, A.cls.bias).float()
        return {'logits': logits, 'pt_lengths': get_length(logits, self.cfg.null_label)}

    def forward_iterations(self, images, dtype=torch.float32, rng=None):
        """Iterative refinement. Returns (all_a, all_l, v_res): the alignment
        and language results of every iteration and the vision result."""
        cfg = self.cfg
        v_res = self.vision_forward(images.to(dtype), rng)
        a_res = v_res
        all_a, all_l = [], []
        for j in range(cfg.iter_size):
            with trace.span('abinet.iteration', device=True, rows=images.shape[0], iteration=j):
                tokens = torch.softmax(a_res['logits'], dim=-1).to(dtype)
                lengths = a_res['pt_lengths'].clamp(2, cfg.max_length)
                l_res = self.language_forward(tokens, lengths, rng)
                all_l.append(l_res)
                a_res = self.alignment_forward(l_res['feature'], v_res['feature'])
                all_a.append(a_res)
        return all_a, all_l, v_res

    def forward(self, images, dtype=torch.float32):
        """images (B, H, W, 3) NHWC -> final alignment logits (B, T, C) f32
        (the JAX package's inference_logits)."""
        return self.forward_iterations(images, dtype)[0][-1]['logits']
