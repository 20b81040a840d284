"""ABINet (Fang et al., CVPR 2021, arXiv:2103.06495; strhub/models/abinet):
a vision model (ResNet45, post-LN transformer layers over its feature map,
position attention with a U-Net on the keys), a BCN cloze language model
(decoder layers without self-attention, each position hidden from itself
and the keys past the predicted length hidden), and a gated alignment of
the language and vision features, iterated `iter_size` times: each
alignment's probabilities and length go back into the language model.

Reading, with the batch norms in eval mode (their running statistics):
teacher-forced on the lengths the program's language passes took, as
PARSeq's read is on its AR picks. `picks[:, j]` is the length derivation j
gave in the program (0: the vision logits; j >= 1: the alignment of
iteration j - 1), before the clamp to [2, T]; iteration j takes
`picks[:, j].clamp(2, T)`. The first output holds at row j < iter_size, in
column l for each length l in 1..T, minus the least total change of the
reference's logits of derivation j that makes its argmaxes give length l;
its other entries are NEG, and its rows from iter_size on are 0. Row j
depends on `picks[:, :j]` alone, so the comparison's `ar_logit_gap` reads
how far the reference is from taking the program's length, and the
control's greedy picks are the reference's own lengths.

Departures from the released code, forced by the harness's weight kinds
(harness/weights.py), are in benchmark/configs/abinet.json under `assumed`:
the sinusoidal `pe` tables are drawn as weights, the batch norms are
identities, and the kinds of the convolutions and of the position queries'
projection keep the features near unit scale (init_kind). Only the configuration's setting is written here: the
`transformer` backbone, `position` attention and the decoder layers without
self-attention.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from .ops import Ops, _round, layer_norm
from .parseq import mha

AR = True
NEG = -1e9  # the first output where no length can be read

PLANES, BLOCKS, STRIDES = (32, 64, 128, 256, 512), (3, 4, 6, 6, 3), (2, 1, 2, 1, 1)
CHANNELS = 64  # the position attention's U-Net
K_STRIDES = ((1, 2), (2, 2), (2, 2), (2, 2))
_CONV = re.compile(r'(conv\d|downsample\.0|k_encoder\.\d\.0|k_decoder\.\d\.1)\.weight$')
# convolutions drawn truncated normal, not xavier (init_kind): ResNet45's blocks' 3x3 ones and
# the position attention U-Net's six 64-channel ones
_TN_CONV = re.compile(r'(resnet\.layer\d\.\d+\.conv2|k_encoder\.[1-3]\.0|k_decoder\.[0-2]\.1)'
                      r'\.weight$')
_BN = re.compile(r'(bn\d|downsample\.1|k_encoder\.\d\.1|k_decoder\.\d\.2)\.')


def conv(ops, x, w, b=None, stride=1, padding=0):
    """F.conv2d; in the control's precision both operands are rounded to
    float8 e4m3 as its products' are (reference/ops.py)."""
    if ops.precision == 'fp8':
        x, w = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
    return F.conv2d(x, w, b, stride, padding)


def batch_norm(p, pre, x, eps=1e-5):
    """Eval-mode BatchNorm2d of (B, C, H, W) from the running statistics."""
    scale = p[pre + 'weight'] / torch.sqrt(p[pre + 'running_var'] + eps)
    shift = p[pre + 'bias'] - p[pre + 'running_mean'] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def resnet45(ops, p, x):
    """(B, 3, H, W) -> (B, 512, H / 4, W / 4): a 3x3 stem, then five stages
    of blocks (1x1 conv, 3x3 conv with the stage's stride, a 1x1 projection
    of the input where the shape changes), each conv followed by a batch
    norm."""
    pre = 'vision.backbone.resnet.'
    x = F.relu(batch_norm(p, pre + 'bn1.', conv(ops, x, p[pre + 'conv1.weight'], padding=1)))
    for li, (n, stride) in enumerate(zip(BLOCKS, STRIDES)):
        for bi in range(n):
            b = f'{pre}layer{li + 1}.{bi}.'
            s = stride if bi == 0 else 1
            out = F.relu(batch_norm(p, b + 'bn1.', conv(ops, x, p[b + 'conv1.weight'])))
            out = batch_norm(p, b + 'bn2.', conv(ops, out, p[b + 'conv2.weight'], stride=s,
                                                 padding=1))
            if b + 'downsample.0.weight' in p:
                x = batch_norm(p, b + 'downsample.1.',
                               conv(ops, x, p[b + 'downsample.0.weight'], stride=s))
            x = F.relu(out + x)
    return x


def encoder_layer(ops, p, pre, x, heads):
    """torch's TransformerEncoderLayer: post-LN, ReLU."""
    x = layer_norm(x + mha(ops, p, pre + 'self_attn.', x, x, heads),
                   p[pre + 'norm1.weight'], p[pre + 'norm1.bias'])
    h = F.relu(ops.linear(x, p[pre + 'linear1.weight'], p[pre + 'linear1.bias']))
    h = ops.linear(h, p[pre + 'linear2.weight'], p[pre + 'linear2.bias'])
    return layer_norm(x + h, p[pre + 'norm2.weight'], p[pre + 'norm2.bias'])


def position_attention(ops, p, cfg, x):
    """(B, E, H, W) -> (B, T, E): keys through a U-Net (four strided
    conv-BN-ReLU stages; three nearest x2 upsamplings, each a conv-BN-ReLU
    plus the encoder stage of that size; a last upsampling to (H, W) and
    conv-BN-ReLU to E channels), queries the projected positional table,
    values x itself."""
    pre = 'vision.attention.'
    B, E, H, W = x.shape
    T = cfg['max_label_length'] + 1

    def cbr(k, c, bn, stride=1):  # 3x3 conv with bias, batch norm, ReLU
        k = conv(ops, k, p[c + 'weight'], p[c + 'bias'], stride, 1)
        return F.relu(batch_norm(p, bn, k))

    k, feats = x, []
    for i, s in enumerate(K_STRIDES):
        k = cbr(k, f'{pre}k_encoder.{i}.0.', f'{pre}k_encoder.{i}.1.', s)
        feats.append(k)
    for i in range(4):
        size = (H, W) if i == 3 else (2 * k.shape[2], 2 * k.shape[3])
        k = cbr(F.interpolate(k, size=size, mode='nearest'), f'{pre}k_decoder.{i}.1.',
                f'{pre}k_decoder.{i}.2.')
        if i < 3:
            k = k + feats[2 - i]
    q = ops.linear(p[pre + 'pos_encoder.pe'][:T, 0].expand(B, T, E), p[pre + 'project.weight'],
                   p[pre + 'project.bias'])
    attn = torch.softmax(ops.mm(q, k.flatten(2)) / math.sqrt(E), dim=-1)
    return ops.mm(attn, x.flatten(2).transpose(1, 2))


def vision(ops, p, cfg, images):
    """images (B, H, W, 3) -> (features (B, T, E), logits (B, T, C))."""
    x = resnet45(ops, p, images.permute(0, 3, 1, 2))
    B, E, H, W = x.shape
    seq = x.flatten(2).transpose(1, 2) + p['vision.backbone.pos_encoder.pe'][:H * W, 0]
    for i in range(cfg['v_num_layers']):
        seq = encoder_layer(ops, p, f'vision.backbone.transformer.layers.{i}.', seq,
                            cfg['nhead'])
    vecs = position_attention(ops, p, cfg, seq.transpose(1, 2).reshape(B, E, H, W))
    return vecs, ops.linear(vecs, p['vision.cls.weight'], p['vision.cls.bias'])


def language(ops, p, cfg, probs, lengths):
    """BCN: probs (B, T, C), lengths (B,) in [2, T] -> (features, logits).
    Queries are the positional table; keys and values the projected
    probabilities plus their positional table; query t may not see key t
    nor any key at or past its read's length."""
    T = probs.shape[1]
    embed = ops.linear(probs, p['language.proj.weight']) + p['language.token_encoder.pe'][:T, 0]
    out = p['language.pos_encoder.pe'][:T, 0].expand_as(embed)
    r = torch.arange(T, device=probs.device)
    hidden = ((r[None, :] == r[:, None])[None, None]
              | (r[None, :] >= lengths[:, None])[:, None, None, :])  # (B, 1, T, T)
    for i in range(cfg['l_num_layers']):
        pre = f'language.model.layers.{i}.'
        a = mha(ops, p, pre + 'multihead_attn.', out, embed, cfg['nhead'], hidden)
        out = layer_norm(out + a, p[pre + 'norm2.weight'], p[pre + 'norm2.bias'])
        h = F.relu(ops.linear(out, p[pre + 'linear1.weight'], p[pre + 'linear1.bias']))
        h = ops.linear(h, p[pre + 'linear2.weight'], p[pre + 'linear2.bias'])
        out = layer_norm(out + h, p[pre + 'norm3.weight'], p[pre + 'norm3.bias'])
    return out, ops.linear(out, p['language.cls.weight'], p['language.cls.bias'])


def alignment(ops, p, l_feature, v_feature):
    """The gated sum of both features, then its classifier."""
    gate = torch.sigmoid(ops.linear(torch.cat([l_feature, v_feature], -1),
                                    p['alignment.w_att.weight'], p['alignment.w_att.bias']))
    out = gate * v_feature + (1 - gate) * l_feature
    return ops.linear(out, p['alignment.cls.weight'], p['alignment.cls.bias'])


def length_costs(logits):
    """(B, T, C) -> (B, T): at index l - 1, the least total change of the
    logits that makes the released `_get_length` give l: the first position
    whose argmax is 0 (EOS), plus one, or T where there is none. Making a
    position's argmax EOS costs its best other logit less the EOS logit,
    making it not EOS the reverse (each at least 0)."""
    other = logits[..., 1:].max(-1).values
    to_eos = (other - logits[..., 0]).clamp(min=0)
    not_eos = (logits[..., 0] - other).clamp(min=0)
    before = torch.cumsum(not_eos, -1) - not_eos  # every earlier position not EOS
    cost = before + to_eos
    cost[:, -1] = before[:, -1]  # length T: EOS at the last position or nowhere
    return cost


def read(p, cfg, ids, images, picks, ops=None):
    """images (B, H, W, 3) float32 in [-1, 1]; picks (B, T) the program's
    lengths at positions 0 to iter_size - 1. Returns the length rows (the
    module's docstring) and the last alignment's logits, each (B, T, C)."""
    ops = ops or Ops()
    v_feature, logits = vision(ops, p, cfg, images)
    B, T, C = logits.shape
    n = cfg['iter_size']
    assert C > T and picks.shape[1] == T >= n
    rows = torch.zeros(B, T, C, device=logits.device)
    for j in range(n):
        rows[:, j] = NEG
        rows[:, j, 1:T + 1] = -length_costs(logits)
        lengths = picks[:, j].clamp(2, T)
        l_feature, _ = language(ops, p, cfg, torch.softmax(logits, -1), lengths)
        logits = alignment(ops, p, l_feature, v_feature)
    return rows, logits


def init_kind(name):
    """How the weights are drawn (harness/weights.py), so that with identity
    batch norms the features keep about unit scale and the logits depend on
    the image and the position. Convolutions xavier uniform (bound
    sqrt(3 / C_in), variance kept by a 1x1 one), but truncated normal (std
    0.02) for ResNet45's blocks' 3x3 ones (xavier multiplies the variance by
    9 a block, and the identity shortcuts compound it: features of std
    ~1e5-1e6, one-hot attention) and for the U-Net's six 64-channel ones (the
    keys then have std ~3); the positional tables and the queries'
    projection xavier (unit scale, as the sinusoids are); attention
    projections xavier; other linears truncated normal; biases zero; batch
    norms and LayerNorms identity."""
    if _TN_CONV.search(name):
        return 'tn'
    if _CONV.search(name) or name.endswith(('.pe', 'in_proj_weight', 'out_proj.weight',
                                            'attention.project.weight')):
        return 'xavier'
    if _BN.search(name):
        return 'one' if name.endswith(('.weight', 'running_var')) else 'zero'
    if name.endswith('bias'):
        return 'zero'
    if 'norm' in name:
        return 'one'
    return 'tn'


def param_shapes(cfg, ids):
    """The port's state_dict names (the released ones) and shapes, buffers
    included: batch norms' running statistics and the `pe` tables."""
    assert (cfg['v_backbone'], cfg['v_attention'], cfg['l_use_self_attn']) == (
        'transformer', 'position', False)
    E, Fd, C = cfg['d_model'], cfg['d_inner'], ids.num_classes
    T = cfg['max_label_length'] + 1
    H, W = cfg['img_size'][0] // 4, cfg['img_size'][1] // 4
    out = {}

    def conv_(name, cout, cin, k, bias=False):
        out[name + '.weight'] = (cout, cin, k, k)
        if bias:
            out[name + '.bias'] = (cout,)

    def bn_(name, c):
        out.update({f'{name}.{k}': (c,) for k in ('weight', 'bias', 'running_mean',
                                                  'running_var')})
        out[name + '.num_batches_tracked'] = ()

    def linear_(name, n_out, n_in, bias=True):
        out[name + '.weight'] = (n_out, n_in)
        if bias:
            out[name + '.bias'] = (n_out,)

    def attn_(name):
        out.update({name + '.in_proj_weight': (3 * E, E), name + '.in_proj_bias': (3 * E,)})
        linear_(name + '.out_proj', E, E)

    def norm_(name):
        out.update({name + '.weight': (E,), name + '.bias': (E,)})

    r = 'vision.backbone.resnet.'
    conv_(r + 'conv1', 32, 3, 3)
    bn_(r + 'bn1', 32)
    cin = 32
    for li, (planes, n, stride) in enumerate(zip(PLANES, BLOCKS, STRIDES)):
        for bi in range(n):
            b = f'{r}layer{li + 1}.{bi}.'
            c = cin if bi == 0 else planes
            conv_(b + 'conv1', planes, c, 1)
            bn_(b + 'bn1', planes)
            conv_(b + 'conv2', planes, planes, 3)
            bn_(b + 'bn2', planes)
            if bi == 0 and (stride != 1 or c != planes):
                conv_(b + 'downsample.0', planes, c, 1)
                bn_(b + 'downsample.1', planes)
        cin = planes
    out['vision.backbone.pos_encoder.pe'] = (H * W, 1, E)
    for i in range(cfg['v_num_layers']):
        b = f'vision.backbone.transformer.layers.{i}.'
        attn_(b + 'self_attn')
        linear_(b + 'linear1', Fd, E)
        linear_(b + 'linear2', E, Fd)
        norm_(b + 'norm1')
        norm_(b + 'norm2')
    a = 'vision.attention.'
    for i in range(4):
        conv_(f'{a}k_encoder.{i}.0', CHANNELS, E if i == 0 else CHANNELS, 3, bias=True)
        bn_(f'{a}k_encoder.{i}.1', CHANNELS)
    for i in range(4):
        conv_(f'{a}k_decoder.{i}.1', E if i == 3 else CHANNELS, CHANNELS, 3, bias=True)
        bn_(f'{a}k_decoder.{i}.2', E if i == 3 else CHANNELS)
    out[a + 'pos_encoder.pe'] = (T, 1, E)
    linear_(a + 'project', E, E)
    linear_('vision.cls', C, E)
    linear_('language.proj', E, C, bias=False)
    out['language.token_encoder.pe'] = (T, 1, E)
    out['language.pos_encoder.pe'] = (T, 1, E)
    for i in range(cfg['l_num_layers']):
        b = f'language.model.layers.{i}.'
        attn_(b + 'multihead_attn')
        linear_(b + 'linear1', Fd, E)
        linear_(b + 'linear2', E, Fd)
        norm_(b + 'norm2')
        norm_(b + 'norm3')
    linear_('language.cls', C, E)
    linear_('alignment.w_att', E, 2 * E)
    linear_('alignment.cls', C, E)
    return out
