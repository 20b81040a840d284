"""JAX parameters -> reference-schema state_dicts (inverses of
parseq_tpu/utils/torch_convert.py: convert_vit_encoder, convert_parseq,
convert_vitstr, convert_abinet, convert_crnn, convert_trba and
convert_trba_attention).

This is how weights move from the JAX package to the port:

    sd = state_dict_from_jax(params)        # params: parseq.init / convert_parseq tree
    sd = vitstr_state_dict_from_jax(params)           # vitstr.init tree
    sd = abinet_state_dict_from_jax(params, stats)    # abinet.init (params, stats)
    sd = crnn_state_dict_from_jax(params, stats)      # crnn.init (params, stats)
    sd = trba_state_dict_from_jax(params, stats, use_ctc)  # trba.init (params, stats)
    model.load_state_dict(sd, strict=True)

Per leaf: JAX linear weights (in, out) are transposed to torch (out, in);
separate q/k/v projections are packed into `qkv` (timm) and `in_proj_*`
(nn.MultiheadAttention); the patch matmul weight (ph*pw*C, D), flattened
in (ph, pw, C) order, is permuted back to the Conv2d layout (D, C, ph, pw);
the depth-stacked encoder blocks are unstacked; conv kernels (kh, kw, Cin,
Cout) become (Cout, Cin, kh, kw); batch-norm statistics become running_mean /
running_var; LSTM (in, 4H) / (H, 4H) weights become weight_ih / weight_hh. Leaves may be numpy or jax arrays (anything np.asarray takes);
no jax import is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from parseq_tpu_torch.models.abinet import sinusoid_pe


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _lin(sd, prefix, p):
    sd[f'{prefix}.weight'] = _t(np.asarray(p['w']).T)
    if 'b' in p:
        sd[f'{prefix}.bias'] = _t(p['b'])


def _ln(sd, prefix, p):
    sd[f'{prefix}.weight'] = _t(p['scale'])
    sd[f'{prefix}.bias'] = _t(p['bias'])


def _packed(p):
    """q/k/v (in, out) weights -> packed (3D, D) torch weight and (3D,) bias."""
    w = np.concatenate([np.asarray(p[k]['w']).T for k in 'qkv'], axis=0)
    b = np.concatenate([np.asarray(p[k]['b']) for k in 'qkv'], axis=0)
    return _t(w), _t(b)


def _mha(sd, prefix, p):
    sd[f'{prefix}.in_proj_weight'], sd[f'{prefix}.in_proj_bias'] = _packed(p)
    _lin(sd, f'{prefix}.out_proj', p['out'])


def vit_state_dict(enc, prefix='encoder', patch_size=(4, 8), in_chans=3):
    """vit.init-layout encoder params -> timm VisionTransformer state_dict."""
    pre = f'{prefix}.' if prefix else ''
    sd = {}
    ph, pw = patch_size
    w = np.asarray(enc['patch_embed']['w'])
    D = w.shape[1]
    sd[f'{pre}patch_embed.proj.weight'] = _t(w.reshape(ph, pw, in_chans, D).transpose(3, 2, 0, 1))
    sd[f'{pre}patch_embed.proj.bias'] = _t(enc['patch_embed']['b'])
    sd[f'{pre}pos_embed'] = _t(enc['pos_embed'])
    if 'cls_token' in enc:
        sd[f'{pre}cls_token'] = _t(enc['cls_token'])
    blocks = enc['blocks']
    depth = np.asarray(blocks['norm1']['scale']).shape[0]
    for i in range(depth):
        bp = f'{pre}blocks.{i}'
        blk = _index_tree(blocks, i)
        _ln(sd, f'{bp}.norm1', blk['norm1'])
        sd[f'{bp}.attn.qkv.weight'], sd[f'{bp}.attn.qkv.bias'] = _packed(blk['attn'])
        _lin(sd, f'{bp}.attn.proj', blk['attn']['out'])
        _ln(sd, f'{bp}.norm2', blk['norm2'])
        _lin(sd, f'{bp}.mlp.fc1', blk['mlp']['fc1'])
        _lin(sd, f'{bp}.mlp.fc2', blk['mlp']['fc2'])
    _ln(sd, f'{pre}norm', enc['norm'])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(params, patch_size=(4, 8), in_chans=3):
    """JAX PARSeq param tree -> reference PARSeq state_dict (float32 tensors)."""
    sd = vit_state_dict(params['encoder'], 'encoder', patch_size, in_chans)
    for i, lp in enumerate(params['decoder']['layers']):
        pre = f'decoder.layers.{i}'
        for attn in ('self_attn', 'cross_attn'):
            _mha(sd, f'{pre}.{attn}', lp[attn])
        _lin(sd, f'{pre}.linear1', lp['linear1'])
        _lin(sd, f'{pre}.linear2', lp['linear2'])
        for norm in ('norm1', 'norm2', 'norm_q', 'norm_c'):
            _ln(sd, f'{pre}.{norm}', lp[norm])
    _ln(sd, 'decoder.norm', params['decoder']['norm'])
    _lin(sd, 'head', params['head'])
    sd['text_embed.embedding.weight'] = _t(params['text_embed']['w'])
    sd['pos_queries'] = _t(params['pos_queries'])
    return sd


def vitstr_state_dict_from_jax(params, patch_size=(16, 16), in_chans=3):
    """JAX ViTSTR param tree -> reference ViTSTR state_dict (flat timm keys
    plus head)."""
    sd = vit_state_dict(params['encoder'], '', patch_size, in_chans)
    _lin(sd, 'head', params['head'])
    return sd


def _conv(sd, prefix, p):
    sd[f'{prefix}.weight'] = _t(np.asarray(p['w']).transpose(3, 2, 0, 1))
    if 'b' in p:
        sd[f'{prefix}.bias'] = _t(p['b'])


def _bn(sd, prefix, p, stats):
    sd[f'{prefix}.weight'] = _t(p['scale'])
    sd[f'{prefix}.bias'] = _t(p['bias'])
    sd[f'{prefix}.running_mean'] = _t(stats['mean'])
    sd[f'{prefix}.running_var'] = _t(stats['var'])
    sd[f'{prefix}.num_batches_tracked'] = torch.zeros((), dtype=torch.int64)


def _conv_bn(sd, conv_prefix, bn_prefix, p, stats):
    _conv(sd, conv_prefix, p['conv'])
    _bn(sd, bn_prefix, p['bn'], stats)


def _pe(sd, prefix, length, d_model):
    sd[f'{prefix}.pe'] = sinusoid_pe(length, d_model)[:, None]


def abinet_state_dict_from_jax(params, stats, *, img_size=(32, 128), max_label_length=25):
    """JAX ABINet (params, stats) -> reference ABINet state_dict, with the
    positional-encoding buffers (their lengths come from `img_size` and
    `max_label_length`, which the parameters do not fix)."""
    sd = {}
    vp, vs = params['vision'], stats['vision']
    rp, rs = vp['resnet'], vs['resnet']
    pre = 'vision.backbone.resnet'
    _conv_bn(sd, f'{pre}.conv1', f'{pre}.bn1', rp['stem'], rs['stem'])
    n_layers = sum(1 for k in rp if k.startswith('layer'))
    for li in range(1, n_layers + 1):
        for bi, (bp, bs) in enumerate(zip(rp[f'layer{li}'], rs[f'layer{li}'])):
            b = f'{pre}.layer{li}.{bi}'
            _conv_bn(sd, f'{b}.conv1', f'{b}.bn1', bp['conv1'], bs['conv1'])
            _conv_bn(sd, f'{b}.conv2', f'{b}.bn2', bp['conv2'], bs['conv2'])
            if 'down' in bp:
                _conv_bn(sd, f'{b}.downsample.0', f'{b}.downsample.1', bp['down'], bs['down'])
    D = np.asarray(vp['cls']['w']).shape[0]
    T = max_label_length + 1
    if 'transformer' in vp:
        _pe(sd, 'vision.backbone.pos_encoder', (img_size[0] // 4) * (img_size[1] // 4), D)
        for i, lp in enumerate(vp['transformer']):
            b = f'vision.backbone.transformer.layers.{i}'
            _mha(sd, f'{b}.self_attn', lp['self_attn'])
            for name in ('linear1', 'linear2'):
                _lin(sd, f'{b}.{name}', lp[name])
            for name in ('norm1', 'norm2'):
                _ln(sd, f'{b}.{name}', lp[name])
    ap = vp['attention']
    if 'k_encoder' in ap:  # PositionAttention
        a_s = vs['attention']
        for i in range(4):
            _conv_bn(sd, f'vision.attention.k_encoder.{i}.0', f'vision.attention.k_encoder.{i}.1',
                     ap['k_encoder'][i], a_s['k_encoder'][i])
            _conv_bn(sd, f'vision.attention.k_decoder.{i}.1', f'vision.attention.k_decoder.{i}.2',
                     ap['k_decoder'][i], a_s['k_decoder'][i])
        _pe(sd, 'vision.attention.pos_encoder', T, D)
        _lin(sd, 'vision.attention.project', ap['project'])
    else:  # the sv Attention variant
        sd['vision.attention.f0_embedding.weight'] = _t(ap['f0_embedding']['w'])
        for name in ('w0', 'wv', 'we'):
            _lin(sd, f'vision.attention.{name}', ap[name])
    _lin(sd, 'vision.cls', vp['cls'])

    lang = params['language']
    _lin(sd, 'language.proj', lang['proj'])
    _pe(sd, 'language.token_encoder', T, D)
    _pe(sd, 'language.pos_encoder', T, D)
    for i, lp in enumerate(lang['layers']):
        b = f'language.model.layers.{i}'
        _mha(sd, f'{b}.multihead_attn', lp['multihead_attn'])
        if 'self_attn' in lp:
            _mha(sd, f'{b}.self_attn', lp['self_attn'])
            _ln(sd, f'{b}.norm1', lp['norm1'])
        for name in ('linear1', 'linear2'):
            _lin(sd, f'{b}.{name}', lp[name])
        for name in ('norm2', 'norm3'):
            _ln(sd, f'{b}.{name}', lp[name])
    _lin(sd, 'language.cls', lang['cls'])
    _lin(sd, 'alignment.w_att', params['alignment']['w_att'])
    _lin(sd, 'alignment.cls', params['alignment']['cls'])
    return sd


def _lstm_dir(sd, prefix, p, suffix=''):
    sd[f'{prefix}.weight_ih{suffix}'] = _t(np.asarray(p['wih']).T)
    sd[f'{prefix}.weight_hh{suffix}'] = _t(np.asarray(p['whh']).T)
    sd[f'{prefix}.bias_ih{suffix}'] = _t(p['bih'])
    sd[f'{prefix}.bias_hh{suffix}'] = _t(p['bhh'])


def _bilstm(sd, prefix, p):
    """rnn.bilstm params -> reference BidirectionalLSTM keys."""
    _lstm_dir(sd, f'{prefix}.rnn', p['fwd'], '_l0')
    _lstm_dir(sd, f'{prefix}.rnn', p['bwd'], '_l0_reverse')
    _lin(sd, f'{prefix}.linear', p['linear'])


def crnn_state_dict_from_jax(params, stats):
    """JAX CRNN (params, stats) -> reference CRNN state_dict."""
    sd = {}
    bn_stats = iter(stats['bn'])
    for i, c in enumerate(params['cnn']):
        _conv(sd, f'cnn.conv{i}', c['conv'])
        if 'bn' in c:
            _bn(sd, f'cnn.batchnorm{i}', c['bn'], next(bn_stats))
    _bilstm(sd, 'rnn.0', params['rnn0'])
    _bilstm(sd, 'rnn.1', params['rnn1'])
    return sd


def trba_state_dict_from_jax(params, stats, use_ctc=False):
    """JAX TRBA / TRBC (params, stats) -> reference state_dict, without the
    GridGenerator buffers (models/trba.py fills them in)."""
    sd = {}
    loc, loc_s = params['loc'], stats['loc']
    pre = 'Transformation.LocalizationNetwork'
    for i, si in enumerate((0, 4, 8, 12)):
        _conv_bn(sd, f'{pre}.conv.{si}', f'{pre}.conv.{si + 1}', loc[f'conv{i}'],
                 loc_s[f'conv{i}'])
    _lin(sd, f'{pre}.localization_fc1.0', loc['fc1'])
    _lin(sd, f'{pre}.localization_fc2', loc['fc2'])

    rn, rn_s = params['resnet'], stats['resnet']
    cn = 'FeatureExtraction.ConvNet'
    for name in ('conv0_1', 'conv0_2', 'conv1', 'conv2', 'conv3', 'conv4_1', 'conv4_2'):
        key = {'conv0_1': 'stem1', 'conv0_2': 'stem2'}.get(name, name)
        _conv_bn(sd, f'{cn}.{name}', f'{cn}.bn{name.removeprefix("conv")}', rn[key], rn_s[key])
    for li in range(1, 5):
        for bi, (bp, bs) in enumerate(zip(rn[f'layer{li}'], rn_s[f'layer{li}'])):
            b = f'{cn}.layer{li}.{bi}'
            _conv_bn(sd, f'{b}.conv1', f'{b}.bn1', bp['conv1'], bs['conv1'])
            _conv_bn(sd, f'{b}.conv2', f'{b}.bn2', bp['conv2'], bs['conv2'])
            if 'down' in bp:
                _conv_bn(sd, f'{b}.downsample.0', f'{b}.downsample.1', bp['down'], bs['down'])

    _bilstm(sd, 'SequenceModeling.0', params['rnn0'])
    _bilstm(sd, 'SequenceModeling.1', params['rnn1'])
    pred = params['pred']
    if use_ctc:
        _lin(sd, 'Prediction', pred)
        return sd
    ac = 'Prediction.attention_cell'
    _lin(sd, f'{ac}.i2h', pred['i2h'])
    _lin(sd, f'{ac}.h2h', pred['h2h'])
    _lin(sd, f'{ac}.score', pred['score'])
    _lstm_dir(sd, f'{ac}.rnn', pred['cell'])
    _lin(sd, 'Prediction.generator', pred['generator'])
    sd['Prediction.char_embeddings.weight'] = _t(pred['char_embeddings']['w'])
    return sd
