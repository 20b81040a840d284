"""TRBA / TRBC: TPS rectification -> FAN ResNet -> BiLSTMs -> attention
decoder (TRBA) or a linear CTC head (TRBC) (port of
parseq_tpu/models/trba.py). `module.train()` switches every batch norm, the
TPS localiser's and the ResNet's, to batch statistics (ops/cnn.py), as the
JAX package's `train=True`; training losses are in train/families.py.

Parameters carry the reference state_dict names (the keys
parseq_tpu/utils/torch_convert.py:convert_trba reads):
Transformation.LocalizationNetwork.{conv.{0,4,8,12} (+ the batch norms at
.1/.5/.9/.13), localization_fc1.0, localization_fc2},
FeatureExtraction.ConvNet.* (torchvision BasicBlock names),
SequenceModeling.{0,1}, and Prediction (a Linear for TRBC, else
Prediction.attention_cell.{i2h,h2h,score,rnn}, Prediction.generator and
Prediction.char_embeddings). The reference's GridGenerator keeps its TPS
constants as buffers, Transformation.GridGenerator.inv_delta_C and .P_hat;
the port keeps them under those names and fills in its own (the same
float64 numpy construction, cast to float32) when a state_dict has none.

Numerics follow the JAX package: the grid (inv_delta_C @ C', then P_hat)
is computed in the compute dtype, batch norm in f32; the attention decoder
is greedy from BOS over exactly num_steps steps (no early exit), or
teacher-forced when `text` is given, with the encoder projection hoisted
out of the loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch.models.crnn import init_cnn_weights
from parseq_tpu_torch.ops import cnn
from parseq_tpu_torch.ops.grid_sample import grid_sample
from parseq_tpu_torch.ops.layers import embedding, linear
from parseq_tpu_torch.ops.rnn import BidirectionalLSTM, lstm_cell


@dataclass(frozen=True)
class TRBAConfig:
    """Same fields, defaults and properties as parseq_tpu's TRBAConfig."""

    num_tokens: int = 97  # len(charset) + EOS/BOS/PAD
    max_label_length: int = 25
    img_size: tuple[int, int] = (32, 128)
    in_chans: int = 3
    num_fiducial: int = 20
    output_channel: int = 512
    hidden_size: int = 256
    num_char_embeddings: int = 256
    use_ctc: bool = False  # TRBC

    @property
    def num_steps(self) -> int:
        return self.max_label_length + 1

    @property
    def eos_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return self.num_tokens - 2

    @property
    def pad_id(self) -> int:
        return self.num_tokens - 1


# ---------------------------------------------------------------------------
# TPS constants (reference GridGenerator, transformation.py:96-169), numpy
# float64 as in parseq_tpu/models/trba.py.
# ---------------------------------------------------------------------------


def _build_C(F):
    x = np.linspace(-1.0, 1.0, F // 2)
    top = np.stack([x, -np.ones(F // 2)], axis=1)
    bot = np.stack([x, np.ones(F // 2)], axis=1)
    return np.concatenate([top, bot], axis=0)  # (F, 2)


def _build_inv_delta_C(F, C):
    hat_C = np.zeros((F, F))
    for i in range(F):
        for j in range(i, F):
            hat_C[i, j] = hat_C[j, i] = np.linalg.norm(C[i] - C[j])
    np.fill_diagonal(hat_C, 1)
    hat_C = (hat_C ** 2) * np.log(hat_C)
    delta_C = np.concatenate([
        np.concatenate([np.ones((F, 1)), C, hat_C], axis=1),
        np.concatenate([np.zeros((2, 3)), C.T], axis=1),
        np.concatenate([np.zeros((1, 3)), np.ones((1, F))], axis=1),
    ], axis=0)
    return np.linalg.inv(delta_C)  # (F+3, F+3)


def _build_P(W, H):
    gx = (np.arange(-W, W, 2) + 1.0) / W
    gy = (np.arange(-H, H, 2) + 1.0) / H
    return np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)  # (H*W, 2)


def _build_P_hat(F, C, P, eps=1e-6):
    n = P.shape[0]
    d = P[:, None, :] - C[None, :, :]
    r = np.linalg.norm(d, axis=2)
    rbf = (r ** 2) * np.log(r + eps)
    return np.concatenate([np.ones((n, 1)), P, rbf], axis=1)  # (n, F+3)


def tps_constants(cfg: TRBAConfig):
    """-> (inv_delta_C (F+3, F+3), P_hat (H*W, F+3)), float32 tensors."""
    F_ = cfg.num_fiducial
    C = _build_C(F_)
    H, W = cfg.img_size
    return (torch.from_numpy(_build_inv_delta_C(F_, C).astype(np.float32)),
            torch.from_numpy(_build_P_hat(F_, C, _build_P(W, H)).astype(np.float32)))


def _loc_initial_bias(F):
    """RARE Fig. 6(a) fiducial init (transformation.py:69-76)."""
    x = np.linspace(-1.0, 1.0, F // 2)
    top = np.stack([x, np.linspace(0.0, -1.0, F // 2)], axis=1)
    bot = np.stack([x, np.linspace(1.0, 0.0, F // 2)], axis=1)
    return np.concatenate([top, bot], axis=0).reshape(-1)


class GridGenerator(nn.Module):
    """Holds the TPS constants as the reference's buffers. A state_dict
    without them (the JAX converter's, a reference file that predates them)
    loads too: the computed constants stay."""

    def __init__(self, cfg: TRBAConfig):
        super().__init__()
        inv_delta_C, P_hat = tps_constants(cfg)
        self.register_buffer('inv_delta_C', inv_delta_C)
        self.register_buffer('P_hat', P_hat)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, buf in self._buffers.items():
            state_dict.setdefault(prefix + name, buf)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


# ---------------------------------------------------------------------------
# FAN ResNet (reference feature_extraction.py:20-110)
# ---------------------------------------------------------------------------


class BasicBlock(nn.Module):
    """torchvision BasicBlock names: conv1/bn1/conv2/bn2/downsample.{0,1}."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(cnn.conv_bn(x, self.conv1, self.bn1))
        out = cnn.conv_bn(out, self.conv2, self.bn2)
        if self.downsample is not None:
            x = cnn.conv_bn(x, self.downsample[0], self.downsample[1])
        return F.relu(out + x)


class ResNet(nn.Module):
    """x (B, C, H, W) -> (B, oc, H/32, W/4 + 1)."""

    def __init__(self, in_chans, oc):
        super().__init__()
        ocb = [oc // 4, oc // 2, oc, oc]

        def conv(cin, cout, k=3, stride=1, pad=1):
            return nn.Conv2d(cin, cout, k, stride, pad, bias=False)

        self.conv0_1, self.bn0_1 = conv(in_chans, oc // 16), nn.BatchNorm2d(oc // 16)
        self.conv0_2, self.bn0_2 = conv(oc // 16, oc // 8), nn.BatchNorm2d(oc // 8)
        cin = oc // 8
        for i, (n, cout) in enumerate(zip((1, 2, 5, 3), ocb), start=1):
            setattr(self, f'layer{i}', nn.Sequential(
                *(BasicBlock(cin if b == 0 else cout, cout) for b in range(n))))
            cin = cout
            if i < 4:
                setattr(self, f'conv{i}', conv(cout, cout))
                setattr(self, f'bn{i}', nn.BatchNorm2d(cout))
        self.conv4_1, self.bn4_1 = conv(ocb[3], ocb[3], 2, (2, 1), (0, 1)), nn.BatchNorm2d(ocb[3])
        self.conv4_2, self.bn4_2 = conv(ocb[3], ocb[3], 2, 1, 0), nn.BatchNorm2d(ocb[3])

    def _cbr(self, x, name):
        return F.relu(cnn.conv_bn(x, getattr(self, f'conv{name}'), getattr(self, f'bn{name}')))

    def forward(self, x):
        x = self._cbr(self._cbr(x, '0_1'), '0_2')
        pools = {1: ((2, 2), (2, 2)), 2: ((2, 2), (2, 2)), 3: ((2, 2), (2, 1), (0, 1))}
        for i in (1, 2, 3):
            x = cnn.max_pool2d(x, *pools[i])
            for block in getattr(self, f'layer{i}'):
                x = block(x)
            x = self._cbr(x, str(i))
        for block in self.layer4:
            x = block(x)
        return self._cbr(self._cbr(x, '4_1'), '4_2')


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


class TRBA(nn.Module):
    def __init__(self, cfg: TRBAConfig):
        super().__init__()
        self.cfg = cfg
        F_, H, oc = cfg.num_fiducial, cfg.hidden_size, cfg.output_channel

        self.Transformation = nn.Module()
        loc = self.Transformation.LocalizationNetwork = nn.Module()
        layers, cin = [], cfg.in_chans
        for i, cout in enumerate((64, 128, 256, 512)):
            layers += [nn.Conv2d(cin, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout), nn.ReLU()]
            layers.append(nn.MaxPool2d(2, 2) if i < 3 else nn.AdaptiveAvgPool2d(1))
            cin = cout
        loc.conv = nn.Sequential(*layers)
        loc.localization_fc1 = nn.Sequential(nn.Linear(512, 256), nn.ReLU())
        loc.localization_fc2 = nn.Linear(256, 2 * F_)
        self.Transformation.GridGenerator = GridGenerator(cfg)

        self.FeatureExtraction = nn.Module()
        self.FeatureExtraction.ConvNet = ResNet(cfg.in_chans, oc)
        self.SequenceModeling = nn.Sequential(BidirectionalLSTM(oc, H, H),
                                              BidirectionalLSTM(H, H, H))
        if cfg.use_ctc:
            self.Prediction = nn.Linear(H, cfg.num_tokens)
        else:
            P = self.Prediction = nn.Module()
            cell = P.attention_cell = nn.Module()
            cell.i2h = nn.Linear(H, H, bias=False)
            cell.h2h = nn.Linear(H, H)
            cell.score = nn.Linear(H, 1, bias=False)
            cell.rnn = nn.LSTMCell(H + cfg.num_char_embeddings, H)
            P.generator = nn.Linear(H, cfg.num_tokens)
            P.char_embeddings = nn.Embedding(cfg.num_tokens, cfg.num_char_embeddings)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights from `generator` with the JAX package's schemes
        (models/crnn.py:init_cnn_weights; the attention LSTM cell's biases
        zero), and the reference's fiducial init: localization_fc2 zero
        weights, bias at the RARE fiducial points."""
        init_cnn_weights(self, generator)
        fc2 = self.Transformation.LocalizationNetwork.localization_fc2
        nn.init.zeros_(fc2.weight)
        fc2.bias.copy_(torch.from_numpy(_loc_initial_bias(self.cfg.num_fiducial)))
        if not self.cfg.use_ctc:
            nn.init.zeros_(self.Prediction.attention_cell.rnn.bias_ih)
            nn.init.zeros_(self.Prediction.attention_cell.rnn.bias_hh)

    def tps(self, images):
        """Rectify NCHW images with the TPS spatial transformer."""
        loc = self.Transformation.LocalizationNetwork
        x = images
        for i in range(4):
            x = F.relu(cnn.conv_bn(x, loc.conv[4 * i], loc.conv[4 * i + 1]))
            if i < 3:
                x = cnn.max_pool2d(x, (2, 2))
        x = x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
        x = F.relu(linear(x, loc.localization_fc1[0].weight, loc.localization_fc1[0].bias))
        fc2 = loc.localization_fc2
        B = x.shape[0]
        c_prime = linear(x, fc2.weight, fc2.bias).reshape(B, self.cfg.num_fiducial, 2)
        gg = self.Transformation.GridGenerator
        cz = torch.cat([c_prime, c_prime.new_zeros(B, 3, 2)], dim=1)
        t = gg.inv_delta_C.to(c_prime.dtype) @ cz  # (B, F+3, 2)
        p_prime = gg.P_hat.to(c_prime.dtype) @ t  # (B, H*W, 2)
        grid = p_prime.reshape(B, *self.cfg.img_size, 2)
        return grid_sample(images, grid)

    def attention_decode(self, batch_H, text=None):
        """Greedy from BOS over exactly num_steps steps, or teacher-forced
        with step t fed text[:, t] when `text` (B, >= num_steps) ids is
        given. batch_H (B, T, H) in the compute dtype -> logits (B,
        num_steps, num_tokens) f32."""
        cfg, P = self.cfg, self.Prediction
        cell = P.attention_cell
        B, dtype = batch_H.shape[0], batch_H.dtype
        ctx_proj = linear(batch_H, cell.i2h.weight)  # hoisted encoder projection
        h = batch_H.new_zeros(B, cfg.hidden_size)
        c = batch_H.new_zeros(B, cfg.hidden_size)
        ids = torch.full((B,), cfg.bos_id, dtype=torch.long, device=batch_H.device)
        logits = []
        for t in range(cfg.num_steps):
            if text is not None:
                ids = text[:, t]
            e = linear(torch.tanh(ctx_proj + linear(h, cell.h2h.weight, cell.h2h.bias)[:, None]),
                       cell.score.weight)  # (B, T, 1)
            alpha = torch.softmax(e, dim=1)
            context = (alpha * batch_H).sum(dim=1)
            x = torch.cat([context, embedding(ids, P.char_embeddings.weight, dtype)], dim=-1)
            h, c = lstm_cell(linear(x, cell.rnn.weight_ih, cell.rnn.bias_ih), h, c,
                             cell.rnn.weight_hh, cell.rnn.bias_hh)
            step = linear(h, P.generator.weight, P.generator.bias)
            logits.append(step)
            ids = step.argmax(-1)
        return torch.stack(logits, dim=1).float()

    def forward(self, images, dtype=torch.float32, text=None):
        """images (B, H, W, 3) NHWC -> logits f32: TRBA (B, num_steps,
        num_tokens), greedy unless teacher-forcing `text` is given; TRBC
        (B, W/4 + 1, num_tokens) for CTC."""
        x = self.tps(images.to(dtype).permute(0, 3, 1, 2))
        x = self.FeatureExtraction.ConvNet(x)  # (B, C, h, W')
        x = x.mean(dim=2).transpose(1, 2)  # mean over h -> (B, W', C)
        for layer in self.SequenceModeling:
            x = layer(x)
        if self.cfg.use_ctc:
            return linear(x, self.Prediction.weight, self.Prediction.bias).float()
        return self.attention_decode(x, text)
