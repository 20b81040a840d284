"""CRNN: VGG-style CNN -> 2x BiLSTM -> CTC logits (port of
parseq_tpu/models/crnn.py).

Seven convolutions (batch norm on three of them) with asymmetric max pools
collapse the height to 1; the width becomes the sequence, W/4 + 1 steps.
Parameters carry the reference state_dict names (the keys
parseq_tpu/utils/torch_convert.py:convert_crnn reads): cnn.conv{i},
cnn.batchnorm{i}, rnn.0 and rnn.1 (BidirectionalLSTMs). The computation
goes through the port's ops (ops/cnn.py, ops/rnn.py), never through the
modules' own forward. `module.train()` switches the batch norms to batch
statistics (ops/cnn.py:batchnorm), as the JAX package's `train=True`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch.ops import cnn
from parseq_tpu_torch.ops.ctc import ctc_loss
from parseq_tpu_torch.ops.rnn import BidirectionalLSTM

# (kernel, stride, pad, out_ch, batchnorm) per conv (reference model.py:12-41)
_CONVS = [
    (3, 1, 1, 64, False),
    (3, 1, 1, 128, False),
    (3, 1, 1, 256, True),
    (3, 1, 1, 256, False),
    (3, 1, 1, 512, True),
    (3, 1, 1, 512, False),
    (2, 1, 0, 512, True),
]
# max pools after conv index: {idx: (kernel, stride, pad)}
_POOLS = {
    0: ((2, 2), (2, 2), (0, 0)),
    1: ((2, 2), (2, 2), (0, 0)),
    3: ((2, 2), (2, 1), (0, 1)),
    5: ((2, 2), (2, 1), (0, 1)),
}


@dataclass(frozen=True)
class CRNNConfig:
    """Same fields, defaults and properties as parseq_tpu's CRNNConfig."""

    num_tokens: int = 37  # charset + BLANK
    max_label_length: int = 25
    img_size: tuple[int, int] = (32, 128)
    in_chans: int = 3
    hidden_size: int = 256
    leaky_relu: bool = False

    @property
    def blank_id(self) -> int:
        return 0


@torch.no_grad()
def init_cnn_weights(module: nn.Module, generator: torch.Generator):
    """The JAX package's schemes for the CNN families: He-normal (fan_out,
    relu) convolutions with zero bias; identity batch norm; truncated normal
    (std 0.02, cut at 2 std) linears and embeddings with zero bias; torch's
    uniform init for LSTMs and LSTM cells."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            cout, _, kh, kw = m.weight.shape
            nn.init.normal_(m.weight, std=math.sqrt(2.0 / (cout * kh * kw)), generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            if getattr(m, 'bias', None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LSTM, nn.LSTMCell)):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                nn.init.uniform_(p, -bound, bound, generator=generator)


class CRNN(nn.Module):
    def __init__(self, cfg: CRNNConfig):
        super().__init__()
        assert cfg.img_size[0] % 16 == 0, 'image height must be a multiple of 16'
        self.cfg = cfg
        self.cnn = nn.Module()
        cin = cfg.in_chans
        for i, (k, s, p, cout, bn) in enumerate(_CONVS):
            setattr(self.cnn, f'conv{i}', nn.Conv2d(cin, cout, k, s, p, bias=not bn))
            if bn:
                setattr(self.cnn, f'batchnorm{i}', nn.BatchNorm2d(cout))
            cin = cout
        h = cfg.hidden_size
        self.rnn = nn.Sequential(BidirectionalLSTM(512, h, h),
                                 BidirectionalLSTM(h, h, cfg.num_tokens))

    def init_weights(self, generator: torch.Generator):
        init_cnn_weights(self, generator)

    def forward(self, images, dtype=torch.float32):
        """images (B, H, W, 3) NHWC -> logits (B, W/4 + 1, num_tokens) f32."""
        x = images.to(dtype).permute(0, 3, 1, 2)
        for i, (_, _, _, _, bn) in enumerate(_CONVS):
            x = cnn.conv2d(x, getattr(self.cnn, f'conv{i}'))
            if bn:
                x = cnn.batchnorm(x, getattr(self.cnn, f'batchnorm{i}'))
            x = F.leaky_relu(x, 0.2) if self.cfg.leaky_relu else F.relu(x)
            if i in _POOLS:
                x = cnn.max_pool2d(x, *_POOLS[i])
        B, C, H, W = x.shape
        assert H == 1, f'feature height must be 1, got {H}'
        x = x[:, :, 0].transpose(1, 2)  # (B, W, C)
        for layer in self.rnn:
            x = layer(x)
        return x.float()

    def logits_loss(self, images, targets, target_lengths, dtype=torch.float32):
        """CTC loss of the logits against CTCTokenizer-encoded targets (B, L)
        and their lengths (B,). Returns (logits, loss, batch size)."""
        logits = self(images, dtype)
        loss = ctc_loss(torch.log_softmax(logits, dim=-1), targets, target_lengths,
                        blank=self.cfg.blank_id)
        return logits, loss, images.shape[0]
