"""LSTM layers as explicit step loops (port of parseq_tpu/ops/rnn.py).

torch nn.LSTM math, gate order (i, f, g, o), zero initial state. The input
projection of all timesteps is one product; only the recurrent h @ Whh
runs per step, in a Python loop. The rounding points are the JAX
package's: the projection, the gates, c and h are all in the compute
dtype (x's), the f32 weights cast to it at each use.

`BidirectionalLSTM` holds an nn.LSTM named `rnn` and an nn.Linear named
`linear`, so reference state_dicts load (rnn.weight_ih_l0, ..._reverse),
but its forward runs the loop on those parameters, never nn.LSTM.forward:
torch's FLOP counter sees no products inside cuDNN's LSTM, and cuDNN
rounds elsewhere in bf16. Routing to cuDNN is a measured change of its own
(ROADMAP).
"""

from __future__ import annotations

import torch
from torch import nn

from parseq_tpu_torch.ops.layers import linear


def lstm_cell(x_proj, h, c, weight_hh, bias_hh):
    """One step. x_proj = x @ W_ih^T + b_ih, precomputed. Returns (h, c)."""
    gates = x_proj + h @ weight_hh.to(h.dtype).t() + bias_hh.to(h.dtype)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    return o * torch.tanh(c), c


def lstm(x, weight_ih, weight_hh, bias_ih, bias_hh, *, reverse=False):
    """x (B, T, D) -> outputs (B, T, H); torch-layout weights (4H, D), (4H, H)."""
    B, T, _ = x.shape
    H = weight_hh.shape[1]
    x_proj = linear(x, weight_ih, bias_ih)  # (B, T, 4H)
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        h, c = lstm_cell(x_proj[:, t], h, c, weight_hh, bias_hh)
        out[t] = h
    return torch.stack(out, dim=1)


class BidirectionalLSTM(nn.Module):
    """Reference BidirectionalLSTM (a one-layer biLSTM, then a linear
    projection of the concatenated directions)."""

    def __init__(self, input_size, hidden_size, output_size):
        super().__init__()
        self.rnn = nn.LSTM(input_size, hidden_size, bidirectional=True, batch_first=True)
        self.linear = nn.Linear(2 * hidden_size, output_size)

    def forward(self, x):
        r = self.rnn
        fwd = lstm(x, r.weight_ih_l0, r.weight_hh_l0, r.bias_ih_l0, r.bias_hh_l0)
        bwd = lstm(x, r.weight_ih_l0_reverse, r.weight_hh_l0_reverse, r.bias_ih_l0_reverse,
                   r.bias_hh_l0_reverse, reverse=True)
        return linear(torch.cat([fwd, bwd], dim=-1), self.linear.weight, self.linear.bias)
