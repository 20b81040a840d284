"""The benchmark's weights, drawn from the seed on the device in a few large
calls, following each model's own initialisation as its reference module's
`init_kind` names it: truncated normal (std 0.02, cut at 2 std), xavier
uniform for a (D, D) projection or a packed stack of them, N(0, 1e-6) for a
class token, zero biases, unit LayerNorm scales. The same tensors go into
the program and into the reference."""

from __future__ import annotations

import math

import torch

from harness import seeds


def draw(shapes: dict, seed: int, device, kind) -> dict:
    """name -> float32 tensor on `device`, for every name in `shapes`;
    kind(name) -> 'zero' | 'one' | 'tn' | 'xavier' | 'cls'."""
    gen = seeds.generator(seed, 'weights', device)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    by_kind = {}
    for k in shapes:
        by_kind.setdefault(kind(k), []).append(k)
    flat = {}
    n = sum(sizes[k] for k in by_kind.get('tn', []))
    flat['tn'] = torch.nn.init.trunc_normal_(torch.empty(n, device=device), std=0.02, a=-0.04,
                                             b=0.04, generator=gen)
    n = sum(sizes[k] for k in by_kind.get('xavier', []))
    flat['xavier'] = torch.empty(n, device=device).uniform_(-1.0, 1.0, generator=gen)
    n = sum(sizes[k] for k in by_kind.get('cls', []))
    flat['cls'] = torch.empty(n, device=device).normal_(0.0, 1e-6, generator=gen)
    out = {}
    for kd, names in by_kind.items():
        if kd in ('zero', 'one'):
            for k in names:
                out[k] = torch.full(shapes[k], float(kd == 'one'), device=device)
            continue
        start = 0
        for k in names:
            t = flat[kd][start:start + sizes[k]].view(shapes[k])
            start += sizes[k]
            if kd == 'xavier':  # each (D, D) block of q|k|v or out: bound sqrt(6 / 2D)
                t = t * math.sqrt(6.0 / (2 * shapes[k][1]))
            out[k] = t
    return out
