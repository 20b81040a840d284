"""The training recipe of the configuration (strhub/models/base.py,
configs/main.yaml): AdamW after clipping the gradient's global norm, its
learning rate on the OneCycle cosine schedule stepped once an update, on
float32 parameters."""

from __future__ import annotations

import math

import torch


def onecycle_lr(opt, step):
    """The learning rate of update `step` (0 for the first): cosine from
    peak / div_factor up to the peak over the warm-up share of the steps,
    then down to peak / (div_factor * final_div_factor). Peak: lr * batch /
    256 (one device, no accumulation)."""
    peak = opt['lr'] * opt['batch_size'] / 256.0
    total = opt['total_steps']
    warm = int(opt['warmup_pct'] * total)
    start, top = peak / opt['div_factor'], peak
    end = peak / (opt['div_factor'] * opt['final_div_factor'])
    if step < warm:
        a, b, pct = start, top, step / warm
    else:
        a, b, pct = top, end, (step - warm) / (total - warm)
    return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def no_decay(name, shape):
    """Weight decay spares 1-D parameters, embeddings and positional tables."""
    return len(shape) < 2 or any(t in name for t in ('pos_embed', 'pos_queries', 'text_embed'))


class AdamW:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, opt):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Update `params` in place from `grads`; returns the clipped
        gradients (what the moments took in)."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        clip = self.opt['grad_clip']
        factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        lr = onecycle_lr(self.opt, self.count)
        n = self.count + 1
        clipped = {}
        for k, g in grads.items():
            g = g * factor
            clipped[k] = g
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.mu[k] / (1 - self.b1 ** n)) / (
                torch.sqrt(self.nu[k] / (1 - self.b2 ** n)) + self.eps)
            if self.opt['weight_decay'] and not no_decay(k, g.shape):
                upd = upd + self.opt['weight_decay'] * params[k]
            params[k].sub_(lr * upd)
        self.count = n
        return clipped
