"""Optimizer, LR schedule and SWA average (port of parseq_tpu/train/optim.py).

Reference recipe (strhub/models/base.py:98-107): AdamW with effective LR =
lr * accum * sqrt(num_devices) * batch_size / 256, OneCycleLR (cosine,
pct_start=warmup_pct) stepped per optimizer step, gradient clipping by
global norm (20 in configs/main.yaml), and weight decay excluded for 1-D
params and pos_embed / pos_queries / text_embed. SWA: from swa_epoch_start
of training the LR is a constant swa_lr taken from the OneCycle cosine tail,
and the train loop keeps a uniform running average of the weights.

`AdamW` follows the JAX package's optax chain exactly:
clip_by_global_norm -> scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, bias
correction, eps outside the sqrt) -> add_decayed_weights (masked) ->
scale by -lr(count), with count the number of updates already applied.
The update runs as torch._foreach_* operations (a few multi-tensor kernels
per step rather than a dozen launches per parameter).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 7e-4
    weight_decay: float = 0.0
    warmup_pct: float = 0.075
    batch_size: int = 384
    grad_clip: float = 20.0
    total_steps: int = 169_680
    num_devices: int = 1
    accum: int = 1
    # OneCycleLR torch defaults
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    swa: bool = True
    swa_epoch_start: float = 0.75


def scaled_lr(cfg: OptimConfig) -> float:
    """base.py:100-102 linear/sqrt scaling rule."""
    return cfg.lr * cfg.accum * math.sqrt(cfg.num_devices) * cfg.batch_size / 256.0


def _annealing_cos(start, end, pct):
    """Cosine interpolation from start to end (train.py:37-40)."""
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def swa_lr(cfg: OptimConfig) -> float:
    """LR value of the OneCycle cosine tail at the SWA start point
    (train.py:43-50: anneal from peak over the post-warmup span)."""
    lr = scaled_lr(cfg)
    return _annealing_cos(lr, lr / cfg.final_div_factor,
                          (cfg.swa_epoch_start - cfg.warmup_pct) / (1 - cfg.warmup_pct))


def onecycle_schedule(cfg: OptimConfig):
    """step -> LR: optax.cosine_onecycle_schedule's curve (boundaries floored
    to whole steps, cosine between the accumulated values peak/div, peak,
    peak/(div*final_div)), with the warmup kept at least one step wide for
    tiny runs, and the constant SWA tail from int(swa_epoch_start * total)."""
    peak = scaled_lr(cfg)
    total = max(int(cfg.total_steps), 2)
    # optax floors the warmup boundary to int(pct_start * total); for tiny
    # runs that collapses the warmup interval to zero width (NaN LR). Keep
    # both phases at least one step wide — a no-op at production step counts.
    pct = min(max(cfg.warmup_pct, 1.0 / total), (total - 1.0) / total)
    bounds = (0, int(pct * total), total)
    init = peak / cfg.div_factor
    values = (init, peak, peak / (cfg.div_factor * cfg.final_div_factor))
    swa_start = int(cfg.swa_epoch_start * cfg.total_steps)
    const = swa_lr(cfg) if cfg.swa else None

    def sched(step):
        step = int(step)
        if cfg.swa and step >= swa_start:
            return const
        for k in range(2):
            if bounds[k] <= step < bounds[k + 1]:
                return _annealing_cos(values[k], values[k + 1],
                                      (step - bounds[k]) / (bounds[k + 1] - bounds[k]))
        return values[-1]

    return sched


def decay_mask(named_params):
    """True where weight decay applies: >= 2-D weights, excluding embeddings
    and positional tables (timm create_optimizer_v2 + no_weight_decay())."""
    return [p.dim() >= 2 and not any(t in name for t in ('pos_embed', 'pos_queries', 'text_embed'))
            for name, p in named_params]


class AdamW:
    """AdamW after global-norm clipping, with the OneCycle (+ SWA) schedule.

    `step(params, grads)` updates the f32 params in place and returns the
    global norm of `grads` before clipping (a 0-dim tensor, no host sync).
    `sched_of(name)`, if given, names another schedule (step -> LR) for a
    parameter, or None for the main one; clipping stays one global norm."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, named_params, cfg: OptimConfig, sched_of=None):
        named_params = list(named_params)
        self.cfg = cfg
        self.sched = onecycle_schedule(cfg)
        # schedule -> indices of the parameters it drives
        self.groups = {}
        for i, (name, _) in enumerate(named_params):
            sched = (sched_of(name) if sched_of else None) or self.sched
            self.groups.setdefault(sched, []).append(i)
        self.decay = decay_mask(named_params) if cfg.weight_decay else [False] * len(named_params)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for _, p in named_params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for _, p in named_params]
        self.count = 0  # updates applied so far

    @torch.no_grad()
    def step(self, params, grads):
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax clip_by_global_norm: unchanged below the limit, else g * max / norm
        clip = self.cfg.grad_clip
        factor = torch.where(gnorm < clip, torch.ones_like(gnorm), clip / gnorm)
        g = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        n = self.count + 1
        denom = torch._foreach_div(self.nu, 1 - self.b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1 - self.b1 ** n)
        torch._foreach_div_(upd, denom)
        if any(self.decay):
            idx = [i for i, d in enumerate(self.decay) if d]
            torch._foreach_add_([upd[i] for i in idx], [params[i] for i in idx],
                                alpha=self.cfg.weight_decay)
        for sched, idx in self.groups.items():
            torch._foreach_add_([params[i] for i in idx], [upd[i] for i in idx],
                                alpha=-sched(self.count))
        self.count = n
        return gnorm

    def state_dict(self):
        return {'mu': self.mu, 'nu': self.nu, 'count': self.count}

    def load_state_dict(self, state):
        for dst, src in zip(self.mu + self.nu, list(state['mu']) + list(state['nu'])):
            dst.copy_(src)
        self.count = int(state['count'])


def make_abinet_optimizer(named_params, cfg: OptimConfig, l_lr: float, pretrain_end: int):
    """ABINet's AdamW (parseq_tpu/train/optim.py:make_abinet_optimizer): the
    language model's parameters (`language.*`) follow the OneCycle of `l_lr`
    until optimizer step `pretrain_end`, then the main schedule; all others
    follow the main schedule (the AdamW's `sched`)."""
    main = onecycle_schedule(cfg)
    l_base = onecycle_schedule(dataclasses.replace(cfg, lr=l_lr))

    def l_sched(step):
        return l_base(step) if step < pretrain_end else main(step)

    return AdamW(named_params, cfg,
                 lambda name: l_sched if name.startswith('language.') else None)


def swa_init(params):
    return {'avg': [torch.zeros_like(p, dtype=torch.float32) for p in params], 'n': 0}


@torch.no_grad()
def swa_update(swa_state, params):
    """Uniform running average: avg_{n+1} = avg_n + (p - avg_n)/(n+1)."""
    n = swa_state['n']
    diff = torch._foreach_sub([p.float() for p in params], swa_state['avg'])
    torch._foreach_div_(diff, n + 1)
    torch._foreach_add_(swa_state['avg'], diff)
    swa_state['n'] = n + 1
    return swa_state
