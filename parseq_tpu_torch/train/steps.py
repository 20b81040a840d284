"""The train step (port of parseq_tpu/train/steps.py).

Mixed precision as in the JAX package (reference bf16-mixed, train.py:60-64):
parameters, gradients and optimizer state in float32, forward and backward in
the compute dtype (layers cast each f32 weight to it at use), loss and
gradient reduction in float32.

State: {'model': nn.Module (the f32 params), 'opt_state': optim.AdamW,
'step': int (loader micro-steps taken), 'accum': list or None}. The step
updates it in place.

On several ranks (parallel/dist.py) each holds its share of every global
microbatch (data/loader.py:shard_positions) and the step computes what the
JAX package's SPMD step computes over the global batch: each loss divides
by its global count, the gradients are summed over the ranks in one
all-reduce, and batch norms take global statistics (ops/cnn.py).
"""

from __future__ import annotations

import torch

from parseq_tpu_torch.parallel import dist
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.utils import trace


def normalize_u8(x):
    """uint8 -> f32 in [-1, 1] with the host op order ((x/255 - .5)/.5,
    reference module.py:80-81), so values equal the f32 host transform's."""
    return (x.float() / 255.0 - 0.5) / 0.5


def normalize_images(batch):
    """uint8 images -> f32 in [-1, 1] on the device (float input unchanged)."""
    img = batch['images']
    if img.dtype == torch.uint8:
        batch = dict(batch, images=normalize_u8(img))
    return batch


def init_state(model, ocfg: optim.OptimConfig, accumulate=1):
    """Train state for `model` (f32 params) with a fresh AdamW."""
    params = [p for p in model.parameters()]
    return {'model': model, 'opt_state': optim.AdamW(model.named_parameters(), ocfg), 'step': 0,
            'accum': [torch.zeros_like(p) for p in params] if accumulate > 1 else None}


def make_train_step(family, cfg, compute_dtype=torch.bfloat16, microbatches=1, accumulate=1,
                    **static):
    """family: train.families.TrainFamily. Returns
    train_step(state, batch: dict of tensors, rng) -> metrics dict.

    ``microbatches`` > 1 splits the batch into equal slices, sums their
    gradients and divides by the count: equal weights, one optimizer update
    (the reference's 2-GPU DDP gradient semantics, train.py:65-67).
    ``accumulate`` > 1 (trainer.accumulate_grad_batches) applies the update
    on every `accumulate`-th call with the mean of those calls' gradients
    (optax.MultiSteps in the JAX package). rng: a torch.Generator for
    dropout, or None. `static` keywords go to the family's loss (ABINet's
    pretraining / lm_only). A model in train mode moves its batch-norm
    running statistics once per microbatch, in order (the JAX package's
    scan threads them so). Metrics: loss (mean over microbatches), numel
    (the family's count over the global batch, what the losses divide
    by), and grad_norm of this call's gradients, as 0-dim tensors (no host
    sync).

    On N ranks `batch` is the rank's rows. Before the first forward one
    all-reduce sums the family's per-microbatch counts; each rank's loss is
    scaled by N * local / global count (exactly 1 on one rank), so that
    after the gradient all-reduce and the division by N (DDP's mean) every
    rank holds the gradient of the global microbatch losses."""

    def train_step(state, batch, rng):
        with trace.span('train.step', step=state['step']):
            return _step(state, batch, rng)

    def _step(state, batch, rng):
        model = state['model']
        params = [p for p in model.parameters()]
        batch = normalize_images(batch)
        B = batch['images'].shape[0]
        m = microbatches if microbatches > 1 and B % microbatches == 0 else 1
        mb = B // m
        n_ranks = dist.world_size()
        for p in params:
            p.grad = None
        # in the parameters' dtype: float32, or float64 for a float64 model
        loss_sum = torch.zeros((), dtype=params[0].dtype, device=batch['images'].device)
        # per-sample arrays are split; shared ones (the perm set) are not
        mbatches = [{k: v[i * mb:(i + 1) * mb] if v.dim() > 0 and v.shape[0] == B else v
                     for k, v in batch.items()} for i in range(m)]
        # each microbatch's count summed over the ranks; the scales are 1 on one rank
        local = torch.stack([family.count(cfg, mbatch) for mbatch in mbatches]).long()
        total = dist.all_reduce_(local.clone())
        scales = n_ranks * local.double() / total.clamp(min=1).double()
        for i, mbatch in enumerate(mbatches):
            with trace.span('train.forward', device=True, microbatch=i):
                loss, _ = family.loss(model, cfg, mbatch, rng, compute_dtype, **static)
                loss = loss * scales[i].to(loss.dtype)
            with trace.span('train.backward', device=True, microbatch=i):
                loss.backward()
            loss_sum += loss.detach()
        # a parameter the loss does not reach (ABINet's lm_only) has a zero gradient
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        dist.all_reduce_flat_([*grads, loss_sum])
        if m * n_ranks > 1:
            torch._foreach_div_(grads, m * n_ranks)
        state['step'] += 1
        with trace.span('train.optimizer', device=True):
            if state['accum'] is None:
                gnorm = state['opt_state'].step(params, grads)
            else:
                gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                torch._foreach_add_(state['accum'], grads)
                if state['step'] % accumulate == 0:
                    torch._foreach_div_(state['accum'], accumulate)
                    state['opt_state'].step(params, state['accum'])
                    torch._foreach_zero_(state['accum'])
        return {'loss': loss_sum / (m * n_ranks), 'numel': total.sum(), 'grad_norm': gnorm}

    return train_step
