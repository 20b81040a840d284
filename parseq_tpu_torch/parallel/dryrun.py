"""N ranks against one rank (counterpart of __graft_entry__.dryrun_multichip).

`run_ranks` runs a function on N ranks of this host and returns what each
rank returned; `rank_step` (`rank_steps` for several) is one train step on
the calling rank's rows of a global batch, so the same call on N ranks and
on one compares the multi-rank step with the one-rank step
(`compare_steps`). `planted` plants, in the calling process, each fault
those comparisons must catch. `dryrun_multichip(n)` holds a tiny PARSeq
step's loss and five eval-metric sums on n gloo processes to one process,
at the JAX package's bar.
"""

from __future__ import annotations

import contextlib
import copy
import tempfile
from pathlib import Path

import numpy as np
import torch

from parseq_tpu_torch.data.loader import shard_positions
from parseq_tpu_torch.parallel import dist

RTOL = 2e-5  # the JAX package's bar for N devices against one (tests/test_train_loop.py)

# fault -> (the dist function it replaces, the replacement)
_FAULTS = {
    # the step's gradient all-reduce skipped
    'no_allreduce': ('all_reduce_flat_', lambda tensors: tensors),
    # batch-norm sums over the rank's own rows
    'local_batchnorm': ('sum_over_ranks', lambda x: x),
    # every rank takes its own counts for the other ranks' too: each loss is
    # the rank's own mean, and the step the mean of the ranks' means
    'local_count': ('all_reduce_', lambda x: x.mul_(dist.world_size())),
}


def run_ranks(n, fn, args=(), device_type='cpu'):
    """[fn(device, *args) of rank r for r < n], each on a rank of its own."""
    with tempfile.TemporaryDirectory(prefix='ranks-') as tmp:
        dist.launch(_collect, n, (fn, args, tmp), device_type)
        # written by the ranks above, so safe to unpickle
        return [torch.load(Path(tmp) / f'{r}.pt', weights_only=False) for r in range(n)]


def _collect(device, fn, args, tmp):
    torch.save(fn(device, *args), Path(tmp) / f'{dist.rank()}.pt')


@contextlib.contextmanager
def planted(fault):
    """While open, in this process: 'no_allreduce' skips the step's gradient
    all-reduce; 'local_batchnorm' takes batch-norm statistics over the
    rank's rows alone; 'local_count' divides each rank's loss by its own
    count (a mean of per-rank means, DDP's usual slip). None plants nothing."""
    if fault is None:
        yield
        return
    name, fake = _FAULTS[fault]
    real = getattr(dist, name)
    setattr(dist, name, fake)
    try:
        yield
    finally:
        setattr(dist, name, real)


def rank_step(device, family, model, batch, microbatches=1, dtype=torch.float32, static=None,
              fault=None):
    """One train step (LR 0, no dropout) of a copy of `model` (in train mode,
    in `dtype`) on this rank's rows of the global numpy `batch`
    (shard_positions; arrays whose leading dimension is not the batch's are
    shared). Returns {'loss', 'grad_norm', 'numel', 'grads': {parameter:
    float64 CPU tensor}, 'stats': {batch-norm running statistic: float64 CPU
    tensor}}."""
    from parseq_tpu_torch.train.families import get_family
    from parseq_tpu_torch.train.optim import OptimConfig
    from parseq_tpu_torch.train.steps import init_state, make_train_step

    model = copy.deepcopy(model).to(device=device, dtype=dtype).train()
    B = batch['images'].shape[0]
    rows = shard_positions(B, microbatches, dist.rank(), dist.world_size())
    local = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v[rows] if v.shape[:1] == (B,) else v)).to(device)
        local[k] = t.to(dtype) if t.is_floating_point() else t
    state = init_state(model, OptimConfig(total_steps=100, batch_size=B))
    state['opt_state'].sched = lambda _: 0.0  # the weights stay; the gradients are compared
    step = make_train_step(get_family(family), model.cfg, dtype, microbatches=microbatches,
                           **(static or {}))
    with planted(fault):
        m = step(state, local, None)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'numel': int(m['numel']),
            'grads': {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu()
                      for n, p in model.named_parameters()},
            'stats': {n: b.double().cpu() for n, b in model.named_buffers()
                      if n.endswith(('running_mean', 'running_var'))}}


def rank_steps(device, jobs):
    """[rank_step(device, **job) for job in jobs]: many steps for one start
    of the ranks."""
    return [rank_step(device, **job) for job in jobs]


def compare_steps(got, want):
    """Distances of rank_step result `got` from `want`: the loss's and the
    grad norm's relative difference, the worst gradient difference relative
    to its parameter's largest gradient (with the parameter's name), and the
    worst batch-norm statistic difference relative to its largest value."""
    worst = (0.0, '')
    for n, g in want['grads'].items():
        err = float((got['grads'][n] - g).abs().max()) / max(float(g.abs().max()), 1e-300)
        worst = max(worst, (err, n))
    stats = max([float((got['stats'][n] - s).abs().max()) / max(float(s.abs().max()), 1e-300)
                 for n, s in want['stats'].items()] or [0.0])
    return {'loss': abs(got['loss'] - want['loss']) / abs(want['loss']),
            'grad_norm': abs(got['grad_norm'] - want['grad_norm']) / want['grad_norm'],
            'grad': worst, 'stats': stats}


def _tiny_parseq():
    from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig

    cfg = PARSeqConfig(num_tokens=13, max_label_length=7, img_size=(16, 32), patch_size=(4, 8),
                       embed_dim=32, enc_num_heads=2, enc_depth=2, dec_num_heads=4, dec_depth=1,
                       dropout=0.0)
    model = PARSeq(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _eval_sums(logits, targets, pad_id):
    """The five eval-metric sums of __graft_entry__.dryrun_multichip."""
    valid = targets != pad_id
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    ids = logits.argmax(-1)
    seq_ok = ((ids == targets) | ~valid).all(-1)
    conf = torch.exp((torch.gather(logp, -1, ids[..., None])[..., 0] * valid).sum(-1))
    return torch.stack([valid.any(-1).sum().float(), seq_ok.sum().float(),
                        valid.sum().float(), (nll * valid).sum(), conf.sum()])


def _dryrun_rank(device, model, batch, logits, targets):
    out = rank_step(device, 'parseq', model, batch)
    B, n, r = logits.shape[0], dist.world_size(), dist.rank()
    rows = slice(r * B // n, (r + 1) * B // n)  # validation rows: each rank a contiguous part
    sums = _eval_sums(torch.from_numpy(logits[rows]), torch.from_numpy(targets[rows]),
                      model.cfg.pad_id)
    return out['loss'], dist.all_reduce_(sums).tolist()


def dryrun_multichip(n: int) -> None:
    """A tiny PARSeq train step on n gloo processes (each its rows of a
    batch of 2n) against the same step in this process: the losses within
    RTOL; then eval metrics (samples, correct, tokens, loss sum, confidence
    sum) of random logits, each rank scoring its rows and the sums
    all-reduced, against this process scoring all rows."""
    model = _tiny_parseq()
    cfg, B = model.cfg, 2 * n
    rng = np.random.default_rng(0)
    from parseq_tpu_torch.models.parseq import gen_tgt_perms

    batch = {'images': rng.uniform(0, 1, (B, *cfg.img_size, 3)).astype(np.float32),
             'tgt': rng.integers(0, cfg.num_tokens, (B, cfg.max_label_length + 2)),
             'perms': gen_tgt_perms(np.random.default_rng(0), cfg)}
    T = cfg.max_label_length + 1
    logits = rng.standard_normal((B, T, cfg.num_tokens)).astype(np.float32)
    targets = rng.integers(0, cfg.num_tokens, (B, T))

    (loss_n, sums_n), *_ = run_ranks(n, _dryrun_rank, (model, batch, logits, targets))
    loss_1, sums_1 = _dryrun_rank(torch.device('cpu'), model, batch, logits, targets)
    if not np.isfinite(loss_n):
        raise AssertionError('non-finite training loss in the dry run')
    np.testing.assert_allclose(loss_n, loss_1, rtol=RTOL,
                               err_msg=f'{n}-rank loss diverged from the 1-rank loss')
    np.testing.assert_allclose(sums_n, sums_1, rtol=RTOL,
                               err_msg=f'{n}-rank eval-metric sums diverged from 1 rank')
