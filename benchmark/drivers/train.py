"""Training steps through the program's train step.

Set-up builds one train state the way train/loop.py does (the registry's
model in train mode, `init_state`'s AdamW, `make_train_step` of the
family) and drives it from the seed through its first `check_steps` steps,
on batches that all differ: those steps are the warm-up, and the reference
follows them. The same state then runs the window. Each step takes the next
batch of a pool of seeded uint8 images with labels of 1 to 25 characters
(`pool_batches` of them, in a seeded cyclic order), runs the family's host
preparation (`train/families.py`: for PARSeq encoding and permutations),
copies the batch to the device and calls the step with a dropout generator
seeded for that step. The reference follows with the model's
`train_extras`, drawn again from the same seeds.

The traffic file gives `batch`, `microbatches`, `pool_batches`,
`check_steps`, and the traced span (`trace_start`, `trace_steps`). The
configuration's `train` gives the optimizer's settings.

Measured: train_img_s, the images of all steps finished in the window
over the window, which ends in a synchronize.
"""

from __future__ import annotations

import time

import numpy as np

from harness import compare, program, seeds, spec, weights
from harness.context import Outcome
from reference.tokenizer import Ids


def make_data(ctx):
    """The pool: uint8 images (host numpy) and labels of 1 to 25 characters
    of the training charset, and the order the steps take its batches in."""
    import torch

    mcfg, tr = ctx.cell.config['model'], ctx.cell.traffic
    B, P = tr['batch'], tr['pool_batches']
    gen = seeds.generator(ctx.seed, 'images', ctx.device)
    pool = torch.randint(0, 256, (P, B, *mcfg['img_size'], 3), generator=gen,
                         device=ctx.device, dtype=torch.uint8).cpu().numpy()
    rng = np.random.default_rng(seeds.sub(ctx.seed, 'labels'))
    chars = list(mcfg['charset_train'])
    labels = [[''.join(rng.choice(chars, size=rng.integers(1, 26))) for _ in range(B)]
              for _ in range(P)]
    return pool, labels, np.random.default_rng(seeds.sub(ctx.seed, 'order')).permutation(P)


def make_weights(ctx, ref):
    m = ctx.cell.config['model']
    ids = Ids(m['charset_train'])
    return ids, weights.draw(ref.param_shapes(m, ids), ctx.seed, ctx.device, ref.init_kind)


def reference_batches(ctx, ref, steps):
    """The reference's inputs of the steps [(images, labels)]: it works out
    what the program's preparation and step drew (the model's
    `train_extras`) again from the same seeds."""
    import torch

    mcfg = ctx.cell.config['model']
    rng = np.random.default_rng(seeds.sub(ctx.seed, 'perms'))
    return [(torch.as_tensor(images, device=ctx.device), labels,
             ref.train_extras(mcfg, rng, len(labels),
                              seeds.generator(ctx.seed, f'dropout{i}', ctx.device)))
            for i, (images, labels) in enumerate(steps)]


def reference_opt(ctx):
    mcfg, tcfg = ctx.cell.config['model'], ctx.cell.config['train']
    return dict(lr=mcfg['lr'], batch_size=ctx.cell.traffic['batch'],
                weight_decay=mcfg['weight_decay'], warmup_pct=mcfg['warmup_pct'],
                total_steps=tcfg['total_steps'], grad_clip=tcfg['grad_clip'],
                div_factor=tcfg['div_factor'], final_div_factor=tcfg['final_div_factor'])


def run(ctx, tracer):
    import torch
    from parseq_tpu_torch.train import families, optim, steps

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, tcfg = cfg['model'], cfg['train']
    B, dev = tr['batch'], ctx.device
    ref = spec.reference(ctx.cell)
    ids, sd = make_weights(ctx, ref)
    bundle = program.bundle(ctx, sd)
    model, pcfg, tok = bundle.module, bundle.cfg, bundle.tokenizer
    model.train()
    family = families.get_family(cfg['experiment'])
    ocfg = optim.OptimConfig(lr=mcfg['lr'], weight_decay=mcfg['weight_decay'],
                             warmup_pct=mcfg['warmup_pct'], batch_size=B,
                             grad_clip=tcfg['grad_clip'], total_steps=tcfg['total_steps'],
                             swa=tcfg['swa'], swa_epoch_start=tcfg['swa_epoch_start'])
    state = steps.init_state(model, ocfg)
    train_step = steps.make_train_step(family, pcfg, torch.bfloat16,
                                       microbatches=tr['microbatches'])

    pool, labels, order = make_data(ctx)
    P = len(order)
    perm_rng = np.random.default_rng(seeds.sub(ctx.seed, 'perms'))

    def step(i):
        k = int(order[i % P])
        prepared = family.prepare(tok, labels[k], pcfg, perm_rng)
        batch = {name: torch.from_numpy(np.asarray(v)).to(dev, non_blocking=True)
                 for name, v in {'images': pool[k], **prepared}.items()}
        return k, train_step(state, batch, seeds.generator(ctx.seed, f'dropout{i}', dev))

    n_check = tr['check_steps']
    check_k, check_loss = [], []
    for i in range(n_check):
        k, m = step(i)
        check_k.append(k)
        check_loss.append(m['loss'])
        if i == 0:  # the clipped gradient as AdamW took it: mu_1 / (1 - b1)
            opt = state['opt_state']
            grad1 = {n: mu.detach() / (1 - opt.b1)
                     for (n, _), mu in zip(model.named_parameters(), opt.mu)}
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    if dev == 'cuda':
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_process

    tracer.warm()
    t_start = time.perf_counter()
    losses, i = [], n_check
    while time.perf_counter() - t_start < ctx.seconds:
        tracer.tick(i - n_check)
        losses.append(step(i)[1]['loss'])
        i += 1
    if dev == 'cuda':
        torch.cuda.synchronize()
    window = time.perf_counter() - t_start
    tracer.finish()
    n_steps = i - n_check
    finite = int(torch.isfinite(torch.stack(losses)).sum()) if losses else 0
    peak = int(torch.cuda.max_memory_allocated()) if dev == 'cuda' else 0
    metrics = {'train_img_s': (n_steps * B / window, 'img/s'), 'setup_s': (setup_s, 's')}
    layer = {'steps': n_steps, 'batch': B, 'window_s': window}

    got_losses = [float(x) for x in check_loss]
    changes = {n: after[n] - sd[n] for n in after}
    del model, state, bundle, train_step, after
    if dev == 'cuda':
        torch.cuda.empty_cache()
    batches = reference_batches(ctx, ref, [(pool[k], labels[k]) for k in check_k])
    opt_cfg = reference_opt(ctx)
    ref_losses, ref_grads, ref_after = compare.reference_steps(ref, sd, mcfg, ids, batches,
                                                               opt_cfg)
    ref_changes = {n: ref_after[n] - sd[n] for n in ref_after}
    readings, detail = compare.train_readings(got_losses, grad1, changes, ref_losses,
                                              ref_grads, ref_changes)
    ctx.keep.update(detail, losses=got_losses, ref_losses=ref_losses)
    return Outcome(attempted=n_steps, failed=n_steps - finite, metrics=metrics,
                   readings=readings, layer=layer, memory_peak_bytes=peak,
                   notes=[f'steps: {n_steps} of {B} in {window:.3f} s; check steps '
                          f'{n_check}: losses {got_losses}, reference {ref_losses}; '
                          f'worst leaves {detail["grad_gap_leaf"]}, {detail["change_gap_leaf"]}'])
