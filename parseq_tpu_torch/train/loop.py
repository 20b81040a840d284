"""Training loop: OneCycle + SWA, validation, top-k checkpoints, resume (port of
parseq_tpu/train/loop.py:train), for every model family.

Eager PyTorch: each loader batch moves to the device as uint8 and is
normalized there; the train step (train/steps.py) splits it into
`trainer.microbatches` equal slices and applies one AdamW update. Every
`val_check_interval` steps the loop validates (accuracy, NED, confidence,
and the family's loss over the val tree: token CE, or per-sample CTC over
the target length for CRNN and TRBC), keeps the top-3 checkpoints by val
accuracy plus `last.ckpt`, and writes the resumable `train_state.ckpt`
(model with its batch-norm statistics, optimizer, step) and the
`swa_state.ckpt` sidecar. `metrics.jsonl` and TensorBoard events record
the run. ABINet trains in stages (abinet/system.py:106-110, 187-203): its
sub-models apart for the first 8/18 of the steps, with the language model
on its own LR, then jointly after one redraw of the alignment weights; or
its language model alone with `model.lm_only`. At the end `swa.ckpt`
holds the SWA average with batch-norm statistics re-estimated for it.

Several devices (parseq_tpu/train/loop.py's mesh): the loop runs on every
rank of a process group (parallel/dist.py; cli/train.py starts the ranks
for trainer.devices, or joins torchrun's under trainer.multihost). The
ranks start from rank 0's state, each loads its share of every global
microbatch, and the step reduces over them, so the math is the one-rank
step's; the LR scales by sqrt(ranks) as the JAX package's by its devices.
Every rank validates the full val set (the same results), rank 0's
val_callback decision holds for all, dropout masks fold in the rank, and
only rank 0 writes (config.json, metrics.jsonl, tb/, checkpoints).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from parseq_tpu_torch.data.module import SceneTextDataModule
from parseq_tpu_torch.ops.ctc import ctc_loss
from parseq_tpu_torch.ops.layers import ce_ignore_pad
from parseq_tpu_torch.parallel import dist
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.evaluate import BatchResult, score_decoded, summarize
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import (init_state, make_train_step, normalize_images,
                                          normalize_u8)
from parseq_tpu_torch.utils.checkpoint import save_checkpoint, save_topk
from parseq_tpu_torch.utils.registry import build_model
from parseq_tpu_torch.utils.tbevents import TBEventWriter

log = logging.getLogger(__name__)

PRETRAIN_FRAC = 8 / 18  # ABINet's pretraining share of the steps (system.py:106-110)

_KNOWN_DATA = {'root_dir', 'train_dir', 'batch_size', 'num_workers', 'augment',
               'remove_whitespace', 'normalize_unicode', 'min_image_dim', 'rotation', 'img_size',
               'charset_train', 'charset_test', 'max_label_length'}
_KNOWN_TRAINER = {'microbatches', 'val_check_interval', 'max_epochs', 'max_steps',
                  'gradient_clip_val', 'devices', 'swa', 'limit_train_batches',
                  'accumulate_grad_batches', 'swa_epoch_start', 'multihost'}


class JsonlLogger:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, **kv):
        with open(self.path, 'a') as f:
            f.write(json.dumps(kv) + '\n')


def _dropout_generator(device, seed, step):
    """Dropout bits of one step come from a generator seeded by (seed, step,
    rank), so a resumed run draws what the uninterrupted run would have and
    no two ranks share masks."""
    key = np.random.SeedSequence([seed, step, dist.rank()]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def train(config: dict, work_dir, *, compute_dtype=torch.bfloat16, max_steps: int | None = None,
          seed: int = 0, device='cuda', val_callback=None):
    """Run training from a composed config dict (utils.config.compose()).

    val_callback, if given, is called after every validation with a metrics
    dict (step, training_iteration, loss, NED, accuracy); returning True
    stops training. Returns (state, best checkpoint path)."""
    device = torch.device(device)
    work_dir = Path(work_dir)
    is_main, n_ranks = dist.is_main(), dist.world_size()
    if is_main:
        work_dir.mkdir(parents=True, exist_ok=True)
        (work_dir / 'config.json').write_text(json.dumps(config, indent=2, default=str))
    mcfg, dcfg, tcfg = config['model'], config['data'], config['trainer']
    name = mcfg.get('name', 'parseq')

    unknown = set(dcfg) - _KNOWN_DATA
    if unknown:
        raise ValueError(f'unknown data config key(s): {sorted(unknown)}; '
                         f'accepted: {sorted(_KNOWN_DATA)}')
    unknown = set(tcfg) - _KNOWN_TRAINER
    if unknown:
        raise ValueError(f'unknown trainer config key(s): {sorted(unknown)}; '
                         f'accepted: {sorted(_KNOWN_TRAINER)}')
    if n_ranks == 1 and tcfg.get('devices', 1) > 1:
        raise ValueError(f'trainer.devices={tcfg["devices"]} asks for {tcfg["devices"]} ranks, '
                         'but this process is in no process group: start the ranks through '
                         'parseq_tpu_torch.cli.train (or torchrun ... trainer.multihost=true)')
    family = get_family(name)

    bundle = build_model(name, mcfg, seed=seed, dtype=compute_dtype, device=device)
    cfg, tok, model = bundle.cfg, bundle.tokenizer, bundle.module
    if config.get('pretrained'):
        from parseq_tpu_torch.utils.registry import load_from_checkpoint

        pre = load_from_checkpoint(config['pretrained'], device=device,
                                   **{k: v for k, v in mcfg.items() if k != 'name'})
        model.load_state_dict(pre.module.state_dict())
        log.info(f'loaded pretrained weights from {config["pretrained"]}')
    dist.broadcast_module(model)
    model.train()

    dm = SceneTextDataModule(
        dcfg.get('root_dir', 'data'), dcfg.get('train_dir', 'real'),
        dcfg.get('img_size', mcfg['img_size']),
        dcfg.get('max_label_length', mcfg['max_label_length']),
        dcfg.get('charset_train', mcfg['charset_train']),
        dcfg.get('charset_test') or mcfg.get('charset_test') or mcfg['charset_train'],
        dcfg.get('batch_size', mcfg.get('batch_size', 384)),
        dcfg.get('num_workers', 2), dcfg.get('augment', True),
        dcfg.get('remove_whitespace', True), dcfg.get('normalize_unicode', True),
        min_image_dim=dcfg.get('min_image_dim', 0), rotation=dcfg.get('rotation', 0),
    )
    mb = max(1, int(tcfg.get('microbatches', 1)))
    train_loader = dm.train_dataloader(seed=seed, shard_rank=dist.rank(), shard_count=n_ranks,
                                       microbatches=mb)
    if len(train_loader) == 0:
        raise ValueError(f'empty training loader: {len(dm.train_dataset)} samples with '
                         f'batch_size={dm.batch_size} (drop_last) yields no batches')
    steps_per_epoch = max(1, int(len(train_loader) * tcfg.get('limit_train_batches', 1.0)))
    # accumulate_grad_batches: one optimizer step per `agb` loader batches;
    # max_steps and val_check_interval count optimizer steps, the loop counts
    # loader batches.
    agb = max(1, int(tcfg.get('accumulate_grad_batches', 1)))
    total_steps = (tcfg.get('max_steps')
                   or max(1, steps_per_epoch // agb) * tcfg.get('max_epochs', 20))
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    total_micro = total_steps * agb
    val_every_micro = tcfg.get('val_check_interval', 1000) * agb

    ocfg = optim.OptimConfig(
        lr=mcfg['lr'], weight_decay=mcfg.get('weight_decay', 0.0),
        warmup_pct=mcfg.get('warmup_pct', 0.075), batch_size=dm.batch_size,
        grad_clip=tcfg.get('gradient_clip_val', 20.0), total_steps=total_steps, num_devices=n_ranks,
        accum=agb, swa=tcfg.get('swa', True), swa_epoch_start=tcfg.get('swa_epoch_start', 0.75))
    state = init_state(model, ocfg, accumulate=agb)
    is_abinet = 'abinet' in name
    lm_only = is_abinet and bool(mcfg.get('lm_only'))
    staged = is_abinet and not lm_only
    if is_abinet:
        state['opt_state'] = optim.make_abinet_optimizer(
            model.named_parameters(), ocfg, float(mcfg.get('l_lr', mcfg['lr'])),
            int(PRETRAIN_FRAC * total_steps))
    params = list(model.parameters())
    ckpt_dir = work_dir / 'checkpoints'

    start_step = 0
    swa_state = None
    resume = config.get('ckpt_path')
    if resume:
        # rank 0 reads the files; every rank resumes from what it read
        saved, swa_state = dist.broadcast_object(_read_resume(resume) if is_main else None)
        model.load_state_dict(saved['model'])
        state['opt_state'].load_state_dict(saved['opt_state'])
        start_step = state['step'] = int(saved['step'])
        if swa_state is not None:
            swa_state['avg'] = [t.to(device) for t in swa_state['avg']]
            log.info(f'resumed SWA average ({swa_state["n"]} snapshots)')
        log.info(f'resumed training state from {resume} at step {start_step}')
    # Clamped to step 1: steps count from 1, so swa_epoch_start=0.0 averages
    # from the first step, not from the never-taken step 0.
    swa_start = max(1, int(ocfg.swa_epoch_start * total_micro)) if ocfg.swa else total_micro

    # keyed by `pretraining`: ABINet's staged training has a step for each stage
    if staged:
        steps_by_phase = {pre: make_train_step(family, cfg, compute_dtype, microbatches=mb,
                                               accumulate=agb, pretraining=pre)
                          for pre in (True, False)}
    else:
        steps_by_phase = {False: make_train_step(family, cfg, compute_dtype, microbatches=mb,
                                                 accumulate=agb,
                                                 **({'lm_only': True} if lm_only else {}))}
    alignment_reset_done = not staged or start_step >= PRETRAIN_FRAC * total_micro
    perm_rng = np.random.default_rng(seed)
    jlog = JsonlLogger(work_dir / 'metrics.jsonl') if is_main else None
    tb = TBEventWriter(work_dir / 'tb') if is_main else None
    pad_id = len(tok) - 1

    def batch_val_loss(logits, logp, labels):
        """The family's loss of one val batch (its first len(labels) rows
        real), as the JAX package's _val_post_ce / _val_post_ctc: (loss, numel)."""
        pad = [''] * (logits.shape[0] - len(labels))
        if family.val == 'ctc':
            targets = torch.from_numpy(tok.encode(labels + pad, cfg.max_label_length)).to(device)
            lengths = torch.from_numpy(tok.lengths(labels + pad, cfg.max_label_length)).to(device)
            per = ctc_loss(logp, targets, lengths, reduction='none') / lengths.clamp(min=1)
            return per[:len(labels)].sum() / max(len(labels), 1), len(labels)
        enc = tok.encode(labels + pad, cfg.max_label_length)[:, 1:logits.shape[1] + 1]
        enc[len(labels):] = pad_id  # padding rows count for nothing
        return ce_ignore_pad(logits, torch.from_numpy(enc).to(device), pad_id, logits.shape[-1])

    def validate():
        model.eval()
        total = BatchResult()
        with torch.inference_mode():
            for images, labels, valid in dm.val_dataloader():
                x = torch.from_numpy(images).to(device)
                if x.dtype == torch.uint8:
                    x = normalize_u8(x)
                logits = model(x, dtype=compute_dtype)
                logp = torch.log_softmax(logits.float(), -1)
                loss, numel = batch_val_loss(logits, logp, labels)
                ids = logp.argmax(-1)  # lowest index on ties, as jnp.argmax
                conf = torch.gather(logp.exp(), -1, ids[..., None])[..., 0]
                preds, pred_probs = tok.decode_ids(ids.cpu().numpy(), conf.cpu().numpy())
                total.add(score_decoded(bundle.charset_adapter, preds, pred_probs, labels, valid,
                                        float(loss), int(numel)))
        model.train()
        return summarize('val', total), total.loss / max(total.loss_numel, 1)

    step = start_step
    t_start = time.time()
    best_path = None
    stop_early = False
    n_validations = 0
    # Resume continues the data stream: same epoch order, consumed batches skipped.
    start_epoch, skip_batches = divmod(start_step, steps_per_epoch)
    log.info(f'training {name}: {total_steps} steps, {steps_per_epoch}/epoch on {device}, '
             f'rank {dist.rank()} of {n_ranks}')
    for epoch in range(start_epoch, 10 ** 9):
        if step >= total_micro or stop_early:
            break
        train_loader.set_epoch(epoch)
        for bi, (images, labels, _) in enumerate(train_loader):
            if step >= total_micro or bi >= steps_per_epoch:
                break
            if epoch == start_epoch and bi < skip_batches:
                continue
            pretraining = staged and step < PRETRAIN_FRAC * total_micro
            if staged and not pretraining and not alignment_reset_done:
                # once, at the switch (system.py:197-201); the optimizer keeps
                # its moments for these parameters, as the JAX package's does
                log.info('ABINet pretraining ends: redrawing the alignment model')
                model.alignment_init(torch.Generator().manual_seed(seed + 1))
                alignment_reset_done = True
            batch = _to_device(family.prepare(tok, labels, cfg, perm_rng), images, device)
            metrics = steps_by_phase[pretraining](state, batch,
                                                  _dropout_generator(device, seed, step))
            step += 1
            if is_main and (step % 50 == 0 or step == start_step + 1):
                loss, gnorm = float(metrics['loss']), float(metrics['grad_norm'])
                lr = state['opt_state'].sched(step // agb)
                jlog.log(step=step, epoch=epoch, loss=loss, grad_norm=gnorm, lr=lr,
                         wall=round(time.time() - t_start, 1))
                tb.add_scalars(step, {'loss': loss, 'grad_norm': gnorm, 'lr': lr})
            if step % val_every_micro == 0 or step == total_micro:
                res, val_loss = validate()
                log.info(f'step {step}: val_acc={res.accuracy:.2f} NED={res.ned:.2f} '
                         f'loss={val_loss:.4f}')
                if is_main:
                    jlog.log(step=step, val_accuracy=res.accuracy, val_NED=res.ned,
                             val_loss=float(val_loss), val_confidence=res.confidence)
                    tb.add_scalars(step, {'val_accuracy': res.accuracy, 'val_NED': res.ned,
                                          'val_loss': float(val_loss),
                                          'hp_metric': res.accuracy})
                    best_path = save_topk(ckpt_dir, step, res.accuracy, model.state_dict(),
                                          cfg, meta={'name': name, 'model_config': mcfg}, k=3)
                    torch.save({'model': model.state_dict(), 'step': step,
                                'opt_state': state['opt_state'].state_dict()},
                               ckpt_dir / 'train_state.ckpt')
                    if swa_state is not None:
                        torch.save(swa_state, ckpt_dir / 'swa_state.ckpt')
                n_validations += 1
                stop = val_callback is not None and bool(val_callback({
                    'step': step, 'training_iteration': n_validations,
                    'loss': float(val_loss), 'NED': res.ned, 'accuracy': res.accuracy}))
                if dist.broadcast_object(stop):  # rank 0's decision: no rank stops alone
                    log.info(f'early stop requested by val_callback at step {step}')
                    stop_early = True
                    break
            if ocfg.swa and step >= swa_start and (step - swa_start) % steps_per_epoch == 0:
                if swa_state is None:
                    swa_state = optim.swa_init(params)
                optim.swa_update(swa_state, params)

    if swa_state is not None and swa_state['n'] > 0:
        final = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            torch._foreach_copy_(params, swa_state['avg'])
        n_bn = reestimate_batchnorm(model, family, cfg, tok, train_loader,
                                    min(steps_per_epoch, 100), perm_rng, compute_dtype,
                                    _dropout_generator(device, seed, 10 ** 9))
        if n_bn:
            log.info(f'SWA: re-estimated batch-norm statistics over {n_bn} batches')
        if is_main:
            save_checkpoint(ckpt_dir / 'swa.ckpt', model.state_dict(), cfg,
                            meta={'name': name, 'model_config': mcfg, 'swa': True})
        model.load_state_dict(final)
    if tb is not None:
        tb.close()
    return state, best_path


def _read_resume(path):
    """The train state at `path` and the SWA sidecar beside it (or None), on
    the CPU."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    swa_path = Path(path).parent / 'swa_state.ckpt'
    swa = torch.load(swa_path, map_location='cpu', weights_only=True) if swa_path.exists() else None
    return saved, swa


def _to_device(prepared, images, device):
    batch = {'images': images, **prepared}
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


@torch.no_grad()
def reestimate_batchnorm(model, family, cfg, tok, loader, n_batches, perm_rng, compute_dtype,
                         rng):
    """Batch-norm running statistics for the weights now in `model` (the SWA
    average), as the JAX package re-estimates them (loop.py:464-497):
    train-mode forwards of the family's loss (no static keywords, dropout
    on) over `n_batches` train batches of a fresh shuffle, each moving the
    statistics by the momentum-0.1 EMA from where they stand (not
    swa_utils.update_bn's reset and cumulative mean); on several ranks each
    forward is of the rank's rows and the statistics the global batch's
    (ops/cnn.py). Returns the batches run: 0 when the model has no batch
    norm."""
    if not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in model.modules()):
        return 0
    device = next(model.parameters()).device
    model.train()
    loader.set_epoch(10 ** 6)  # fresh shuffle, any order works
    n = 0
    for images, labels, _ in loader:
        if n >= n_batches:
            break
        batch = normalize_images(_to_device(family.prepare(tok, labels, cfg, perm_rng), images,
                                            device))
        family.loss(model, cfg, batch, rng, compute_dtype)
        n += 1
    return n
