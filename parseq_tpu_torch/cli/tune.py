"""Learning-rate search of the PyTorch port (counterpart of
parseq_tpu/cli/tune.py; reference tune.py equivalent, no Ray/Ax).

Synchronous successive halving over a log-spaced LR seed grid (like the
reference's AxSearch `points_to_evaluate`, tune.py:157-163), with the
reference's two early-stopping rules running within every trial, at each
validation of `train(..., val_callback=...)`:

- `MedianStoppingRule` (reference tune.py:155): stop a trial whose best
  metric so far falls below the median of the running averages of all other
  trials at the same training iteration, after a grace period.
- `MetricTracker` (reference tune.py:42-91): Gaussian-smoothed moving-average
  gradient of val NED; stop when the trend is downward/stagnant for
  `patience` consecutive validations, or on NaN loss, or at max_t.

Each trial trains from its config with `model.lr` set to the trial's LR.

Usage:
    python -m parseq_tpu_torch.cli.tune [+experiment=parseq] [key=value ...]
        [--num_samples 10] [--rung_steps 500] [--rungs 3] [--lr_min 1e-4]
        [--lr_max 2e-3] [--work_dir DIR] [--device cuda|cpu]

Defaults come from configs/tune.yaml. The default device is cuda; with no
GPU the command fails unless --device cpu is given. Writes one directory a
trial and `results.json` (each trial's LR, validation metrics and wall
seconds) under the work directory, and prints the best LR as a JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from parseq_tpu_torch.utils.config import CONFIG_ROOT, _load, compose, parse_cli_overrides

log = logging.getLogger(__name__)


def lr_grid(lo, hi, n):
    """Log-spaced seed points (reference tune.py:157-163)."""
    return list(np.exp(np.linspace(np.log(lo), np.log(hi), n)))


class MetricTracker:
    """Trend-based stopper: Gaussian-smoothed MA gradient of a maximized metric.

    Reference tune.py:42-91 semantics: keep a FIFO of the last
    `patience + buffer` metric values per trial; once full (and any value
    nonzero), convolve with a Gaussian kernel (sigma=0.6, width=window),
    take the discrete gradient, discard the edge values, and stop if every
    remaining gradient sample is below eps (downward or stagnant trend).
    Also stops on NaN loss and at max_t training iterations.
    """

    def __init__(self, metric='NED', max_t=10 ** 9, patience=3, window=3):
        self.metric = metric
        self.trial_history: dict = {}
        self.max_t = max_t
        self.eps = 0.01
        self.patience = patience
        x = np.arange(window) - window // 2
        sigma = 0.6
        self.kernel = np.exp(-((x / sigma) ** 2) / 2) / (sigma * np.sqrt(2 * np.pi))
        self.buffer = 2 * (len(self.kernel) // 2) + 2

    @staticmethod
    def moving_average(x, k):
        return np.convolve(x, k, 'valid') / k.sum()

    def __call__(self, trial_id, result) -> bool:
        if np.isnan(result['loss']) or result['training_iteration'] >= self.max_t:
            self.trial_history.pop(trial_id, None)
            return True
        history = self.trial_history.get(trial_id, [])
        history = history[-(self.patience + self.buffer - 1):] + [result[self.metric]]
        if len(history) == self.patience + self.buffer and sum(history) > 0:
            smooth_grad = np.gradient(self.moving_average(history, self.kernel))[1:-1]
            if (smooth_grad < self.eps).all():
                log.info(f'MetricTracker stopping {trial_id}: hist={history} grad={smooth_grad}')
                self.trial_history.pop(trial_id, None)
                return True
        self.trial_history[trial_id] = history
        return False


class MedianStoppingRule:
    """Stop a trial doing worse than the median of its peers at the same time.

    Ray's scheduler of the same name (reference tune.py:155,
    `MedianStoppingRule(time_attr='training_iteration', grace_period=warmup_t)`):
    at iteration t (past the grace period, with >= min_samples_required peer
    trials on record), compare the trial's *best* metric so far against the
    median over other trials of their running average up to iteration t; stop
    if strictly below. Trials run one after another here, so a trial is
    compared against all trials run before it.
    """

    def __init__(self, grace_period=0, min_samples_required=3):
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.results: dict = {}  # trial_id -> [(iteration, value), ...]

    def on_result(self, trial_id, iteration, value) -> bool:
        self.results.setdefault(trial_id, []).append((iteration, value))
        if iteration < self.grace_period:
            return False
        peers = [h for tid, h in self.results.items() if tid != trial_id]
        running_avgs = [np.mean([v for it, v in h if it <= iteration])
                        for h in peers if any(it <= iteration for it, v in h)]
        if len(running_avgs) < self.min_samples:
            return False
        best = max(v for _, v in self.results[trial_id])
        if best < np.median(running_avgs):
            log.info(f'MedianStoppingRule stopping {trial_id}: best={best:.4f} '
                     f'< median={np.median(running_avgs):.4f} at t={iteration}')
            return True
        return False


def run_trial(config, lr, steps, work_dir, *, trial_id=None, stoppers=(), seed=0,
              device='cuda'):
    """Train `steps` steps of `config` at `lr` (model.lr) into `work_dir`;
    the stoppers see every validation when `trial_id` is given. Returns the
    last validation's metrics, whether a stopper ended the trial, and the
    trial's wall seconds."""
    from parseq_tpu_torch.train.loop import train

    cfg = copy.deepcopy(config)
    cfg['model']['lr'] = float(lr)
    stopped = {'early': False}

    def val_callback(result):
        stop = any(
            (s.on_result(trial_id, result['training_iteration'], result['NED'])
             if isinstance(s, MedianStoppingRule) else s(trial_id, result))
            for s in stoppers)
        stopped['early'] = stopped['early'] or stop
        return stop

    t0 = time.perf_counter()
    train(cfg, work_dir, max_steps=steps, seed=seed, device=device,
          val_callback=val_callback if trial_id is not None else None)
    wall = time.perf_counter() - t0
    # the last validation's metrics, from the jsonl log
    with open(Path(work_dir) / 'metrics.jsonl') as f:
        vals = [m for m in map(json.loads, f) if 'val_NED' in m]
    if not vals:
        return {'lr': lr, 'val_NED': 0.0, 'val_accuracy': 0.0, 'val_loss': float('inf'),
                'stopped_early': stopped['early'], 'wall_s': wall}
    last = vals[-1]
    return {'lr': lr, 'val_NED': last['val_NED'], 'val_accuracy': last['val_accuracy'],
            'val_loss': last['val_loss'], 'stopped_early': stopped['early'], 'wall_s': wall}


def _tune_defaults():
    """Composable defaults from configs/tune.yaml (reference configs/tune.yaml)."""
    try:
        cfg = _load(CONFIG_ROOT / 'tune.yaml')
    except OSError:
        cfg = {}
    return cfg.get('tune', {}) or {}


def main(argv=None):
    d = _tune_defaults()
    ap = argparse.ArgumentParser()
    ap.add_argument('overrides', nargs='*')
    ap.add_argument('--experiment', default=None)
    ap.add_argument('--num_samples', type=int, default=d.get('num_samples', 8))
    ap.add_argument('--rung_steps', type=int, default=d.get('rung_steps', 500))
    ap.add_argument('--rungs', type=int, default=d.get('rungs', 3))
    ap.add_argument('--lr_min', type=float, default=float((d.get('lr') or {}).get('min', 1e-4)))
    ap.add_argument('--lr_max', type=float, default=float((d.get('lr') or {}).get('max', 2e-3)))
    ap.add_argument('--work_dir', default=d.get('resume_dir'))
    ap.add_argument('--patience', type=int, default=d.get('patience', 3),
                    help='MetricTracker patience (validations of flat/down trend)')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')
    logging.basicConfig(level=logging.INFO)
    tokens, experiment = [], args.experiment
    for tok in args.overrides:
        if tok.startswith('+experiment='):
            experiment = tok.split('=', 1)[1]
        else:
            tokens.append(tok)
    config = compose(experiment, overrides=parse_cli_overrides(tokens))
    # validate frequently enough that every rung reports
    config['trainer']['val_check_interval'] = min(
        config['trainer'].get('val_check_interval', 1000), args.rung_steps)
    val_interval = config['trainer']['val_check_interval']

    root = Path(args.work_dir or f'ray_results/{config["model"].get("name", "model")}/'
                                 f'{time.strftime("%Y-%m-%d_%H-%M-%S")}')
    root.mkdir(parents=True, exist_ok=True)

    # Grace period = warmup validations (reference tune.py:154: warmup_pct of
    # total validations); trend stopper caps at 75% of total (tune.py:153).
    # Stoppers are rebuilt per rung from that rung's validation budget, so
    # rung-0 trials do not sit wholly inside the grace period and trials are
    # not compared across rungs at different horizons.
    warmup_pct = config['model'].get('warmup_pct', 0.075)
    candidates = lr_grid(args.lr_min, args.lr_max, args.num_samples)
    steps = args.rung_steps
    results = []
    for rung in range(args.rungs):
        rung_val_iters = max(1, steps // val_interval)
        median_rule = MedianStoppingRule(
            grace_period=max(1, round(warmup_pct * rung_val_iters)))
        tracker = MetricTracker('NED', max_t=max(2, round(0.75 * rung_val_iters)),
                                patience=args.patience)
        scored = []
        for i, lr in enumerate(candidates):
            tdir = root / f'rung{rung}_trial{i}_lr{lr:.2e}'
            log.info(f'rung {rung}: trial lr={lr:.3e} for {steps} steps on {args.device}')
            res = run_trial(config, lr, steps, tdir, trial_id=f'r{rung}t{i}',
                            stoppers=(median_rule, tracker), device=args.device)
            log.info(f'  -> val_NED={res["val_NED"]:.3f} acc={res["val_accuracy"]:.3f} '
                     f'in {res["wall_s"]:.1f} s'
                     + (' (stopped early)' if res['stopped_early'] else ''))
            scored.append(res)
            results.append({'rung': rung, 'steps': steps, **res})
        scored.sort(key=lambda r: r['val_NED'], reverse=True)
        keep = max(1, len(scored) // 2)
        candidates = [r['lr'] for r in scored[:keep]]
        steps *= 2
        if len(candidates) == 1:
            break

    best = max(results, key=lambda r: (r['rung'], r['val_NED']))
    (root / 'results.json').write_text(json.dumps(results, indent=2))
    print(json.dumps({'best_lr': best['lr'], 'val_NED': best['val_NED'],
                      'val_accuracy': best['val_accuracy']}))


if __name__ == '__main__':
    main()
