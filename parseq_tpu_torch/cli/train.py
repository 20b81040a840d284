"""Training CLI of the port (counterpart of parseq_tpu/cli/train.py).

Usage:
    python -m parseq_tpu_torch.cli.train [+experiment=parseq] [key=value ...] [--device cuda]

Experiments: parseq, parseq-tiny, parseq-patch16-224, vitstr, crnn, trba,
trbc, abinet, abinet-sv, and tune_abinet-lm (ABINet's language model alone;
also `+experiment=abinet model.lm_only=true`).

Overrides use dotted paths (model.lr=1e-3, data.root_dir=..., trainer.max_steps=...).
`--device` defaults to cuda; without a CUDA device that raises (pass
`--device cpu` to train on the CPU).

Several devices (data parallel, parallel/dist.py):
    python -m parseq_tpu_torch.cli.train +experiment=parseq trainer.devices=N
starts N ranks on this host, one process each (on cuda at most one a card:
N is clamped to the cards there are, and logged; on cpu N gloo processes);
    torchrun --nproc_per_node N -m parseq_tpu_torch.cli.train ... trainer.multihost=true
joins the process group that torchrun's environment describes (one host or
several). model.batch_size is the global batch either way.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from parseq_tpu_torch.parallel import dist
from parseq_tpu_torch.utils.config import compose, parse_cli_overrides

log = logging.getLogger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('overrides', nargs='*', help='dotted config overrides key=value')
    ap.add_argument('--experiment', default=None)
    ap.add_argument('--charset', default=None)
    ap.add_argument('--dataset', default=None)
    ap.add_argument('--work_dir', default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    tokens = []
    experiment = args.experiment
    for tok in args.overrides:
        if tok.startswith('+experiment='):
            experiment = tok.split('=', 1)[1]
        else:
            tokens.append(tok)
    config = compose(experiment, overrides=parse_cli_overrides(tokens),
                     charset=args.charset, dataset=args.dataset)
    name = config['model'].get('name', 'model')
    work_dir = args.work_dir or f'outputs/{name}/{time.strftime("%Y-%m-%d_%H-%M-%S")}'

    from parseq_tpu_torch.train.loop import train

    tcfg = config.setdefault('trainer', {})
    if tcfg.get('multihost'):
        device = dist.init_from_env(torch.device(args.device).type)
        try:
            return train(config, work_dir, seed=args.seed, device=device)
        finally:
            torch.distributed.destroy_process_group()
    n = int(tcfg.get('devices', 1))
    device_type = torch.device(args.device).type
    if n > 1 and device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass --device cpu to train on the CPU')
        if n > torch.cuda.device_count():
            log.info(f'trainer.devices={n}: {torch.cuda.device_count()} cards, so as many ranks')
            n = torch.cuda.device_count()
    tcfg['devices'] = n
    if n == 1:
        return train(config, work_dir, seed=args.seed, device=args.device)
    dist.launch(_train_rank, n, (config, work_dir, args.seed), device_type)
    return None


def _train_rank(device, config, work_dir, seed):
    from parseq_tpu_torch.train.loop import train

    train(config, work_dir, seed=seed, device=device)


if __name__ == '__main__':
    main()
