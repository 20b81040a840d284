"""Training CLI of the port (counterpart of parseq_tpu/cli/train.py).

Usage:
    python -m parseq_tpu_torch.cli.train [+experiment=parseq] [key=value ...] [--device cuda]

Experiments: parseq, parseq-tiny, parseq-patch16-224, vitstr, crnn, trba,
trbc, abinet, abinet-sv, and tune_abinet-lm (ABINet's language model alone;
also `+experiment=abinet model.lm_only=true`).

Overrides use dotted paths (model.lr=1e-3, data.root_dir=..., trainer.max_steps=...).
`--device` defaults to cuda; without a CUDA device that raises (pass
`--device cpu` to train on the CPU).
"""

from __future__ import annotations

import argparse
import logging
import time

from parseq_tpu_torch.utils.config import compose, parse_cli_overrides


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

    return train(config, work_dir, seed=args.seed, device=args.device)


if __name__ == '__main__':
    main()
