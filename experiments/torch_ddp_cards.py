"""PARSeq-S trained on several cards, a rank each (NCCL), against one card.

    python experiments/torch_ddp_cards.py [--ranks 4]

Needs --ranks CUDA cards on one host. Builds the kernels, then
runs chip_smoke.py's phase-11 pieces with a card a rank:

1. ranks_math: one PARSeq-S and one CRNN step (dropout 0, a numpy batch of
   16 in 2 microbatches) on the ranks against one rank, in float64 and f32
   (TF32 off), within chip_smoke.RANK_LIMITS, each planted fault failing
   them;
2. ranks_train: PARSeq-S (+experiment=parseq: global batch 384, 8
   microbatches, bf16) through cli.train with torchrun's environment, on
   the ranks and on one rank, chip_smoke.RANK_STEPS steps each on the
   smoke's synthetic LMDB: step ms a rank (median of the steps after the
   first), img/s (the global batch over it), peak memory, launches, the
   parameters hashed alike, rank 0 alone writing;
3. cli.train trainer.devices=N, the CLI spawning the ranks itself: one
   writer of metrics.jsonl and checkpoints.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from experiments.torch_encoder_kernel_bench import card_line  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ranks', type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        raise SystemExit(f'{args.ranks} CUDA cards needed, '
                         f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} here')
    from parseq_tpu_torch.cli import train as train_cli
    from parseq_tpu_torch.ops import ar_kernel, attention, encoder_kernel, flash_bwd
    from parseq_tpu_torch.utils.config import compose

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda build: build(), (ar_kernel.library, attention.library,
                                              flash_bwd.library, encoder_kernel.library)))
    card = card_line()
    rng = np.random.default_rng(smoke.SEED + 14)
    root = ROOT / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='ddp-cards-', dir=root))
    out = {'card': card, 'ranks': args.ranks, 'cards': torch.cuda.device_count()}
    try:
        out['math'] = smoke.ranks_math(args.ranks, tmp / 'math', rng, 'math')
        batch = compose('parseq')['model']['batch_size']
        smoke.write_train_lmdb(tmp / 'data', rng, compose('parseq')['model']['charset_train'])
        for n in (args.ranks, 1):
            info = smoke.ranks_train(card, n, tmp / 'data', tmp / f'train{n}', rng,
                                     f'{n} rank(s)', ', a card a rank')
            step = float(np.median(info['rank_step_ms']))
            out[f'train_{n}'] = {**info, 'step_ms': step, 'img_per_s': batch / step * 1e3}
        out['speedup'] = out[f'train_{args.ranks}']['img_per_s'] / out['train_1']['img_per_s']
        t0 = time.perf_counter()
        train_cli.main(['+experiment=parseq', f'data.root_dir={tmp / "data"}',
                        f'trainer.max_steps={smoke.RANK_STEPS}',
                        f'trainer.val_check_interval={smoke.RANK_STEPS}',
                        f'trainer.devices={args.ranks}', f'--work_dir={tmp / "spawned"}',
                        f'--seed={smoke.SEED}', '--device', 'cuda'])
        metrics = [json.loads(line) for line in open(tmp / 'spawned' / 'metrics.jsonl')]
        ckpts = sorted(p.name for p in (tmp / 'spawned' / 'checkpoints').iterdir())
        if [m['step'] for m in metrics if 'loss' in m] != [1] or 'last.ckpt' not in ckpts:
            raise AssertionError(f'cli.train trainer.devices={args.ranks}: {metrics} {ckpts}')
        out['spawned_s'] = time.perf_counter() - t0
        print(f'cli.train trainer.devices={args.ranks}: {out["spawned_s"]:.1f} s, one writer, '
              f'checkpoints {ckpts}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f'{args.ranks} ranks, a card each [{card}]: '
          f'{out[f"train_{args.ranks}"]["img_per_s"]:.1f} img/s against one card\'s '
          f'{out["train_1"]["img_per_s"]:.1f}: {out["speedup"]:.3f}x')
    print(card_line())
    print(json.dumps(out))


if __name__ == '__main__':
    main()
