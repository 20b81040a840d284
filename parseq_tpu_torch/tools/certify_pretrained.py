"""Certify released weights against the reference's fixtures (port of
tools/certify_pretrained.py, with its arguments, verdict and exit codes).

One command that, once real released weights are in the checksum cache
(utils/pretrained.py), given with --weights, or downloadable, proves
"reference accuracy":

  1. loads the torch state_dict in f32 on the device (the port reads the
     reference's layout as it is),
  2. runs the demo-image regression: the six expected PARSeq-S predictions
     published in the reference README (README.md:244-251: CHEWBACCA,
     Chevrol, SALMON, Verbandsteffe, Kaopa, 3rdAve),
  3. optionally (--data_root) runs the full Table-6 benchmark evaluation
     through the port's cli/test.py.

Exits 1 if a demo prediction mismatches, 2 without demo images, and writes
a JSON verdict.

Usage:
  python -m parseq_tpu_torch.tools.certify_pretrained [experiment] [--weights FILE.pt]
      [--demo_dir DIR] [--data_root DIR] [--out certify.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

# Expected demo predictions for the flagship PARSeq-S released weights
# (reference README.md:244-251). Other experiments print predictions only.
DEMO_EXPECTED = {
    'art-01107.jpg': 'CHEWBACCA',
    'coco-1166773.jpg': 'Chevrol',
    'cute-184.jpg': 'SALMON',
    'ic13_word_256.png': 'Verbandsteffe',
    'ic15_word_26.png': 'Kaopa',
    'uber-27491.jpg': '3rdAve',
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('experiment', nargs='?', default='parseq')
    ap.add_argument('--weights', type=Path, default=None,
                    help='explicit .pt path (otherwise checksum cache / download)')
    ap.add_argument('--demo_dir', type=Path, default=Path('/root/reference/demo_images'))
    ap.add_argument('--data_root', type=Path, default=None,
                    help='benchmark LMDB root; runs the Table-6 eval when given')
    ap.add_argument('--out', type=Path, default=Path('certify.json'))
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    from parseq_tpu_torch.data.transforms import batch_images
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    if args.weights:
        model = load_from_checkpoint(str(args.weights), dtype=torch.float32, device=args.device)
    else:
        from parseq_tpu_torch.utils.pretrained import load_pretrained

        model = load_pretrained(args.experiment, dtype=torch.float32, device=args.device)

    verdict = {'experiment': args.experiment, 'demo': {}, 'demo_ok': None}

    # --- demo-image regression ---
    paths = sorted(p for p in args.demo_dir.iterdir()
                   if p.suffix.lower() in ('.jpg', '.png'))
    if not paths:
        print(f'no demo images found under {args.demo_dir}', file=sys.stderr)
        return 2
    images = batch_images([str(p) for p in paths], model.img_size)
    labels, conf = model.read(images)
    check = 'parseq' == args.experiment  # fixtures are for flagship PARSeq-S
    ok = True
    for p, text, c in zip(paths, labels, conf):
        expected = DEMO_EXPECTED.get(p.name)
        match = (text == expected) if (check and expected) else None
        verdict['demo'][p.name] = {'pred': text, 'conf': round(c, 4),
                                   'expected': expected if check else None,
                                   'match': match}
        status = '' if match is None else (' OK' if match else f' MISMATCH (want {expected})')
        print(f'{p.name}: {text} (conf={c:.4f}){status}')
        if match is False:
            ok = False
    verdict['demo_ok'] = ok if check else None

    # --- Table-6 benchmark eval ---
    if args.data_root:
        from parseq_tpu_torch.cli import test as test_cli

        ckpt = str(args.weights) if args.weights else f'pretrained={args.experiment}'
        print('\nRunning benchmark eval (reference README Table 6)...')
        test_cli.main([ckpt, '--data_root', str(args.data_root), '--device', args.device])
        verdict['benchmark'] = 'see <ckpt>.log.txt'

    args.out.write_text(json.dumps(verdict, indent=2))
    print(f'\nverdict written to {args.out}')
    return 0 if (ok or not check) else 1


if __name__ == '__main__':
    sys.exit(main())
