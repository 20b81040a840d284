"""Read text from images with the PyTorch port (counterpart of
parseq_tpu/cli/read.py).

Usage:
    python -m parseq_tpu_torch.cli.read <checkpoint.pt> --images img1.jpg img2.png
        [--device cuda|cpu] [model_override:type=value ...]

`checkpoint` is a reference PyTorch .pt file. The default device is cuda;
with no GPU the command fails unless --device cpu is given.
"""

from __future__ import annotations

import argparse

import torch

from parseq_tpu.utils.config import parse_model_args
from parseq_tpu_torch.data.transforms import batch_images
from parseq_tpu_torch.utils.registry import load_from_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('checkpoint', help='Reference PyTorch .pt file')
    ap.add_argument('--images', nargs='+', required=True, help='Image files to read')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    ap.add_argument('model_args', nargs='*', help='Model overrides key:type=value')
    args = ap.parse_args(argv)

    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')
    kwargs = parse_model_args(args.model_args)
    model = load_from_checkpoint(args.checkpoint, device=args.device, **kwargs)
    print(f'Additional model arguments: {kwargs}')

    images = batch_images(args.images, model.img_size)
    labels, confidence = model.read(images)
    for path, text, conf in zip(args.images, labels, confidence):
        print(f'{path}: {text} (conf={conf:.4f})')


if __name__ == '__main__':
    main()
