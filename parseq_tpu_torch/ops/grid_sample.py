"""Bilinear grid sampling (port of parseq_tpu/ops/grid_sample.py).

The JAX package's default one-hot-matmul form works round the TPU's
lane padding of gathers; its semantics are those of its gather path
(`_grid_sample_gather`), which is F.grid_sample(mode='bilinear',
padding_mode='border', align_corners=True): grid coordinates in [-1, 1],
(x, y) in the last dimension, samples clamped to the border. The port
calls F.grid_sample itself, on NCHW images, with the grid in the images'
dtype (the JAX package computes the grid in the model's dtype).
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample(images, grid):
    """images (B, C, H, W); grid (B, Hg, Wg, 2) -> (B, C, Hg, Wg)."""
    return F.grid_sample(images, grid.to(images.dtype), mode='bilinear', padding_mode='border',
                         align_corners=True)
