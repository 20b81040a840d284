"""Host-side image preprocessing (port of the PIL half of
parseq_tpu/data/transforms.py).

Resize((H, W), bicubic, not aspect-preserving) -> [0, 1] -> Normalize(0.5, 0.5):
the output is NHWC float32 in [-1, 1], the layout of the port's public
functions. PIL is imported inside the functions, so the package imports
without it.
"""

from __future__ import annotations

import numpy as np


def preprocess_pil(img, img_size=(32, 128), rotation: int = 0) -> np.ndarray:
    """PIL image -> (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image

    if img.mode != 'RGB':
        img = img.convert('RGB')
    if rotation:
        img = img.rotate(rotation, expand=True)
    h, w = img_size
    img = img.resize((w, h), Image.Resampling.BICUBIC)
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x - 0.5) / 0.5


def load_image(path, img_size=(32, 128), rotation: int = 0) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return preprocess_pil(img, img_size, rotation)


def batch_images(paths, img_size=(32, 128), rotation: int = 0) -> np.ndarray:
    return np.stack([load_image(p, img_size, rotation) for p in paths])
