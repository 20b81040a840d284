"""Image preprocessing (port of parseq_tpu/data/transforms.py): the PIL
path on the host, and `preprocess_torch` on a device.

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


def preprocess_pil_u8(img, img_size=(32, 128), rotation: int = 0,
                      fast_decode: bool = True) -> np.ndarray:
    """PIL image -> (H, W, 3) uint8, resized; normalization deferred to the
    device (train/steps.py:normalize_u8 keeps the exact op order, so the
    values equal preprocess_pil's).

    ``fast_decode`` engages libjpeg's DCT-scaled decode (PIL ``draft``) for
    JPEG sources at least 2x the target in both dims; no-op for PNG and small
    crops. Skipped under rotation (rotate acts on the decoded image).
    """
    from PIL import Image

    h, w = img_size
    if fast_decode and not rotation:
        img.draft('RGB', (w, h))
    if img.mode != 'RGB':
        img = img.convert('RGB')
    if rotation:
        img = img.rotate(rotation, expand=True)
    img = img.resize((w, h), Image.Resampling.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def decode_u8(data, img_size=(32, 128)) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 resized to img_size: a JPEG
    through the native decode+resize (data/native/jpeg_decode.cpp,
    bit-identical to this path through PIL), anything else through PIL and
    preprocess_pil_u8."""
    import io

    from PIL import Image

    from parseq_tpu_torch.data.native import jpeg_decode_resize

    arr = jpeg_decode_resize(data, img_size)
    if arr is not None:
        return arr
    with Image.open(io.BytesIO(bytes(data))) as img:
        return preprocess_pil_u8(img, img_size)


def load_image(path, img_size=(32, 128), rotation: int = 0) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return preprocess_pil(img, img_size, rotation)


def batch_images(paths, img_size=(32, 128), rotation: int = 0) -> np.ndarray:
    return np.stack([load_image(p, img_size, rotation) for p in paths])


def preprocess_torch(images, img_size=(32, 128), device=None):
    """Resize and normalise a batch on a device: uint8 or float NHWC ->
    float32 NHWC in [-1, 1] on `device` (default: where `images` lie).
    Counterpart of parseq_tpu/data/transforms.py:preprocess_jax.

    uint8 becomes f32 / 255 first. The resize is bicubic with antialiasing,
    which is what `jax.image.resize(..., method='cubic')` computes: without
    antialias torch's bicubic uses another kernel coefficient (-0.75, not
    -0.5) and no widening when it shrinks, and misses by up to 0.66. The
    result is clamped to [0, 1], as PIL's bicubic clamps to the uint8 range,
    then (y - 0.5) / 0.5. Like preprocess_jax, it is not bit-identical to
    the PIL path (other boundary handling)."""
    import torch
    import torch.nn.functional as F

    x = torch.as_tensor(images)
    if device is not None:
        x = x.to(device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(img_size), mode='bicubic',
                      align_corners=False, antialias=True)
    y = y.clamp(0.0, 1.0)
    return ((y - 0.5) / 0.5).permute(0, 2, 3, 1).contiguous()
