"""Sub-seeds of a run's --seed, one for each thing drawn from it."""

from __future__ import annotations

import zlib

import numpy as np


def sub(seed: int, tag: str) -> int:
    """A 63-bit seed for `tag` from the run's seed (any integer)."""
    words = [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32, int(seed < 0), zlib.crc32(tag.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device):
    import torch

    return torch.Generator(device=device).manual_seed(sub(seed, tag))
