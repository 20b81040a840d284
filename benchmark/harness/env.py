"""Paths of the checkout, the caches the program builds into, and the
check that nothing of JAX or of the JAX package was loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# where a run writes its summaries (listed in .gitignore)
OUT = ROOT / 'bench_out'

# Top-level module names that must not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'parseq_tpu')


def fix_cache_dirs():
    """Fixed build and kernel-cache directories inside the checkout, so only a
    checkout's first run builds. The port builds its nvcc kernels into
    build/kernels/ and its g++ helpers into build/native/ by itself."""
    build = ROOT / 'build'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules."""
    tops = {name.split('.', 1)[0] for name in (modules if modules is not None else sys.modules)}
    return sorted(tops & set(FORBIDDEN))
