"""The port must import without jax: the GPU host has none."""

import subprocess
import sys
from pathlib import Path

import pytest

from parseq_tpu_torch.kernels.build import KernelBuildError, ensure_built

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules['jax'] = None  # any `import jax` now raises ImportError
import parseq_tpu_torch
for m in pkgutil.walk_packages(parseq_tpu_torch.__path__, 'parseq_tpu_torch.'):
    importlib.import_module(m.name)
shared = sorted(k for k in sys.modules
                if k.startswith('parseq_tpu.') or k == 'parseq_tpu')
print(','.join(shared))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    shared = set(out.stdout.strip().split(','))
    # Only the framework-free modules of the JAX package are shared.
    assert shared <= {'parseq_tpu', 'parseq_tpu.data', 'parseq_tpu.data.charset',
                      'parseq_tpu.data.tokenizer', 'parseq_tpu.utils',
                      'parseq_tpu.utils.config'}, shared


def test_missing_kernel_source_raises(tmp_path):
    with pytest.raises(KernelBuildError, match='missing'):
        ensure_built('nothing', [tmp_path / 'missing.cu'])
