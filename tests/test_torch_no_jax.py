"""The port must import without jax (the GPU host has none) and without any
module of the JAX package: it keeps its own copies of what it needs."""

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
walked = [m.name for m in pkgutil.walk_packages(parseq_tpu_torch.__path__, 'parseq_tpu_torch.')]
for name in walked:
    importlib.import_module(name)
shared = sorted(k for k in sys.modules
                if k.startswith('parseq_tpu.') or k == 'parseq_tpu')
print(','.join(walked))
print(','.join(shared))
"""
# The modules that hold a kernel's wrapper: the walk must reach every one.
KERNEL_MODULES = ('ar_kernel', 'attention', 'flash_bwd', 'encoder_kernel')
# The CNN families' read path, the evaluation and the bench CLI.
READ_MODULES = ('ops.rnn', 'ops.grid_sample', 'models.crnn', 'models.trba', 'train.evaluate',
                'cli.test', 'cli.bench', 'utils.flops')
# Training of every family.
TRAIN_MODULES = ('ops.ctc', 'train.families', 'train.loop', 'train.optim', 'cli.train')
# Serving and tuning.
SERVE_MODULES = ('serve', 'serve.server', 'cli.serve', 'cli.tune', 'data.transforms',
                 'utils.pretrained')
# Several devices and the model-loading tools.
PARALLEL_MODULES = ('parallel', 'parallel.dist', 'parallel.dryrun', 'tools',
                    'tools.certify_pretrained', 'tools.abinet_lm_acc')


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked, shared = out.stdout.split('\n')[:2]
    assert {f'parseq_tpu_torch.ops.{m}' for m in KERNEL_MODULES} <= set(walked.split(','))
    modules = READ_MODULES + TRAIN_MODULES + SERVE_MODULES + PARALLEL_MODULES
    assert {f'parseq_tpu_torch.{m}' for m in modules} <= set(walked.split(','))
    assert shared == '', f'the port loaded modules of the JAX package: {shared}'


def test_missing_kernel_source_raises(tmp_path):
    with pytest.raises(KernelBuildError, match='missing'):
        ensure_built('nothing', [tmp_path / 'missing.cu'])
