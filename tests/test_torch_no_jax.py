"""The port must import without jax, flax or msgpack (the GPU host has none)
and without any module of the JAX package: it keeps its own copies of what
it needs, its native helpers too (no library under parseq_tpu/ is mapped
into its process)."""

import subprocess
import sys
from pathlib import Path

import pytest

from parseq_tpu_torch.kernels.build import KernelBuildError, ensure_built

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'msgpack'):
    sys.modules[name] = None  # any import of it now raises ImportError
import parseq_tpu_torch
walked = [m.name for m in pkgutil.walk_packages(parseq_tpu_torch.__path__, 'parseq_tpu_torch.')]
for name in walked:
    importlib.import_module(name)
shared = sorted(k for k in sys.modules
                if k.startswith('parseq_tpu.') or k == 'parseq_tpu')
# every native helper built and loaded: no library of the JAX package's
from parseq_tpu_torch.data import native
from parseq_tpu_torch.utils import metrics
assert metrics.load() is not None and native.load() is not None
assert native.load_jpeg() is not None
maps = open('/proc/self/maps').read().splitlines()
print(','.join(walked))
print(','.join(shared))
print(','.join(sorted({m.split()[-1] for m in maps if m.split()[-1].endswith('.so')
                       or '.so.' in m.split()[-1]})))
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
# The native host helpers, the JAX checkpoint format and int8.
NATIVE_MODULES = ('utils.native_build', 'utils.metrics', 'data.native', 'data.lmdb',
                  'utils.msgpack', 'utils.checkpoint', 'ops.quant')


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked, shared, libs = out.stdout.split('\n')[:3]
    assert {f'parseq_tpu_torch.ops.{m}' for m in KERNEL_MODULES} <= set(walked.split(','))
    modules = (READ_MODULES + TRAIN_MODULES + SERVE_MODULES + PARALLEL_MODULES
               + NATIVE_MODULES)
    assert {f'parseq_tpu_torch.{m}' for m in modules} <= set(walked.split(','))
    assert shared == '', f'the port loaded modules of the JAX package: {shared}'
    libs = libs.split(',')
    jax_dir = str(ROOT / 'parseq_tpu') + '/'
    assert not [p for p in libs if p.startswith(jax_dir)], f'the JAX package\'s libraries: {libs}'
    native_dir = str(ROOT / 'build' / 'native') + '/'
    assert {f'{native_dir}lib{n}.so' for n in ('editdist', 'lmdb_reader', 'jpeg_decode')} <= \
        set(libs), libs


def test_missing_kernel_source_raises(tmp_path):
    with pytest.raises(KernelBuildError, match='missing'):
        ensure_built('nothing', [tmp_path / 'missing.cu'])
