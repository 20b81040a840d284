"""run.py without a card, and the modules a run loads."""

import subprocess
import sys

from harness.env import ROOT, forbidden_loaded


def test_run_fails_without_a_card():
    proc = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                           'parseq-s.read-b512', '--seed', '3000000001', '--seconds', '1',
                           '--trace', '0'], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_loaded(['parseq_tpu_torch', 'parseq_tpu_torch.ops', 'jaxtyping']) == []
    assert forbidden_loaded(['parseq_tpu.models', 'jax.numpy', 'flax']) == [
        'flax', 'jax', 'parseq_tpu']


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, in a fresh process: no module of JAX or of
    the JAX package is loaded by the harness or the port."""
    code = ('import sys; sys.path[:0] = ["benchmark/tests", "benchmark"]\n'
            'from conftest import tiny_cell, run_cpu\n'
            'from harness.env import forbidden_loaded\n'
            'for c in ("parseq-s.read-b512", "parseq-s.train-b384"):\n'
            '    run_cpu(tiny_cell(c), seconds=0.2)\n'
            'print(forbidden_loaded())\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'
