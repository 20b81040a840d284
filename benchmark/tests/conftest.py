"""The benchmark's CPU tests: run them with

    python -m pytest benchmark/tests -q

from the repository's root. They drive the harness at tiny widths on the
CPU, where the port's kernels fall back to their plain versions."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

TINY = {
    'parseq-s': {'img_size': [16, 32], 'embed_dim': 48, 'enc_num_heads': 4, 'enc_depth': 2,
                 'dec_num_heads': 12},
    'vitstr-s': {'img_size': [64, 64], 'patch_size': [8, 8], 'embed_dim': 48, 'num_heads': 4,
                 'depth': 2},
}
TINY_TRAFFIC = {'batch': 6, 'pool_batches': 3, 'warmup_batches': 1, 'sample_rows': 8,
                'sample_every': 1}


# the controls' size: the published widths, two blocks (at tiny widths the
# float8 products' error is below the cells' limits)
SHALLOW = {
    'parseq-s': {'enc_depth': 2},
    'vitstr-s': {'img_size': [64, 64], 'patch_size': [8, 8], 'depth': 2},
}


def tiny_cell(name, sizes=TINY):
    """The cell as BENCHMARK.json has it, at tiny widths (or `sizes`) and batch."""
    from harness import spec

    cell = copy.deepcopy(spec.load_cell(name))
    cell.config['model'].update(sizes[cell.config_name])
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in cell.traffic})
    return cell


def run_cpu(cell, seed=1, seconds=0.5, **kw):
    """Drive the cell on the CPU without a trace; returns (outcome, context)."""
    import torch

    from harness import spec
    from harness.context import Context
    from harness.trace import Tracer

    torch.manual_seed(0)
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False, device='cpu', **kw)
    return spec.driver(cell).run(ctx, Tracer(False, 0, 0)), ctx


@pytest.fixture
def tiny():
    return tiny_cell
