"""The port's bench CLI (cli/bench.py) on the CPU against the JAX package's:
the same JSON keys, FLOPs from utils/flops.py, flags that raise."""

import contextlib
import io
import json

import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.cli import bench as jax_bench
from parseq_tpu_torch.cli import bench
from parseq_tpu_torch.utils import registry

CRNN_SMALL = dict(hidden_size=32)


def _lines(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(argv)
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


def test_json_keys_equal_the_jax_cli(tmp_path):
    want = jax_bench.bench_model('crnn', 2, iters=1, trials=2, dtype=jnp.float32, **CRNN_SMALL)
    (got,) = _lines(['--model', 'crnn', '--device', 'cpu', '--batch_size', '2', '--iters', '1',
                     '--trials', '2', '--dtype', 'float32', '--profile', str(tmp_path / 'prof'),
                     'hidden_size:int=32'])
    assert list(got) == list(want)
    assert (got['model'], got['batch_size']) == ('crnn', 2)
    assert got['flops_per_img_G'] == want['flops_per_img_G'] > 0
    assert got['latency_ms_median'] > 0 and got['throughput_img_s'] > 0
    model = registry.create_model('crnn', device='cpu', **CRNN_SMALL)
    assert got['params_M'] == round(sum(p.numel() for p in model.module.parameters()) / 1e6, 3)
    events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())['traceEvents']
    # the program's spans, a track of their own beside the profiler's
    assert {'ph': 'M', 'name': 'process_name', 'pid': 'program',
            'args': {'name': 'program'}} in events


def test_sweep_prints_a_line_per_label_length(tmp_path):
    lines = _lines(['--model', 'parseq', '--device', 'cpu', '--iters', '1', '--trials', '1',
                    '--sweep', '--profile', str(tmp_path), 'enc_depth:int=1', 'embed_dim:int=48',
                    'enc_num_heads:int=4', 'dec_num_heads:int=6'])
    assert [r['max_label_length'] for r in lines] == list(range(1, 26, 4))
    macs = [r['flops_per_img_G'] for r in lines]
    assert macs == sorted(macs) and macs[0] < macs[-1]  # decoding grows with the length
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    names = {e['name'] for e in events if e.get('pid') == 'program' and e.get('ph') == 'X'}
    assert {'vit.encoder', 'parseq.refine'} <= names


def test_int8_and_cuda_without_a_card_refused():
    # --int8 quantizes a ViT encoder (ops/quant.py); CRNN has none, and the
    # JAX CLI refuses it alike
    with pytest.raises(ValueError, match='ViT'):
        bench.main(['--model', 'crnn', '--device', 'cpu', '--int8'])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench.main(['--model', 'crnn'])
