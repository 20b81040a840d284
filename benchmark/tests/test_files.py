"""Every configuration, traffic, cell and metric of BENCHMARK.json is found
by its name, and the file keeps to the benchmark's contract's shape."""

import json
import re

import pytest

from harness import spec
from harness.env import BENCH, ROOT

BENCHMARK = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_top_level_keys():
    assert set(BENCHMARK) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                              'end_to_end', 'per_layer'}
    assert BENCHMARK['paths'] == ['benchmark']
    assert 1 <= BENCHMARK['run_seconds'] <= 51


@pytest.mark.parametrize('w', BENCHMARK['workloads'], ids=lambda w: w['name'])
def test_cell_loads(w):
    cell = spec.load_cell(w['name'], BENCHMARK)
    assert cell.chips == 1
    assert spec.driver(cell).run
    assert cell.checks['limits']
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:  # each reports the metric it moves
        assert m['moves'] in e2e


@pytest.mark.parametrize('c', BENCHMARK['configs'], ids=lambda c: c['name'])
def test_config_file(c):
    data = json.loads((ROOT / c['file']).read_text())
    assert c['file'] == f'benchmark/configs/{c["name"]}.json'
    assert data['name'] == c['name'] and data['source'] == c['source']
    assert data['reduced'] == c['reduced'] == []
    assert (BENCH / 'reference' / f'{data["reference"]}.py').is_file()
    cell = spec.load_cell(next(w['name'] for w in BENCHMARK['workloads']
                               if w['config'] == c['name']), BENCHMARK)
    ref, adapter = spec.reference(cell), spec.adapter(cell)
    assert callable(ref.read) and callable(ref.param_shapes) and callable(ref.init_kind)
    assert callable(adapter.encoder_blocks)
    assert (adapter.wrap_ar is not None) == ref.AR
    for key in ('read_flops', 'train_flops'):
        if key in data:
            assert callable(spec.flops(data[key]))


@pytest.mark.parametrize('m', BENCHMARK['per_layer'], ids=lambda m: m['name'])
def test_metric_reader_loads(m):
    assert callable(spec.reader(m['name']).read)


def test_names_and_units():
    metrics = BENCHMARK['end_to_end'] + BENCHMARK['per_layer']
    names = [x['name'] for x in metrics + BENCHMARK['workloads'] + BENCHMARK['configs']]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(re.match(r'^[A-Za-z0-9_/%.-]{1,16}$', m['unit']) for m in metrics)
    assert all(m['better'] in ('lower', 'higher') for m in metrics)
    for m in BENCHMARK['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in BENCHMARK['end_to_end'])
