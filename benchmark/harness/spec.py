"""BENCHMARK.json and the files it names, found by name.

- the cell: BENCHMARK.json's workload entry (its configuration and
  traffic), and benchmark/workloads/<cell>.json (its correctness limits and
  sample sizes);
- the configuration: benchmark/configs/<config>.json, whose `reference`
  names its plain model benchmark/reference/<reference>.py (the interface
  is in reference/__init__.py), `adapter` the program's side of that model
  benchmark/adapters/<adapter>.py, and `read_flops` / `train_flops` its
  FLOP formulas benchmark/roofline/flops/<formula>.py;
- the traffic: benchmark/traffic/<traffic>.json, whose `driver` names the
  general driver benchmark/drivers/<driver>.py that reads it;
- a per-layer metric: its reader benchmark/metrics/<metric>.py;
- a kernel's name in the trace and its least time:
  benchmark/roofline/kernels/<kernel>.py.

A later PR adds any of these by adding files and BENCHMARK.json entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass

from harness.env import BENCH, ROOT


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name=None):
    """Import a file of the benchmark by its path (names may hold '.' and '-')."""
    name = name or 'bench_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list


def _applies(metric, cell, e2e_names):
    if 'workloads' in metric:
        return cell in metric['workloads']
    return metric.get('moves') is None or metric['moves'] in e2e_names


def load_cell(name, bench=None) -> Cell:
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    entries = {w['name']: w for w in bench['workloads']}
    if name not in entries:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; have {sorted(entries)}')
    w = entries[name]
    e2e = [m for m in bench['end_to_end'] if _applies(m, name, ())]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer'] if _applies(m, name, names)]
    return Cell(name=name, chips=w['chips'], config_name=w['config'],
                config=load_json(BENCH / 'configs' / f'{w["config"]}.json'),
                traffic=load_json(BENCH / 'traffic' / f'{w["traffic"]}.json'),
                checks=load_json(BENCH / 'workloads' / f'{name}.json'),
                end_to_end=e2e, per_layer=per_layer)


def driver(cell: Cell):
    return load_module(BENCH / 'drivers' / f'{cell.traffic["driver"]}.py')


def reader(metric_name):
    return load_module(BENCH / 'metrics' / f'{metric_name}.py')


def reference(cell: Cell):
    """The configuration's plain model (benchmark/reference/<reference>.py)."""
    return importlib.import_module(f'reference.{cell.config["reference"]}')


def adapter(cell: Cell):
    """The program's side of the configuration's model."""
    return load_module(BENCH / 'adapters' / f'{cell.config["adapter"]}.py')


def flops(formula):
    """A FLOP formula: flops(cfg, ids) -> FLOPs an image."""
    return load_module(BENCH / 'roofline' / 'flops' / f'{formula}.py').flops


def kernel(name):
    """A kernel's PATTERN (its name in the trace) and bound(...) -> (ms, what binds)."""
    return load_module(BENCH / 'roofline' / 'kernels' / f'{name}.py')
