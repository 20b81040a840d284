"""The run's result: its last line on standard output, and the numbers that
decided `correct` as the last lines on standard error."""

from __future__ import annotations

import json
import subprocess
import sys


def card_line():
    """The card's name and power limit, and the torch and CUDA versions."""
    import torch

    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out = [f'nvidia-smi: {e}']
    return (f'card: {out[0] if out else "?"}; torch {torch.__version__}, '
            f'CUDA {torch.version.cuda}')


def emit(correct, attempted, failed, metrics, device, checks, breakdown=None):
    """metrics: {name: (value, unit)}; checks: {name: (value, limit)}."""
    for name, (value, limit) in checks.items():
        print(f'check {name}: {value!r} (limit {limit!r})', file=sys.stderr)
    line = {'correct': bool(correct), 'attempted': int(attempted), 'failed': int(failed),
            'metrics': {k: {'value': v, 'unit': u} for k, (v, u) in metrics.items()},
            'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = {k: {'value': v, 'limit': lim} for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def judge(readings: dict, limits: dict):
    """{name: (value, limit)} for every limited reading, and whether all hold
    (a reading that is not finite fails)."""
    checks = {k: (readings[k], limits[k]) for k in limits if k in readings}
    missing = sorted(set(limits) - set(readings))
    ok = not missing and all(v == v and v <= lim for v, lim in checks.values())
    for k in missing:
        checks[k] = (float('nan'), limits[k])
    return checks, ok
