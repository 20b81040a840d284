"""Sets of runs of one cell, each run its own process, and the spread of each
end-to-end metric: the distance between the first and third quartiles
(statistics.quantiles(values, n=4)) as a share of the median, per set and
the wider of the sets. This is how the bounds of BENCHMARK.json are set.

    python benchmark/sets.py --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2]
        [--seconds 20] [--trace 0]

Every set runs the same seeds in the same order. Prints one JSON line a run
(its result line's metrics, correct, and the compared numbers) and, last,
the spreads.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float('nan')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--sets', type=int, default=2)
    ap.add_argument('--seconds', type=float, default=20)
    ap.add_argument('--trace', type=int, default=0)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(',')]
    values = {}
    for s in range(args.sets):
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', args.workload,
                                   '--seed', str(seed), '--seconds', str(args.seconds),
                                   '--trace', str(args.trace)], cwd=ROOT, capture_output=True,
                                  text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                print(json.dumps({'set': s, 'seed': seed, 'rc': proc.returncode,
                                  'stderr': proc.stderr[-3000:]}), flush=True)
                continue
            for k, m in res['metrics'].items():
                values.setdefault(k, {}).setdefault(s, []).append(m['value'])
            print(json.dumps({'set': s, 'seed': seed, 'rc': proc.returncode, 'wall_s': wall,
                              'correct': res['correct'], 'attempted': res['attempted'],
                              'failed': res['failed'],
                              'metrics': {k: m['value'] for k, m in res['metrics'].items()},
                              'peak': res['device']['memory_peak_bytes'],
                              'checks': {k: c['value'] for k, c in res['checks'].items()},
                              'notes': [x for x in lines[:-1] if not x.startswith('summary')]}),
                  flush=True)
    out = {}
    for k, by_set in values.items():
        per = {s: {'median': statistics.median(v), 'spread': spread(v)}
               for s, v in by_set.items() if len(v) >= 2}
        out[k] = {'sets': per, 'widest': max((p['spread'] for p in per.values()), default=None)}
    print(json.dumps({'workload': args.workload, 'spreads': out}), flush=True)


if __name__ == '__main__':
    main()
