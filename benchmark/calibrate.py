"""The readings that the correctness limits of a cell are set from, on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--control] [--fault <name>]

In one process, for each seed: the cell's driver with a short window, its
compared numbers and whether they pass the cell's limits. With --control,
also the control (harness/control.py): the reference computed with float8
products in the program's place, for a read cell on the run's own sample,
for the training cell its steps from the same weights on the same data,
judged by the same limits. With --fault, a fault of harness/faults.py
planted under the timed path. Prints one JSON line a seed and, last, the
largest and the smallest reading of each number. The benchmark's own runs
never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import env  # noqa: E402

env.fix_cache_dirs()

from harness import control, faults, report, spec  # noqa: E402
from harness.context import Context  # noqa: E402
from harness.trace import Tracer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', choices=sorted(faults.FAULTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print('calibrate.py needs a CUDA card', file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    training = cell.traffic['driver'] == 'train'
    every = {}

    def note(kind, readings):
        for k, v in readings.items():
            every.setdefault(kind, {}).setdefault(k, []).append(v)

    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        ctx = Context(cell=cell, seed=seed, seconds=args.seconds, trace=False)
        line = {'seed': seed, 'control': args.control, 'fault': args.fault}
        if args.control and training:
            line['control_readings'], line['detail'] = control.fp8_training(ctx)
        else:
            with (faults.FAULTS[args.fault](cell) if args.fault else contextlib.nullcontext()):
                out = spec.driver(cell).run(ctx, Tracer(False, 0, 0))
            line['readings'] = out.readings
            line['detail'] = {k: v for k, v in ctx.keep.items() if k != 'sample'}
            if args.control:
                line['control_readings'] = control.fp8_reading(ctx)
        for kind in ('readings', 'control_readings'):
            if kind in line:
                note(kind, line[kind])
                line[kind.replace('readings', 'correct')] = report.judge(
                    line[kind], cell.checks['limits'])[1]
        line['seconds'] = round(time.perf_counter() - t0, 2)
        print(json.dumps(line, default=str), flush=True)
    print(json.dumps({'workload': args.workload, 'control': args.control, 'fault': args.fault,
                      **{f'{kind} max': {k: max(v) for k, v in r.items()}
                         for kind, r in every.items()},
                      **{f'{kind} min': {k: min(v) for k, v in r.items()}
                         for kind, r in every.items()}}), flush=True)
    bad = env.forbidden_loaded()
    if bad:
        print(f'calibrate.py: loaded {bad}', file=sys.stderr)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())
