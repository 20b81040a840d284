"""Run one cell of the benchmark of parseq_tpu_torch on the card of this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, building the kernels on a checkout's first run, the seed's
weights and data, the warm-up) is timed as setup_s; then the window runs for
--seconds. With --trace 0 the result line holds the cell's end-to-end
metrics; with --trace 1 its per-layer metrics, read from a profiler trace of
a fixed span of the window, and the trace's breakdown. Once the window has
closed, what the timed path produced is compared with the plain reference
(benchmark/reference/), and `correct` says whether every compared number is
within its limit (benchmark/workloads/<cell>.json). The last line of
standard output is the result; the compared numbers and their limits are
also the last lines of standard error. A summary of the run goes to
bench_out/<cell>/.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; if a module of JAX or of the JAX package
was loaded, with code 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import env  # noqa: E402

env.fix_cache_dirs()

from harness import report, spec  # noqa: E402
from harness.context import Context  # noqa: E402
from harness.trace import Tracer  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(ctx, tracer):
    """Drive the cell; returns (outcome, per-layer or end-to-end metrics,
    checks, correct)."""
    cell = ctx.cell
    outcome = spec.driver(cell).run(ctx, tracer)
    if ctx.trace and ctx.out_dir is not None:
        outcome.trace = tracer.read(ctx.out_dir / 'trace.json')
    if ctx.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m['name']).read(outcome, ctx)
            if value is not None:
                metrics[m['name']] = (value, m['unit'])
    else:
        metrics = {m['name']: (outcome.metrics[m['name']][0], m['unit'])
                   for m in cell.end_to_end}
    checks, ok = report.judge(outcome.readings, cell.checks['limits'])
    return outcome, metrics, checks, ok and outcome.attempted > 0


def main(argv=None):
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'run.py: {args.workload} needs {cell.chips} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    out_dir = env.OUT / args.workload
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  out_dir=out_dir, t_process=T_PROCESS)
    tr = cell.traffic
    tracer = Tracer(ctx.trace, tr['trace_start'], tr['trace_iters'])
    outcome, metrics, checks, correct = measure(ctx, tracer)
    bad = env.forbidden_loaded()
    if bad:
        print(f'run.py: modules of JAX or of the JAX package were loaded: {bad}',
              file=sys.stderr)
        return 3
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': cell.chips,
              'memory_peak_bytes': outcome.memory_peak_bytes}
    breakdown = None
    if outcome.trace is not None:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        breakdown = outcome.trace.breakdown()
    card = report.card_line()
    print(card)
    for note in outcome.notes:
        print(note)
    summary = {'workload': args.workload, 'seed': args.seed, 'seconds': args.seconds,
               'trace': args.trace, 'card': card, 'device': device,
               'metrics': metrics, 'checks': checks, 'notes': outcome.notes,
               'layer': outcome.layer}
    if outcome.trace is not None:
        summary['kernels'] = [[k, n, t] for k, n, t in outcome.trace.kernels()[:60]]
        summary['device_ops'] = outcome.trace.device_ops()[:60]
        summary['idle_gaps'] = outcome.trace.idle_gaps()[:60]
        summary['breakdown'] = breakdown
    path = out_dir / f'seed{args.seed}-trace{args.trace}.json'
    path.write_text(json.dumps(summary, indent=1, default=str))
    print(f'summary: {path.relative_to(env.ROOT)}')
    report.emit(correct, outcome.attempted, outcome.failed, metrics, device, checks, breakdown)
    return 0


if __name__ == '__main__':
    sys.exit(main())
