"""The port's span recorder (utils/trace.py) on the CPU: nothing recorded and
no clock or CUDA call while off; nesting and threads while on; the spans of
eval_dataset, the train step and cli/test.py; and the spans' clock against
the profiler's Chrome trace."""

import contextlib
import io
import json
import re
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from parseq_tpu_torch.cli import test as test_cli
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.evaluate import eval_dataset
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import init_state, make_train_step
from parseq_tpu_torch.utils import registry, trace
from parseq_tpu_torch.utils.checkpoint import save_checkpoint

from .test_lmdb import _png_bytes, make_str_db

TINY = dict(enc_depth=1, embed_dim=48, enc_num_heads=3, dec_num_heads=6, max_label_length=5,
            img_size=[16, 32])
EVAL_STAGES = ['eval.next', 'eval.h2d', 'eval.forward', 'eval.wait', 'eval.decode',
               'eval.score']


@pytest.fixture(autouse=True)
def _clean():
    trace.clear()
    yield
    trace.clear()


def _bundle():
    return registry.create_model('parseq-tiny', device='cpu', dtype=torch.float32, **TINY)


def _children(spans, i):
    return [s['name'] for s in spans if s['parent'] == i]


def test_off_records_nothing_reads_no_clock_and_calls_no_cuda(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('called while recording is off')

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'Event', boom)
        m.setattr(time, 'perf_counter_ns', boom)
        m.setattr(time, 'time_ns', boom)
        with trace.span('outer', device=True, batch=0) as outer:
            with trace.span('inner', device=True):
                pass
    assert outer is trace.span('other')
    assert trace.spans() == []


@pytest.mark.parametrize('on', [False, True], ids=['off', 'on'])
def test_set_adds_attributes_inside_the_block(on):
    """A span's `set` adds attributes known only inside its block, beside
    those it opened with; while off it does nothing."""
    with trace.recording() if on else contextlib.nullcontext():
        with trace.span('outer', batch=3) as outer:
            outer.set(rows=7)
            outer.set(rows=8, found=True)
    assert trace.spans() == [] if not on else (
        [s['attrs'] for s in trace.spans()] == [{'batch': 3, 'rows': 8, 'found': True}])


@pytest.mark.parametrize('on', ['profiler', 'recording'])
def test_on_spans_nest_and_each_thread_has_its_own_stack(on):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if on == 'profiler'
           else trace.recording())
    seen = []

    def worker():
        with trace.span('thread.outer'):
            with trace.span('thread.inner'):
                seen.append(True)

    with ctx:
        with trace.span('outer', batch=3):
            with trace.span('inner', device=True):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
            with trace.span('second'):
                pass
    assert not t.is_alive() and seen
    with trace.span('after'):
        pass
    spans = trace.spans()
    names = [s['name'] for s in spans]
    assert sorted(names) == ['inner', 'outer', 'second', 'thread.inner', 'thread.outer']
    ix = {s['name']: i for i, s in enumerate(spans)}
    assert spans[ix['outer']]['parent'] is None and spans[ix['outer']]['attrs'] == {'batch': 3}
    assert _children(spans, ix['outer']) == ['inner', 'second']
    assert spans[ix['thread.outer']]['parent'] is None  # not beneath the main thread's span
    assert _children(spans, ix['thread.outer']) == ['thread.inner']
    assert spans[ix['thread.outer']]['thread'] != spans[ix['outer']]['thread']
    assert spans[ix['inner']]['device_ms'] is None  # no CUDA: no events
    for s in spans:
        assert s['start_ns'] <= s['end_ns']
    outer, inner = spans[ix['outer']], spans[ix['inner']]
    assert outer['start_ns'] <= inner['start_ns'] <= inner['end_ns'] <= outer['end_ns']
    assert abs(outer['start_ns'] - time.time_ns()) < 60e9  # on the epoch's clock


def test_eval_dataset_emits_its_stages_once_a_batch_in_order():
    bundle = _bundle()
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (3, 16, 32, 3), dtype=np.uint8), ['ab', 'c', '1'], None)
               for _ in range(3)]
    with trace.recording():
        result = eval_dataset(bundle, iter(batches))
    assert result.num_samples == 9
    spans = trace.spans()
    top = [(s['name'], s['attrs']['batch']) for s in spans if s['parent'] is None]
    for b in range(3):
        assert [n for n, i in top if i == b] == EVAL_STAGES
    assert [n for n, i in top if i == 3] == ['eval.next']  # the loader's end
    assert len(top) == 3 * 6 + 1
    # next, h2d and forward of batch b + 1 come before batch b's wait
    order = [(n, i) for n, i in top]
    assert order.index(('eval.forward', 1)) < order.index(('eval.wait', 0))
    for i, s in enumerate(spans):
        if s['name'] == 'eval.forward':
            assert _children(spans, i) == ['vit.encoder', 'parseq.refine']
            assert spans[i + 1]['attrs'] == {'rows': 3, 'fused': False}  # the CPU: eager blocks


def test_train_step_emits_forward_backward_optimizer_under_step():
    bundle = _bundle()
    model, tok, fam = bundle.module, bundle.tokenizer, get_family('parseq')
    model.train()
    state = init_state(model, optim.OptimConfig(total_steps=5, batch_size=4))
    step = make_train_step(fam, model.cfg, torch.float32)
    rng = np.random.default_rng(1)
    with trace.recording():
        for _ in range(2):
            labels = ['ab', 'c1', 'abc', '2']
            prepared = fam.prepare(tok, labels, model.cfg, rng)
            images = rng.integers(0, 256, (4, 16, 32, 3), dtype=np.uint8)
            batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
                     {'images': images, **prepared}.items()}
            step(state, batch, None)
    spans = trace.spans()
    top = [(i, s['name']) for i, s in enumerate(spans) if s['parent'] is None]
    assert [n for _, n in top] == ['train.prepare', 'train.step'] * 2
    for i, name in top:
        if name == 'train.step':
            assert _children(spans, i) == ['train.forward', 'train.backward',
                                           'train.optimizer']
    assert [s['attrs']['step'] for s in spans if s['name'] == 'train.step'] == [0, 1]


def test_spans_sit_on_the_chrome_traces_clock(tmp_path):
    """A span around a record_function block contains the block's event on
    the exported trace's timeline, to within 50 us, once merged."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span('around'):
                with record_function('block'):
                    torch.ones(64, 64).sum()
                    time.sleep(0.002)
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    trace.merge_chrome(path)
    events = json.loads(path.read_text())['traceEvents']
    blocks = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                    if e.get('name') == 'block' and e.get('ph') == 'X')
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e.get('pid') == 'program' and e.get('ph') == 'X')
    assert len(blocks) == len(spans) == 3
    for (bs, be), (ss, se) in zip(blocks, spans):
        assert ss <= bs + 50 and se >= be - 50, ((bs, be), (ss, se))
    assert {'ph': 'M', 'name': 'process_name', 'pid': 'program',
            'args': {'name': 'program'}} in events


def test_test_cli_reads_its_loader_wait_from_the_spans(tmp_path):
    root = tmp_path / 'data'
    for name in sorted(set(test_cli.data_module.TEST_BENCHMARK
                           + test_cli.data_module.TEST_BENCHMARK_SUB)):
        make_str_db(root / 'test' / name, [(_png_bytes(), 'ab'), (_png_bytes(), 'cde')] * 3)
    bundle = _bundle()
    ckpt = tmp_path / 'port.ckpt'
    save_checkpoint(ckpt, bundle.module.state_dict(),
                    meta={'name': 'parseq-tiny', 'model_config': bundle.raw_config})
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        results, timing = test_cli.main([str(ckpt), '--data_root', str(root), '--batch_size',
                                         '4', '--num_workers', '0', '--device', 'cpu'])
    assert timing['images'] == 6 * len(results)
    assert 0 < timing['first_batch_s'] <= timing['loader_s'] <= timing['eval_s']
    line = re.search(r'Read (\d+) images in [\d.]+ s \([\d.]+ img/s\), ([\d.]+) s of it waiting '
                     r'on the loader \(([\d.]+) s for the first batch of each set\); model '
                     r'load [\d.]+ s apart', err.getvalue())
    assert line and int(line.group(1)) == timing['images']
    assert trace.spans() == []  # the CLI leaves no record behind
