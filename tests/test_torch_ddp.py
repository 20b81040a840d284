"""The port's training on several ranks (parallel/, cli/train.py) on the CPU:
2 gloo processes against the port's one-rank step and the JAX package's
step on a 2-device and a 1-device mesh.

One PARSeq step (tiny, as tests/test_train_loop.py's invariance test) and
one CRNN step (batch norms) at a global batch of 8 in 2 microbatches, f32,
dropout 0, from the same weights and numpy batch: loss, grad norm, every
gradient and the batch-norm statistics. Against the port's one-rank step
at the JAX package's bar for N devices against one (rtol 2e-5, relative to
each parameter's largest gradient); against the JAX package at the
tolerances of tests/test_torch_train_families.py. Three planted faults (the
gradient all-reduce skipped, batch norms on the rank's own rows, each
rank's loss over its own token count) must fail the one-rank bar. Then
cli.train on 2 ranks (trainer.devices=2, and trainer.multihost=true in
two processes with torchrun's environment) against one process, and
dryrun_multichip(2).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from parseq_tpu.models import parseq as jparseq
from parseq_tpu.parallel import make_mesh
from parseq_tpu.train import optim as joptim
from parseq_tpu.train.families import FAMILIES as JFAMILIES
from parseq_tpu.train.steps import make_train_step as jmake_train_step
from parseq_tpu_torch.data.loader import DataLoader, shard_positions
from parseq_tpu_torch.data.module import get_transform
from parseq_tpu_torch.models import crnn as tcrnn
from parseq_tpu_torch.parallel import dryrun
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.utils.convert import state_dict_from_jax

from .test_torch_train import CHARSET, KW, _port_model, _write_db
from .test_torch_train_families import (GNORM_RTOL, GRAD_FLOOR, GRAD_REL, LOSS_ATOL, STATS_ATOL,
                                        STATS_RTOL, TRUNK, _jax_weights, _stash_grads,
                                        _state_dict, _tokenizers)

REPO = Path(__file__).resolve().parents[1]
B, MICRO, RANKS = 8, 2, 2
OCFG = dict(lr=3e-3, total_steps=10, batch_size=B, warmup_pct=0.2)
# case -> (family, the faults it must catch): CTC divides by rows, equal on
# every rank, so the count fault shows only in a token mean (PARSeq);
# PARSeq has no batch norm.
FAULTS = {'parseq': ('no_allreduce', 'local_count'), 'crnn': ('no_allreduce', 'local_batchnorm')}


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    """The rank processes read OMP_NUM_THREADS: one intra-op thread each, as
    the test workers share the CPU."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, n=B):
    return [''.join(rng.choice(list(CHARSET), rng.integers(1, 8))) for _ in range(n)]


def _case(family):
    """-> (JAX cfg, JAX params, JAX stats, port model, numpy batch,
    JAX tree -> port state_dict)."""
    rng = np.random.default_rng(3)
    if family == 'parseq':
        jcfg = jparseq.PARSeqConfig(**KW)
        params, stats = jparseq.init(jax.random.key(1), jcfg), {}
        model = _port_model(params)
        jtok, ttok = _tokenizers('parseq')
        images = rng.integers(0, 256, (B, *KW['img_size'], 3)).astype(np.uint8)
        words = _words(rng)
        batch = {'images': images, 'tgt': ttok.encode(words, KW['max_label_length']),
                 'perms': jparseq.gen_tgt_perms(np.random.default_rng(0), jcfg)}

        def to_port(tree, _stats):
            return state_dict_from_jax(tree, KW['patch_size'])
    else:
        jcfg, params, stats, kw = _jax_weights('crnn', 0)
        model = tcrnn.CRNN(tcrnn.CRNNConfig(**kw))
        model.load_state_dict(_state_dict('crnn', params, stats, kw), strict=True)
        jtok, ttok = _tokenizers('crnn')
        images = rng.integers(0, 256, (B, *kw['img_size'], 3)).astype(np.uint8)
        words = _words(rng)
        batch = {'images': images, **get_family('crnn').prepare(ttok, words, model.cfg, None)}
        jbatch = JFAMILIES['crnn'].prepare(jtok, words, jcfg, None)
        for k, v in jbatch.items():
            np.testing.assert_array_equal(batch[k], v, err_msg=k)

        def to_port(tree, stats_tree):
            return _state_dict('crnn', tree, stats_tree, kw)
    return jcfg, params, stats, model, batch, to_port


def _jax_step(family, jcfg, params, stats, batch, n_devices, to_port):
    """The JAX package's step on an n-device mesh (batch sharded, state
    replicated) -> the port's result layout."""
    tx, _ = joptim.make_optimizer(joptim.OptimConfig(**OCFG), params)
    tx = optax.chain(_stash_grads(), tx)
    mesh = make_mesh(jax.devices()[:n_devices])
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P('data'))
    state = jax.device_put({'params': params, 'stats': stats, 'opt_state': tx.init(params),
                            'step': jnp.zeros((), jnp.int32)}, repl)
    jbatch = {k: jax.device_put(jnp.asarray(v), data if v.shape[:1] == (B,) else repl)
              for k, v in batch.items()}
    step = jax.jit(jmake_train_step(JFAMILIES[family], jcfg, tx, jnp.float32,
                                    microbatches=MICRO))
    state, m = step(state, jbatch, jax.device_put(jax.random.key(0), repl))
    state = jax.device_get(state)
    grads = to_port(state['opt_state'][0], state['stats'])
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']), 'numel': int(m['numel']),
            'grads': {k: v.double() for k, v in grads.items()},
            'stats': {k: v.double() for k, v in to_port(params, state['stats']).items()
                      if k.endswith(('running_mean', 'running_var'))}}


def _check_against_jax(family, got, want):
    """tests/test_torch_train_families.py's tolerances."""
    np.testing.assert_allclose(got['loss'], want['loss'], atol=LOSS_ATOL)
    np.testing.assert_allclose(got['grad_norm'], want['grad_norm'], rtol=GNORM_RTOL)
    assert got['numel'] == want['numel']
    grads = {name: want['grads'][name] for name in got['grads']}
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        err = float((got['grads'][name] - g).abs().max())
        if err > GRAD_REL * max(float(g.abs().max()), GRAD_FLOOR * top):
            rel = float((got['grads'][name] - g).norm() / g.norm())
            prefixes, bound = TRUNK.get(family, ((), 0.0))
            assert name.startswith(prefixes) and rel <= bound, (name, err, rel)
    for name, s in want['stats'].items():
        np.testing.assert_allclose(got['stats'][name].numpy(), s.numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=name)


def _one_rank_bar(got, want):
    """The distances compare_steps reads, each within RTOL."""
    d = dryrun.compare_steps(got, want)
    return (d['loss'] <= dryrun.RTOL and d['grad_norm'] <= dryrun.RTOL
            and d['grad'][0] <= dryrun.RTOL and d['stats'] <= dryrun.RTOL), d


@pytest.fixture(scope='module')
def cases():
    return {family: _case(family) for family in FAULTS}


@pytest.fixture(scope='module')
def two_ranks(cases):
    """Every case and fault on one pair of gloo processes: per family, the
    clean step and then each fault's; and the same steps in this process."""
    jobs = [dict(family=f, model=cases[f][3], batch=cases[f][4], microbatches=MICRO, fault=fault)
            for f in FAULTS for fault in (None, *FAULTS[f])]
    ranks = dryrun.run_ranks(RANKS, dryrun.rank_steps, (jobs,))
    one = dryrun.rank_steps(torch.device('cpu'), [j for j in jobs if j['fault'] is None])
    results = {}
    for i, job in enumerate(jobs):
        results[job['family'], job['fault']] = [r[i] for r in ranks]
    return results, {j['family']: r for j, r in zip([j for j in jobs if j['fault'] is None], one)}


@pytest.mark.parametrize('family', list(FAULTS))
def test_two_rank_step_matches_one_rank_and_jax(family, cases, two_ranks):
    results, one = two_ranks
    rank0, rank1 = results[family, None]
    for name, g in rank0['grads'].items():  # one all-reduce: the same bits on both ranks
        assert torch.equal(g, rank1['grads'][name]), name
    assert rank0['loss'] == rank1['loss'] and rank0['grad_norm'] == rank1['grad_norm']
    assert rank0['stats'].keys() == rank1['stats'].keys()
    for name, s in rank0['stats'].items():
        assert torch.equal(s, rank1['stats'][name]), name
    ok, d = _one_rank_bar(rank0, one[family])
    assert ok, d
    assert rank0['numel'] == one[family]['numel']
    jcfg, params, stats, _, batch, to_port = cases[family]
    for n_devices in (2, 1):
        _check_against_jax(family, rank0,
                           _jax_step(family, jcfg, params, stats, batch, n_devices, to_port))
    print(f'{family}: 2 ranks vs 1 {d}')


@pytest.mark.parametrize('family,fault', [(f, x) for f in FAULTS for x in FAULTS[f]])
def test_planted_fault_fails_the_one_rank_bar(family, fault, two_ranks):
    results, one = two_ranks
    ok, d = _one_rank_bar(results[family, fault][0], one[family])
    assert not ok, f'{fault} passed: {d}'
    print(f'{family} {fault}: {d}')


def test_shards_interleave_by_microbatch_and_augment_alike():
    assert shard_positions(16, 2, 1, 2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    assert shard_positions(16, 4, 0, 2).tolist() == [0, 1, 4, 5, 8, 9, 12, 13]
    assert shard_positions(8, 1, 0, 1).tolist() == list(range(8))
    with pytest.raises(ValueError, match='multiple of 2 rows'):
        shard_positions(12, 4, 0, 2)

    class Words:  # rendered words through the train transform, augmentation on
        def __init__(self):
            self.transform = get_transform((16, 32), augment=True, u8=True)

        def __len__(self):
            return 12

        def __getitem__(self, i):
            from .test_torch_train import _text_png

            return self.transform(_text_png(CHARSET[i:i + 5])), CHARSET[i:i + 5]

    def batches(rank, count):
        return list(DataLoader(Words(), 8, shuffle=True, drop_last=True, seed=1, epoch=2,
                               shard_rank=rank, shard_count=count, microbatches=2))

    (whole,), (r0,), (r1,) = batches(0, 1), batches(0, 2), batches(1, 2)
    for r, part in ((0, r0), (1, r1)):
        rows = shard_positions(8, 2, r, 2)
        np.testing.assert_array_equal(part[0], whole[0][rows])
        assert part[1] == [whole[1][i] for i in rows]


def _cli_args(root, work_dir, *extra):
    return ['+experiment=parseq-tiny', f'data.root_dir={root}', 'data.num_workers=0',
            'data.augment=true', 'model.batch_size=8', 'model.img_size=[16,32]',
            'model.enc_depth=1', 'model.dropout=0', 'trainer.max_steps=2',
            'trainer.val_check_interval=2', 'trainer.microbatches=2', 'trainer.swa=false',
            *extra, f'--work_dir={work_dir}', '--device', 'cpu']


def _metrics(work_dir):
    return [json.loads(line) for line in open(Path(work_dir) / 'metrics.jsonl')]


@pytest.fixture(scope='module')
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('ddp-data')
    rng = np.random.default_rng(0)
    _write_db(root / 'train' / 'real' / 'syn', _words(rng, 32))
    _write_db(root / 'val' / 'syn', _words(rng, 8))
    return root


def test_cli_trains_on_two_ranks_as_on_one(cli_root, tmp_path):
    """cli.train with trainer.devices=2 (2 spawned gloo processes) logs the
    lines one process logs, the step-1 loss within rtol 2e-5; torchrun's
    environment in two processes (trainer.multihost=true, each its own
    --work_dir) leaves rank 1's directory unwritten."""
    from parseq_tpu_torch.cli import train as train_cli

    train_cli.main(_cli_args(cli_root, tmp_path / 'one'))
    one = _metrics(tmp_path / 'one')
    assert train_cli.main(_cli_args(cli_root, tmp_path / 'two', 'trainer.devices=2')) is None
    two = _metrics(tmp_path / 'two')
    assert [sorted(m) for m in two] == [sorted(m) for m in one]  # one writer
    # the step-1 loss is of the same weights and rows (bf16 compute: what the
    # step changes differs in its last bits between 4-row and 2-row products)
    assert two[0]['step'] == 1
    np.testing.assert_allclose(two[0]['loss'], one[0]['loss'], rtol=dryrun.RTOL)

    env = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(dryrun.dist.free_port()),
               WORLD_SIZE='2', LOCAL_WORLD_SIZE='2', OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'parseq_tpu_torch.cli.train',
         *_cli_args(cli_root, tmp_path / f'host{r}', 'trainer.multihost=true')],
        cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r}:\n{out[-3000:]}'
        assert 'backend gloo on cpu' in out, out[-2000:]
    assert not (tmp_path / 'host1').exists()
    run = tmp_path / 'host0'
    assert (run / 'config.json').exists() and len(list((run / 'tb').iterdir())) == 1
    assert {p.name for p in (run / 'checkpoints').iterdir()} >= {'last.ckpt',
                                                                 'train_state.ckpt'}
    first = _metrics(run)[0]
    assert first['step'] == 1
    np.testing.assert_allclose(first['loss'], one[0]['loss'], rtol=dryrun.RTOL)


def test_dryrun_multichip():
    dryrun.dryrun_multichip(2)
