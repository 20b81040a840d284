"""The port's evaluation (train/evaluate.py: eval_dataset, print_results_table)
and benchmark CLI (cli/test.py) against the JAX package's on the CPU.

Both packages read the same LMDB databases with their own loaders and run
the same weights (JAX params, moved to the port through the state_dict
converters) in f32. The classifier biases are raised on a few classes so
the tiny random models read short strings (PARSeq) or blanks (CRNN, whose
random reads barely depend on the image) with confidences that do not
underflow, which makes 1 - NED and confidence worth comparing.
"""

import contextlib
import functools
import io
import string

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from parseq_tpu.cli import test as jax_test_cli
from parseq_tpu.data import module as jmodule
from parseq_tpu.train import evaluate as jevaluate
from parseq_tpu.utils import registry as jregistry
from parseq_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from parseq_tpu_torch.cli import test as test_cli
from parseq_tpu_torch.data import module as tmodule
from parseq_tpu_torch.train import evaluate as tevaluate
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.checkpoint import save_checkpoint
from parseq_tpu_torch.utils.convert import crnn_state_dict_from_jax, state_dict_from_jax

from .test_lmdb import _png_bytes, make_str_db

# f32 both sides: the per-set sums of confidence and NED agree to f32 noise,
# absolute and relative (CRNN's confidences are small).
METRIC_TOL = 1e-5
PARSEQ_TINY = dict(enc_depth=1, embed_dim=48, enc_num_heads=3, dec_num_heads=6,
                   max_label_length=5, img_size=[16, 32])
CRNN_TINY = dict(hidden_size=32, img_size=[32, 64])
CHARSET_TEST = string.digits + string.ascii_lowercase
SETS = sorted(set(jmodule.TEST_BENCHMARK + jmodule.TEST_BENCHMARK_SUB))


def _noise_png(rng):
    pixels = rng.integers(0, 256, (rng.integers(10, 40), rng.integers(20, 120), 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, 'PNG')
    return buf.getvalue()


@pytest.fixture(scope='module')
def word_root(tmp_path_factory):
    """Two benchmark sets of 10 noise images with short labels (batches of
    4: the last one partial)."""
    root = tmp_path_factory.mktemp('words')
    rng = np.random.default_rng(0)
    for name in ('IIIT5k', 'SVT'):
        make_str_db(root / 'test' / name,
                    [(_noise_png(rng), ''.join(rng.choice(list('abc1'), rng.integers(1, 4))))
                     for _ in range(10)])
    return root


def _bias(params, key, ids, value):
    b = np.array(params[key]['b'])
    b[ids] += value
    return dict(params, **{key: dict(params[key], b=jnp.asarray(b))})


def _parseq_pair():
    jb = jregistry.create_model('parseq-tiny', dtype=jnp.float32, **PARSEQ_TINY)
    # EOS (id 0) and 'a', 'b' (ids 11, 12): reads of 0-5 of those letters
    jb.params = _bias(jb.params, 'head', [0, 11, 12], 4.0)
    tb = registry.create_model('parseq-tiny', device='cpu', dtype=torch.float32, **PARSEQ_TINY)
    tb.module.load_state_dict(state_dict_from_jax(jb.params), strict=True)
    return jb, tb


def _crnn_pair():
    jb = jregistry.create_model('crnn', dtype=jnp.float32, **CRNN_TINY)
    p = jb.params['params']
    # blank (id 0) most, 'a' and 'b' less: mostly blanks, reads of a few letters
    rnn1 = _bias(_bias(p['rnn1'], 'linear', [0], 6.0), 'linear', [11, 12], 4.0)
    jb.params = dict(jb.params, params=dict(p, rnn1=rnn1))
    tb = registry.create_model('crnn', device='cpu', dtype=torch.float32, **CRNN_TINY)
    tb.module.load_state_dict(crnn_state_dict_from_jax(jb.params['params'], jb.params['stats']),
                              strict=True)
    return jb, tb


def _loaders(package_module, model, names, root):
    dm = package_module.SceneTextDataModule(
        str(root), '_unused_', model.img_size, model.raw_config.get('max_label_length', 25),
        model.raw_config['charset_train'], CHARSET_TEST, 4, 0, augment=False)
    return dm.test_dataloaders(names)


@pytest.mark.parametrize('pair', [_parseq_pair, _crnn_pair], ids=['parseq-tiny', 'crnn'])
def test_eval_dataset_matches_jax(pair, word_root):
    jb, tb = pair()
    names = ['IIIT5k', 'SVT']
    want = [jevaluate.eval_dataset(jb, loader, name)
            for name, loader in _loaders(jmodule, jb, names, word_root).items()]
    got = [tevaluate.eval_dataset(tb, loader, name)
           for name, loader in _loaders(tmodule, tb, names, word_root).items()]
    for g, w in zip(got, want):
        assert (g.dataset, g.num_samples) == (w.dataset, w.num_samples) == (g.dataset, 10)
        np.testing.assert_allclose([g.accuracy, g.ned, g.confidence, g.label_length],
                                   [w.accuracy, w.ned, w.confidence, w.label_length],
                                   rtol=METRIC_TOL, atol=METRIC_TOL)
    assert min(r.confidence for r in got) > 1e-4  # no product underflowed
    if pair is _parseq_pair:  # reads of varied strings, partly right
        assert sum(r.label_length for r in got) > 0 and max(r.ned for r in got) > 0
    # and the table is byte-identical for the same Results
    buf_j, buf_t = io.StringIO(), io.StringIO()
    jevaluate.print_results_table(want, buf_j)
    tevaluate.print_results_table([jevaluate.Result(**vars(r)) for r in want], buf_t)
    assert buf_t.getvalue() == buf_j.getvalue() and '| Combined' in buf_t.getvalue()


def test_score_batch_matches_jax():
    jb, tb = _crnn_pair()
    probs = np.random.default_rng(2).dirichlet(np.full(37, 0.2), (5, 17)).astype(np.float32)
    labels = ['a', 'ab', '1', 'ba', 'c']
    valid = np.array([True, True, False, True, True])
    want = jevaluate.score_batch(jb.tokenizer, jb.charset_adapter, probs, labels, valid)
    got = tevaluate.score_batch(tb.tokenizer, tb.charset_adapter, probs, labels, valid)
    assert (got.num_samples, got.correct, got.label_length) == (
        want.num_samples, want.correct, want.label_length) == (4, got.correct, got.label_length)
    np.testing.assert_allclose([got.ned, got.confidence], [want.ned, want.confidence],
                               rtol=METRIC_TOL, atol=METRIC_TOL)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_test_cli_tables_match_jax_cli(tmp_path, monkeypatch):
    """The tiny LMDB of tests/test_cli.py::test_test_cli_full_benchmark_tables,
    the same weights as a JAX checkpoint and as a port checkpoint, both CLIs
    in f32: the same output, byte for byte, and both log files."""
    root = tmp_path / 'data'
    for name in SETS:
        make_str_db(root / 'test' / name, [(_png_bytes(), 'ab'), (_png_bytes(), 'cde')])
    jb, _ = _parseq_pair()
    jckpt, tckpt = tmp_path / 'jax.ckpt', tmp_path / 'port.ckpt'
    meta = {'name': 'parseq-tiny', 'model_config': jb.raw_config}
    jax_save_checkpoint(jckpt, jb.params, jb.cfg, meta=meta)
    save_checkpoint(tckpt, state_dict_from_jax(jb.params), meta=meta)

    monkeypatch.setattr(jax_test_cli, 'load_from_checkpoint', functools.partial(
        jregistry.load_from_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(test_cli, 'load_from_checkpoint', functools.partial(
        registry.load_from_checkpoint, dtype=torch.float32))
    args = ['--data_root', str(root), '--batch_size', '4', '--num_workers', '0']
    want = _run(jax_test_cli.main, [str(jckpt), *args])
    got = _run(test_cli.main, [str(tckpt), *args, '--device', 'cpu'])
    assert got == want
    assert 'Benchmark (Subset) set:' in got and 'Benchmark set:' in got and '| Combined' in got
    log = (tmp_path / 'port.ckpt.log.txt').read_text()
    assert log == (tmp_path / 'jax.ckpt.log.txt').read_text() and 'IIIT5k' in log


def test_test_cli_refuses_int8_and_cuda_without_a_card(tmp_path):
    # --int8 quantizes a ViT encoder (ops/quant.py); CRNN has none, and the
    # JAX CLI refuses it alike
    crnn = registry.create_model('crnn', device='cpu', hidden_size=16)
    torch.save(crnn.module.state_dict(), tmp_path / 'crnn.pt')
    with pytest.raises(ValueError, match='ViT'):
        test_cli.main([str(tmp_path / 'crnn.pt'), '--int8', '--device', 'cpu',
                       'hidden_size:int=16'])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            test_cli.main([str(tmp_path / 'parseq.pt')])
