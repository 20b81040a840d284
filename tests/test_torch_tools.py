"""The port's model-loading tools (parseq_tpu_torch/tools/) against the JAX
package's (tools/certify_pretrained.py, tools/test_abinet_lm_acc.py), on the
CPU, each given the same weights and inputs.

certify_pretrained: one synthetic released-format PARSeq-S .pt (a twin
state_dict, random) in a checksum cache, six PIL-rendered demo images named
as DEMO_EXPECTED's files: both tools give the same six predictions and exit
1 (random weights miss the fixtures). abinet_lm_acc: one tiny ABINet, its
JAX parameters converted to the port's state_dict, on one tiny LMDB: the
language model's probabilities agree, and both print the same
`(correct/total)`, with the random model and with one that echoes its
input.
"""

import contextlib
import hashlib
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from parseq_tpu.utils import pretrained as jpretrained
from parseq_tpu_torch.tools import abinet_lm_acc, certify_pretrained
from parseq_tpu_torch.utils import convert
from parseq_tpu_torch.utils import pretrained as tpretrained

from .test_lmdb import make_str_db
from .torch_twin import TwinPARSeq

REPO = Path(__file__).resolve().parents[1]
LM_WORDS = ['abc', 'Fed', 'dead', 'BEAD', 'cafe', 'faCe', 'bad']


def _word_image(path, text):
    img = Image.new('RGB', (8 * len(text) + 8, 24), (235, 235, 225))
    ImageDraw.Draw(img).text((4, 6), text, fill=(10, 10, 10))
    img.save(path)


def _png(text):
    buf = io.BytesIO()
    img = Image.new('RGB', (8 * len(text) + 8, 24), (235, 235, 225))
    ImageDraw.Draw(img).text((4, 6), text, fill=(10, 10, 10))
    img.save(buf, 'PNG')
    return buf.getvalue()


def _jax_tool(name):
    sys.path.insert(0, str(REPO / 'tools'))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture
def released_parseq(tmp_path, monkeypatch):
    """A random released-format PARSeq-S file in a checksum cache, both
    packages' URL tables pointing at it (file://: nothing leaves the host)."""
    torch.manual_seed(0)
    raw = tmp_path / 'raw.pt'
    torch.save(TwinPARSeq(num_tokens=97).state_dict(), raw)
    cached = tmp_path / f'parseq-{hashlib.sha256(raw.read_bytes()).hexdigest()[:8]}.pt'
    raw.rename(cached)
    for table in (jpretrained.WEIGHTS_URL, tpretrained.WEIGHTS_URL):
        monkeypatch.setitem(table, 'parseq', cached.as_uri())
    monkeypatch.setenv('PARSEQ_TPU_CACHE', str(tmp_path))
    return cached


def test_certify_pretrained_matches_jax_tool(tmp_path, released_parseq):
    demo = tmp_path / 'demo'
    demo.mkdir()
    for name, text in certify_pretrained.DEMO_EXPECTED.items():
        _word_image(demo / name, text.lower())
    assert certify_pretrained.DEMO_EXPECTED == _jax_tool('certify_pretrained').DEMO_EXPECTED

    verdicts = {}
    for side, tool, extra in (('jax', _jax_tool('certify_pretrained').main, []),
                              ('port', certify_pretrained.main, ['--device', 'cpu'])):
        out = tmp_path / f'{side}.json'
        assert tool(['parseq', '--demo_dir', str(demo), '--out', str(out), *extra]) == 1
        verdicts[side] = json.loads(out.read_text())
    jv, tv = verdicts['jax'], verdicts['port']
    assert tv['demo_ok'] is jv['demo_ok'] is False
    assert sorted(tv['demo']) == sorted(jv['demo']) == sorted(certify_pretrained.DEMO_EXPECTED)
    for name, entry in tv['demo'].items():
        assert entry['pred'] == jv['demo'][name]['pred'], name
        assert entry['expected'] == jv['demo'][name]['expected']
        assert entry['match'] is False


def test_certify_without_demo_images_exits_2(tmp_path, released_parseq):
    (tmp_path / 'empty').mkdir()
    assert certify_pretrained.main(['parseq', '--demo_dir', str(tmp_path / 'empty'),
                                    '--out', str(tmp_path / 'v.json'), '--device', 'cpu']) == 2


@pytest.fixture(scope='module')
def tiny_abinet(tmp_path_factory):
    """(JAX model, JAX checkpoint, port checkpoint, data root): one tiny
    ABINet whose JAX parameters are converted to the port's state_dict, and
    one LMDB split of LM_WORDS. The test charset is lowercase, so the
    adapter lowers each prediction and the words with capitals never count."""
    from parseq_tpu.utils.checkpoint import save_checkpoint as jsave
    from parseq_tpu.utils.registry import create_model
    from parseq_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp('abinet')
    kw = dict(charset_train='abcdefABCDEF', charset_test='abcdef', img_size=[32, 64],
              max_label_length=7, nhead=4, d_inner=128, v_num_layers=1, l_num_layers=1,
              iter_size=1)
    m = create_model('abinet', dtype=jnp.float32, **kw)
    jckpt, tckpt = tmp / 'abinet-jax.ckpt', tmp / 'abinet-port.ckpt'
    jsave(jckpt, m.params, m.cfg, meta={'name': 'abinet', 'model_config': m.raw_config})
    sd = convert.abinet_state_dict_from_jax(m.params['params'], m.params['stats'],
                                            img_size=kw['img_size'],
                                            max_label_length=kw['max_label_length'])
    save_checkpoint(tckpt, sd, meta={'name': 'abinet', 'model_config': dict(m.raw_config)})
    make_str_db(tmp / 'data' / 'test' / 'IIIT5k', [(_png(w), w) for w in LM_WORDS])
    return m, jckpt, tckpt, tmp / 'data'


def _lm_tools_print(jckpt, tckpt, data):
    """{'jax': lines, 'port': lines} that each LM tool prints on `data`."""
    printed = {}
    for side, tool, ckpt, extra in (('jax', _jax_tool('test_abinet_lm_acc').main, jckpt, []),
                                    ('port', abinet_lm_acc.main, tckpt, ['--device', 'cpu'])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool([str(ckpt), '--data_root', str(data), '--splits', 'test/IIIT5k',
                  '--batch_size', '4', *extra])
        printed[side] = buf.getvalue().strip().splitlines()
    return printed


def test_abinet_lm_acc_matches_jax_tool(tiny_abinet):
    _, jckpt, tckpt, data = tiny_abinet
    printed = _lm_tools_print(jckpt, tckpt, data)
    assert printed['port'][-1].startswith('LM word accuracy:')
    assert printed['port'][-1].endswith(f'/{len(LM_WORDS)})')
    assert printed['port'] == printed['jax']


def test_abinet_lm_probs_match_jax(tiny_abinet):
    """The port's language-model softmax (abinet_lm_acc.batch_probs: one-hot
    ground truth, NULL past the end, lengths with EOS) against the JAX
    tool's on the same words and converted weights, within 1e-5 of the
    largest probability."""
    from parseq_tpu.models import abinet as jabinet
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    m, _, tckpt, _ = tiny_abinet
    cfg, tok = m.cfg, m.tokenizer
    port = load_from_checkpoint(str(tckpt), dtype=torch.float32, device='cpu')
    got = np.concatenate([p for _, p in abinet_lm_acc.batch_probs(port, LM_WORDS, 4)])
    enc = tok.encode(LM_WORDS, cfg.max_label_length)[:, 1:cfg.max_length + 1]
    onehot = jax.nn.one_hot(jnp.asarray(np.where(enc == cfg.pad_id, cfg.null_label, enc)),
                            cfg.num_classes)
    lengths = jnp.asarray([len(w) + 1 for w in LM_WORDS], jnp.int32)
    logits = jabinet.language_forward(m.params['params']['language'], cfg, onehot, lengths)
    want = np.asarray(jax.nn.softmax(logits['logits'], -1))
    assert got.shape == want.shape == (len(LM_WORDS), cfg.max_length, cfg.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_abinet_lm_acc_counts_match_jax_tool(tiny_abinet, monkeypatch):
    """Both tools with a language model that echoes its one-hot input: every
    lowercase word reads right and every word with a capital wrong after
    the adapter, so both print the same count strictly between 0 and t."""
    from parseq_tpu.models import abinet as jabinet
    from parseq_tpu_torch.models import abinet as tabinet

    _, jckpt, tckpt, data = tiny_abinet
    monkeypatch.setattr(jabinet, 'language_forward',
                        lambda p, cfg, tokens, lengths, **kw: {'logits': 30.0 * tokens})
    monkeypatch.setattr(tabinet.ABINet, 'language_forward',
                        lambda self, tokens, lengths, rng=None: {'logits': 30.0 * tokens})
    printed = _lm_tools_print(jckpt, tckpt, data)
    right = sum(w == w.lower() for w in LM_WORDS)
    assert 0 < right < len(LM_WORDS)
    assert printed['port'][-1].endswith(f'({right}/{len(LM_WORDS)})')
    assert printed['port'] == printed['jax']
