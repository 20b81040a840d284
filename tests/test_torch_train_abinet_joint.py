"""ABINet's joint stage on the CPU: one train step against the JAX package's
at microbatches 1 and 2 (tests/test_torch_train_families.py:check_train_step),
and a joint step with dropout at L = 256 that reaches neither attention
kernel."""

import numpy as np
import pytest
import torch

from parseq_tpu_torch.data import tokenizer as ttokenizer
from parseq_tpu_torch.models import abinet as tabinet
from parseq_tpu_torch.ops import attention, flash_bwd
from parseq_tpu_torch.train import optim
from parseq_tpu_torch.train.families import get_family
from parseq_tpu_torch.train.steps import init_state, make_train_step

from .test_torch_train_families import (CHARSET, GEOMETRY, MAX_LEN, OCFG, _raise, _words,
                                        check_train_step, one_torch_thread)  # noqa: F401


@pytest.mark.parametrize('microbatches', [1, 2])
def test_train_step_matches_jax(microbatches):
    check_train_step('abinet', {'pretraining': False}, microbatches)


def test_abinet_joint_step_with_dropout_calls_no_kernel(monkeypatch):
    """ABINet's vision transformer at L = 256 (32 x 128 images), dropout
    0.1: a joint train step never reaches B2 or B4."""
    monkeypatch.setattr(attention, 'fused_attention_nosplit', _raise)
    monkeypatch.setattr(flash_bwd, 'attention_flashbwd', _raise)
    kw = dict(GEOMETRY['abinet'][2], img_size=(32, 128), dropout=0.1, iter_size=1,
              num_tokens=len(CHARSET) + 3, max_label_length=MAX_LEN)
    model = tabinet.ABINet(tabinet.ABINetConfig(**kw))
    model.init_weights(torch.Generator().manual_seed(0))
    model.train()
    rng = np.random.default_rng(0)
    tok = ttokenizer.Tokenizer(CHARSET)
    batch = {'images': torch.from_numpy(rng.integers(0, 256, (2, 32, 128, 3)).astype(np.uint8)),
             **{k: torch.from_numpy(v) for k, v in get_family('abinet').prepare(
                 tok, _words(rng, 2), model.cfg, None).items()}}
    state = init_state(model, optim.OptimConfig(**OCFG))
    m = make_train_step(get_family('abinet'), model.cfg, torch.float32)(
        state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(m['loss'])) and np.isfinite(float(m['grad_norm']))


