"""Fused AR decode (kernel B1): the port's plain version against the JAX
Pallas kernel in interpret mode, the shared card check (ops/ar_kernel.py:
check_model, check_run, CHECK_LIMITS) against faults planted in the plain
version, and the CUDA kernel against the plain version on the card through
that check (marked `gpu`, skipped without one).

Comparison method of tests/test_fused_attention.py: random weights make
near-tie greedy picks, so besides the direct comparison one side is
teacher-forced on the other's token prefix and logits compare step by step.

The GPU host has no jax, so jax is imported inside the fixture that needs
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest -m gpu tests/test_torch_ar_kernel.py`).
"""

import contextlib

import numpy as np
import pytest
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
from parseq_tpu_torch.ops import ar_kernel
from parseq_tpu_torch.utils.convert import state_dict_from_jax

# bf16 matmul inputs on both sides; f32 accumulation in another order and
# erf (exact vs the JAX kernel's polynomial, |err| < 1.5e-7).
ATOL = 2e-2
# Greedy picks must agree wherever the top-2 margin exceeds the bf16 noise.
MARGIN = 0.05

KW = dict(num_tokens=13, max_label_length=7, img_size=(32, 64), patch_size=(4, 8),
          embed_dim=48, enc_num_heads=4, enc_depth=1, dec_num_heads=6, dec_depth=1)


@pytest.fixture(scope='module')
def setup():
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from parseq_tpu.models import parseq as jparseq
    from parseq_tpu.ops.ar_kernel import ar_decode_fused as jax_ar_decode_fused

    jcfg = jparseq.PARSeqConfig(**KW)
    params = jparseq.init(jax.random.key(3), jcfg)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((4, 32, 64, 3)).astype(np.float32))
    memory = jparseq.encode(params, jcfg, images).astype(jnp.bfloat16)
    model = PARSeq(PARSeqConfig(**KW)).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    mem_t = torch.from_numpy(np.array(memory.astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jax_ar_decode_fused(params, jcfg, memory, batch_block=2, interpret=True))
    return model, mem_t, want


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL)
    top2 = np.sort(want, -1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[confident], want.argmax(-1)[confident])


@pytest.mark.parametrize('mode', ['greedy', 'teacher_forced'])
def test_plain_matches_jax_kernel(setup, mode):
    model, memory, want = setup
    tokens = torch.from_numpy(want.argmax(-1)) if mode == 'teacher_forced' else None
    got = ar_kernel.ar_decode_fused_reference(model, memory, tokens=tokens).numpy()
    assert got.shape == want.shape == (4, model.cfg.num_steps, model.cfg.num_classes)
    _assert_close(got, want)


def test_cpu_tensor_takes_plain_version(setup):
    model, memory, _ = setup
    before = ar_kernel.launches
    got = ar_kernel.ar_decode_fused(model, memory)
    assert ar_kernel.launches == before  # no kernel launch on the CPU
    np.testing.assert_array_equal(
        got.numpy(), ar_kernel.ar_decode_fused_reference(model, memory).numpy())


# The policy of the card's B x R table (PERF.md §6, B1): the fewest rows a
# block that keep the grid within one wave.
@pytest.mark.parametrize('batch,sms,rows', [(1, 132, 1), (7, 132, 1), (64, 132, 1),
                                            (132, 132, 1), (133, 132, 2), (256, 132, 2),
                                            (300, 132, 4), (512, 132, 4), (2000, 132, 8)])
def test_rows_per_block_fills_one_wave(batch, sms, rows):
    assert ar_kernel.rows_per_block(batch, sms) == rows


@pytest.mark.parametrize('change,decoded', [
    ({}, True),  # PARSeq-S's read on the card
    ({'device': 'cuda:0'}, True),
    ({'device': 'cpu'}, False),
    ({'dec_depth': 2}, False),
    ({'decode_ar': False}, False),  # the NAR decode
    ({'plain': True}, False),  # inside kernels.plain() (comparisons, the FLOP count)
], ids=repr)
def test_gate_decision_table(change, decoded):
    """ar_kernel.takes, B1's gate in PARSeq.forward: greedy AR decoding, a
    one-layer decoder, a CUDA device, outside kernels.plain()."""
    case = {'device': torch.device('cuda'), 'dec_depth': 1, 'decode_ar': True, 'plain': False,
            **change}
    cfg = PARSeqConfig(dec_depth=case['dec_depth'], decode_ar=case['decode_ar'])
    with kernels.plain() if case['plain'] else contextlib.nullcontext():
        assert ar_kernel.takes(cfg, case['device']) is decoded


@pytest.mark.parametrize('takes', [True, False])
def test_forward_decodes_where_the_gate_says(monkeypatch, takes):
    """PARSeq.forward asks ar_kernel.takes and finds ar_decode_fused on the
    module when it calls it (a wrapper set on the module attribute sees the
    call), with bf16 memory; elsewhere it calls its own ar_decode."""
    model = PARSeq(PARSeqConfig(**KW)).eval()
    calls = []
    real_fused, real_scan = ar_kernel.ar_decode_fused, model.ar_decode
    monkeypatch.setattr(ar_kernel, 'takes', lambda cfg, device: takes)
    monkeypatch.setattr(ar_kernel, 'ar_decode_fused', lambda m, memory: (
        calls.append(('fused', memory.dtype)) or real_fused(m, memory)))
    monkeypatch.setattr(model, 'ar_decode', lambda memory, dtype: (
        calls.append(('scan', dtype)) or real_scan(memory, dtype)))
    with torch.no_grad():
        logits = model(torch.zeros(2, 32, 64, 3))
    assert calls == [('fused', torch.bfloat16) if takes else ('scan', torch.float32)]
    assert logits.shape == (2, model.cfg.num_steps, model.cfg.num_classes)


# The card check's faults, planted in the plain version at PARSeq-S's full
# width: each changes what one product, the self-attention or the head
# computes, as a kernel fault would (a lost bias, a lost ring stage, a
# misrouted column of the n8 operand, a missed key, classes never stored).
def _zero_last_slice(x):
    x = x.clone()
    x[..., -64:] = 0
    return x


def _row1_gets_row0(y):
    y = y.clone()
    y[1] = y[0]
    return y


def _classes_dropped(y):
    y = y.clone()
    y[..., 80:95] = 0
    return y


def _product_fault(name, fault):
    """Patches _linear so that product `name` computes fault(plain, x, c)."""
    return lambda plain: lambda x, c, n: fault(plain, x, c) if n == name else plain(x, c, n)


# name: (attribute of ar_kernel, function of the plain attribute -> the faulty one)
FAULTS = {
    'mlp2_bias_dropped': ('_linear', _product_fault(
        '2', lambda plain, x, c: ar_kernel._dot(x, c['w_2']))),
    'mlp1_last_k_slice_dropped': ('_linear', _product_fault(
        '1', lambda plain, x, c: plain(_zero_last_slice(x), c, '1'))),
    'row1_gets_row0_out_proj': ('_linear', _product_fault(
        'o', lambda plain, x, c: _row1_gets_row0(plain(x, c, 'o')))),
    'key_i_left_out_of_self_attention': ('_self_attention', lambda plain: (
        lambda q, k, v, i, scale: plain(q, k, v, max(i - 1, 0), scale))),
    'head_classes_80_94_dropped': ('_linear', _product_fault(
        'h', lambda plain, x, c: _classes_dropped(plain(x, c, 'h')))),
}


@pytest.fixture(scope='module')
def check_setup():
    cfg = PARSeqConfig()
    model = ar_kernel.check_model(cfg, 0)
    return model, ar_kernel.check_memory(3, 128, cfg.embed_dim, 1)


@pytest.mark.parametrize('fault', FAULTS)
def test_planted_fault_fails_check(check_setup, monkeypatch, fault):
    model, memory = check_setup
    attr, make = FAULTS[fault]
    with monkeypatch.context() as m:
        m.setattr(ar_kernel, attr, make(getattr(ar_kernel, attr)))
        got = ar_kernel.ar_decode_fused_reference(model, memory)
    want = ar_kernel.ar_decode_fused_reference(model, memory, tokens=got.argmax(-1))
    rel_max, rel_mean = ar_kernel.check_errors(got, want)
    assert not ar_kernel.check_passes(got, want)
    # Caught by both limits, not by one alone.
    assert rel_max > ar_kernel.CHECK_LIMITS[0] and rel_mean > ar_kernel.CHECK_LIMITS[1]


def test_sum_order_noise_passes_check(check_setup, monkeypatch):
    """The plain version with its products summed in float64 (another order
    and rounding of the f32 sums, as the kernel's) passes the check."""
    model, memory = check_setup
    want = ar_kernel.ar_decode_fused_reference(model, memory)
    with monkeypatch.context() as m:
        m.setattr(ar_kernel, '_dot', lambda a, w: (a.to(torch.bfloat16).double()
                                                   @ w.to(torch.bfloat16).double().t()).float())
        got = ar_kernel.ar_decode_fused_reference(model, memory, tokens=want.argmax(-1))
    want = ar_kernel.ar_decode_fused_reference(model, memory, tokens=want.argmax(-1))
    assert not torch.equal(got, want)
    assert ar_kernel.check_passes(got, want)
    assert ar_kernel.check_greedy(got, want)[1] > 0


def test_check_model_draws_every_decoder_parameter():
    cfg = PARSeqConfig(num_tokens=13, max_label_length=7, img_size=(32, 64), embed_dim=64,
                       enc_num_heads=2, enc_depth=1, dec_num_heads=2)
    a, b = ar_kernel.check_model(cfg, 5), ar_kernel.check_model(cfg, 5)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        if name.startswith('encoder.'):
            continue
        assert torch.equal(pa, pb), name  # numpy draws: the same on every host
        assert float(pa.detach().std()) > 0.05, name  # biases and LayerNorm parameters included


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _card_check(model, memory, rows=None):
    before = ar_kernel.launches
    got, want, rel_max, rel_mean, passes = ar_kernel.check_run(model, memory, rows=rows)
    torch.cuda.synchronize()
    assert ar_kernel.launches == before + 1
    assert got.shape == (memory.shape[0], model.cfg.num_steps, model.cfg.num_classes)
    assert passes, f'rel max {rel_max:.3e}, mean {rel_mean:.3e}, limits {ar_kernel.CHECK_LIMITS}'


SMALL = dict(num_tokens=13, max_label_length=7, img_size=(32, 64), embed_dim=64,
             enc_num_heads=2, enc_depth=1, dec_num_heads=2)


@pytest.mark.gpu
@pytest.mark.parametrize('batch', [1, 3, 9])
def test_cuda_kernel_matches_plain(cuda_device, batch):
    """dh must be 32 for the kernel: D=64 with 2 decoder heads."""
    model = ar_kernel.check_model(PARSeqConfig(**SMALL), batch).to(cuda_device)
    _card_check(model, ar_kernel.check_memory(batch, 64, 64, 0, cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize('rows', [1, 2, 4, 8])
def test_cuda_kernel_small_config_every_rows(cuda_device, rows):
    """The D = 64, 2-head model at B = 9: a ragged last block at every R."""
    model = ar_kernel.check_model(PARSeqConfig(**SMALL), 0).to(cuda_device)
    _card_check(model, ar_kernel.check_memory(9, 64, 64, 1, cuda_device), rows)


@pytest.mark.gpu
@pytest.mark.parametrize('memory_rows', [1, 128, 196])
@pytest.mark.parametrize('rows', [1, 2, 4, 8])
def test_cuda_kernel_full_width_every_rows(cuda_device, rows, memory_rows):
    """PARSeq-S's decoder at B = 9 (R = 8 leaves 7 columns of the last
    block's n8 operand empty) against M = 1, 128 (PARSeq-S) and 196
    (patch16-224) memory rows."""
    cfg = PARSeqConfig()
    model = ar_kernel.check_model(cfg, 0).to(cuda_device)
    _card_check(model, ar_kernel.check_memory(9, memory_rows, cfg.embed_dim, 1, cuda_device),
                rows)
