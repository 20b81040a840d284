"""The port's int8 serving path (ops/quant.py) against the JAX package's
(parseq_tpu/ops/quant.py) on the CPU: the weight codes and scales exactly
(the packed qkv's codes are JAX's q, k and v concatenated), int8_linear's
activation codes and int32 accumulations exactly and its outputs to 1e-6
relative, the quantized encoder and PARSeq and ViTSTR reads at f32 within
the tolerances below, the families quantize_bundle refuses, 4 int8 products
a block, the card check's planted faults, and --int8 in cli.read, cli.test,
cli.bench (its MACs equal to the bf16 run's and to the JAX count) and
cli.serve."""

import contextlib
import functools
import io
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from parseq_tpu.cli import read as jax_read_cli
from parseq_tpu.cli import test as jax_test_cli
from parseq_tpu.data import module as jmodule
from parseq_tpu.models import parseq as jparseq
from parseq_tpu.ops import attention as jattention
from parseq_tpu.ops import quant as jquant
from parseq_tpu.utils import config as jconfig
from parseq_tpu.utils import registry as jregistry
from parseq_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from parseq_tpu.utils.flops import count_flops as jax_count_flops
from parseq_tpu_torch.cli import bench as bench_cli
from parseq_tpu_torch.cli import read as read_cli
from parseq_tpu_torch.cli import serve as serve_cli
from parseq_tpu_torch.cli import test as test_cli
from parseq_tpu_torch.ops import quant
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.convert import state_dict_from_jax, vitstr_state_dict_from_jax

from .test_lmdb import _png_bytes, make_str_db

PARSEQ = dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6, max_label_length=10)
VITSTR = dict(embed_dim=48, num_heads=4, depth=2, max_label_length=10)
# Port int8 vs JAX int8, f32, the same weights and images: 3x the largest
# |difference| over seeds 0-4 (encoder output 5.754e-3 of max ~4, where an
# activation code rounds the other way on a last-bit difference of its
# input; PARSeq logits 4.591e-5; ViTSTR logits 5.107e-6).
ENCODER_ATOL = 1.8e-2
PARSEQ_LOGITS_ATOL = 1.4e-4
VITSTR_LOGITS_ATOL = 1.6e-5


def _pair(experiment='parseq', seed=0):
    overrides = PARSEQ if experiment == 'parseq' else VITSTR
    jb = jregistry.create_model(experiment, seed=seed, dtype=jnp.float32, **overrides)
    tb = registry.create_model(experiment, device='cpu', dtype=torch.float32, **overrides)
    sd = (state_dict_from_jax(jb.params) if experiment == 'parseq'
          else vitstr_state_dict_from_jax(jb.params, jb.cfg.patch_size))
    tb.module.load_state_dict(sd, strict=True)
    return jb, tb


def _varied_weight(seed, out_features, in_features):
    """Rows of different norms, as a trained model's."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_features, in_features)).astype(np.float32)
    return w * np.exp(rng.uniform(-2, 2, (out_features, 1))).astype(np.float32)


@pytest.mark.parametrize('shape', [(24, 16), (1152, 384), (384, 1536)])
def test_weight_codes_and_scales_equal_jax(shape):
    w = _varied_weight(sum(shape), *shape)
    w[3] = 0.0  # an all-zero row: the 1e-12 scale floor
    w_q, w_scale = quant.quantize_weight(torch.from_numpy(w))
    want = jquant.quantize_linear({'w': jnp.asarray(w.T)})
    assert w_q.dtype == torch.int8 and w_q.shape == shape and w_q.is_contiguous()
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(want['w_q']).T)
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(want['w_scale']))


def test_packed_qkv_codes_are_jax_q_k_v_concatenated():
    jb, tb = _pair(seed=2)
    jenc = jquant.quantize_vit_encoder(jb.params['encoder'])['blocks']
    qenc = quant.quantize_vit_encoder(tb.module.encoder)
    for i, blk in enumerate(qenc.blocks):
        for port, jax_keys in (('attn.qkv', ('attn.q', 'attn.k', 'attn.v')),
                               ('attn.proj', ('attn.out',)), ('mlp.fc1', ('mlp.fc1',)),
                               ('mlp.fc2', ('mlp.fc2',))):
            lin = blk.get_submodule(port)
            parts = [functools.reduce(dict.__getitem__, k.split('.'), jenc) for k in jax_keys]
            np.testing.assert_array_equal(
                lin.w_q.numpy(), np.concatenate([np.asarray(p['w_q'][i]).T for p in parts]))
            np.testing.assert_array_equal(
                lin.w_scale.numpy(), np.concatenate([np.asarray(p['w_scale'][i]) for p in parts]))
            np.testing.assert_array_equal(
                lin.bias.numpy(), np.concatenate([np.asarray(p['b'][i]) for p in parts]))
    assert isinstance(tb.module.encoder.blocks[0].attn.qkv, torch.nn.Linear)  # untouched


@pytest.mark.parametrize('seed', range(3))
def test_int8_linear_equals_jax(seed):
    rng = np.random.default_rng(seed)
    w = _varied_weight(seed, 64, 48)
    b = rng.standard_normal(64).astype(np.float32)
    x = (rng.standard_normal((3, 17, 48)) * np.exp(rng.uniform(-3, 3, (3, 17, 1)))).astype(
        np.float32)
    x[0, 0] = 0.0  # an all-zero token: the 1e-12 scale floor
    lin = quant.quantize_linear(torch.nn.Linear(48, 64))
    lin.w_q, lin.w_scale = quant.quantize_weight(torch.from_numpy(w))
    lin.bias = torch.from_numpy(b)
    jp = jquant.quantize_linear({'w': jnp.asarray(w.T), 'b': jnp.asarray(b)})
    got = quant.int8_linear(torch.from_numpy(x), lin.weight, lin.bias).numpy()
    want = np.asarray(jquant.int8_linear(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the activation codes and the int32 accumulations, exactly
    x2 = x.reshape(-1, 48)
    x_q, x_scale = quant.quantize_activations(torch.from_numpy(x2))
    ax = jnp.max(jnp.abs(jnp.asarray(x2)), axis=-1, keepdims=True)
    jscale = jnp.maximum(ax / 127.0, 1e-12)
    jx_q = jnp.clip(jnp.round(jnp.asarray(x2) / jscale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(x_scale.numpy(), np.asarray(jscale))
    jacc = jax.lax.dot_general(jx_q, jp['w_q'], (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    acc = quant.int8_accumulate(x_q, lin.w_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # bf16 activations: the same f32 arithmetic, cast at the end
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gotb = quant.int8_linear(xb, lin.weight, lin.bias)
    wantb = jquant.int8_linear(jp, jnp.asarray(x).astype(jnp.bfloat16))
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), np.asarray(wantb.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8 * float(np.abs(want).max()))


@pytest.mark.parametrize('seed', range(5))
def test_quantized_parseq_and_vitstr_match_jax(seed):
    jb, tb = _pair('parseq', seed)
    jq, tq = jquant.quantize_bundle(jb), quant.quantize_bundle(tb)
    x = np.random.default_rng(seed).uniform(-1, 1, (4, 32, 128, 3)).astype(np.float32)
    want_mem = np.asarray(jax.jit(lambda p, im: jparseq.encode(p, jq.cfg, im))(
        jq.params, jnp.asarray(x)))
    with torch.no_grad():
        got_mem = tq.module.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_mem, want_mem, atol=ENCODER_ATOL)
    want = np.asarray(jax.jit(jq.forward_fn)(jq.params, jnp.asarray(x)))
    np.testing.assert_allclose(tq(x).numpy(), want, atol=PARSEQ_LOGITS_ATOL)
    labels, conf = tq.read(x)
    want_labels, want_conf = jq.read(jnp.asarray(x))
    assert labels == want_labels
    np.testing.assert_allclose(conf, want_conf, rtol=1e-3)
    jv, tv = _pair('vitstr', seed)
    jqv, tqv = jquant.quantize_bundle(jv), quant.quantize_bundle(tv)
    xv = np.random.default_rng(seed).uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    np.testing.assert_allclose(tqv(xv).numpy(),
                               np.asarray(jax.jit(jqv.forward_fn)(jqv.params, jnp.asarray(xv))),
                               atol=VITSTR_LOGITS_ATOL)


REFUSED = {'crnn': dict(hidden_size=16),
           'trba': dict(hidden_size=16, output_channel=32, max_label_length=6),
           'trbc': dict(hidden_size=16, output_channel=32),
           'abinet': dict(nhead=4, d_inner=128, v_num_layers=1, l_num_layers=1, iter_size=2)}


@pytest.mark.parametrize('experiment', sorted(REFUSED))
def test_quantize_bundle_refuses_what_jax_refuses(experiment):
    tb = registry.create_model(experiment, device='cpu', **REFUSED[experiment])
    with pytest.raises(ValueError, match='ViT'):
        quant.quantize_bundle(tb)
    # the JAX side on abstract parameters (jax.eval_shape of the init): its
    # check reads the tree's structure only
    model_cfg = dict(jconfig.compose(experiment)['model'], **REFUSED[experiment])
    build = jregistry._BUILDERS[jregistry._family(experiment)]
    init_fn = build(jregistry._TrackedCfg(model_cfg), jnp.float32)[3]
    jb = types.SimpleNamespace(name=experiment, params=jax.eval_shape(init_fn, jax.random.key(0)))
    with pytest.raises(ValueError, match='ViT'):
        jquant.quantize_bundle(jb)


@pytest.mark.parametrize('experiment', ['parseq', 'vitstr'])
def test_four_int8_products_a_block_and_the_original_untouched(experiment):
    """PARSeq at L = 128 (mha's attention after the packed product) and
    ViTSTR at L = 197 (the packed product feeding B2's plain version)."""
    _, tb = _pair(experiment)
    before = {k: v.clone() for k, v in tb.module.state_dict().items()}
    tq = quant.quantize_bundle(tb)
    x = np.random.default_rng(0).uniform(-1, 1, (2, *tb.img_size, 3)).astype(np.float32)
    with quant.count_int_mm() as c:
        tq(x)
    depth = len(tq.module.encoder.blocks if experiment == 'parseq' else tq.module.blocks)
    assert c.calls == 4 * depth
    with quant.count_int_mm() as c:
        tb(x)
    assert c.calls == 0
    assert all(torch.equal(v, before[k]) for k, v in tb.module.state_dict().items())
    with pytest.raises(KeyError, match='not an nn.Linear'):
        quant.quantize_tree(tq.module, ['head.bias'])


def test_cuda_shapes_that_int_mm_refuses_raise():
    cuda = torch.device('cuda')
    for M, K, N in ((16, 384, 384), (128, 380, 384), (128, 384, 380)):
        with pytest.raises(ValueError, match='M > 16'):
            quant._check_shape(M, K, N, cuda)
    quant._check_shape(17, 384, 1152, cuda)
    quant._check_shape(1, 3, 5, torch.device('cpu'))


@pytest.mark.parametrize('experiment', ['parseq', 'vitstr'])
def test_card_check_passes_int8_and_fails_the_planted_faults(experiment):
    """chip_smoke.py's int8 check at a small width in bf16: the int8 model
    passes, and its reads equal the reference's wherever the margins decide
    them; codes with per-input-channel scales fail it; a block's fc2 left
    unquantized changes the int8 product count."""
    _, tb = _pair(experiment, seed=1)
    quant.spread_rows(tb.module, 1)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, *tb.img_size, 3)).astype(np.float32))
    ref = quant.check_logits(tb.module, x, torch.bfloat16)
    tq = quant.quantize_bundle(tb)
    rel, _, agree, passes = quant.check_errors(quant.check_logits(tq.module, x, torch.bfloat16),
                                               ref, quant.CHECK_LIMITS[experiment])
    assert passes, (rel, agree)
    positions, agree, decided = quant.check_reads(tq(x), tb(x), tb.tokenizer.eos_id)
    reads, want = tq.read(x)[0], tb.read(x)[0]
    assert agree and positions > 0 and decided.any()
    assert all(a == b for a, b, d in zip(reads, want, decided.tolist()) if d), (reads, want)
    faulty = quant.planted_fault(tb.module, tb.name, 'input_channel_scales')
    rel_f, _, _, passes = quant.check_errors(quant.check_logits(faulty, x, torch.bfloat16),
                                             ref, quant.CHECK_LIMITS[experiment])
    assert not passes and rel_f > 3 * rel
    partial = quant.planted_fault(tb.module, tb.name, 'fc2_unquantized')
    with quant.count_int_mm() as c:
        quant.check_logits(partial, x, torch.bfloat16)
    vit = tb.module.encoder if experiment == 'parseq' else tb.module
    assert c.calls == 4 * len(vit.blocks) - 1
    assert isinstance(partial.get_submodule(
        f'{"encoder." if experiment == "parseq" else ""}blocks.{len(vit.blocks) - 1}.mlp.fc2'),
        torch.nn.Linear)
    with pytest.raises(ValueError, match='none of'):
        quant.planted_fault(tb.module, tb.name, 'no_such_fault')


def test_check_reads_decides_images_by_their_margin():
    """Image 0 (EOS at step 1) has margins of 2 through its EOS; image 1 (no
    EOS) has a step of margin 0.05. Against an error of 0.1, image 0 is
    decided and image 1 is not. A pick may differ where the margin is below
    its image's error, and not where it is above."""
    eos = 0
    want = torch.zeros(2, 3, 4)
    want[0, 0, 2] = want[0, 1, eos] = 2.0
    want[1, 0, 1], want[1, 1, 3], want[1, 1, 2], want[1, 2, 1] = 2.0, 1.0, 0.95, 2.0
    got = want.clone()
    got[:, :, 3] += 0.1
    positions, agree, decided = quant.check_reads(got, want, eos)
    assert agree and positions == 4 and decided.tolist() == [True, False]
    got[1, 2, 3] += 2.0  # image 1, step 2 flips: margin 2, its image's error now 2.1
    got[0, 0, 3] += 2.0  # image 0, step 0 flips: likewise, and image 0 is no longer decided
    positions, agree, decided = quant.check_reads(got, want, eos)
    assert agree and positions == 0 and decided.tolist() == [False, False]
    bad = want.clone()
    bad[0, 0, 2], bad[0, 0, 1] = 1.0, 1.05  # image 0, step 0 flips with an error of 1.05 < 2
    assert not quant.check_reads(bad, want, eos)[1]


# ------------------------------------------------------------------- CLIs ---


def _images(tmp_path, n=3, size=(32, 128)):
    paths = []
    for i, px in enumerate(np.random.default_rng(4).integers(0, 256, (n, *size, 3), np.uint8)):
        paths.append(str(tmp_path / f'{i}.png'))
        Image.fromarray(px).save(paths[-1])
    return paths


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _jax_ckpt(tmp_path, name='parseq-small.ckpt'):
    jb, _ = _pair()
    mcfg = dict(jconfig.compose('parseq')['model'], **PARSEQ)
    path = tmp_path / name
    jax_save_checkpoint(path, jb.params, jb.cfg, meta={'name': 'parseq', 'model_config': mcfg})
    return str(path)


def test_read_cli_int8_equals_the_jax_cli(tmp_path, monkeypatch):
    ckpt, paths = _jax_ckpt(tmp_path), _images(tmp_path)
    monkeypatch.setattr(jax_read_cli, 'load_from_checkpoint', functools.partial(
        jregistry.load_from_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(read_cli, 'load_from_checkpoint', functools.partial(
        registry.load_from_checkpoint, dtype=torch.float32))
    want = _run(jax_read_cli.main, [ckpt, '--images', *paths, '--int8'])
    got = _run(read_cli.main, [ckpt, '--images', *paths, '--int8', '--device', 'cpu'])
    assert got == want and got.count('(conf=') == 3
    assert got != _run(read_cli.main, [ckpt, '--images', *paths, '--device', 'cpu'])


def test_test_cli_int8_tables_equal_the_jax_cli(tmp_path, monkeypatch):
    root = tmp_path / 'data'
    for name in sorted(set(jmodule.TEST_BENCHMARK + jmodule.TEST_BENCHMARK_SUB)):
        make_str_db(root / 'test' / name, [(_png_bytes(), 'ab'), (_png_bytes(), 'cde')])
    ckpt = _jax_ckpt(tmp_path)
    monkeypatch.setattr(jax_test_cli, 'load_from_checkpoint', functools.partial(
        jregistry.load_from_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(test_cli, 'load_from_checkpoint', functools.partial(
        registry.load_from_checkpoint, dtype=torch.float32))
    args = ['--data_root', str(root), '--batch_size', '4', '--num_workers', '0', '--int8']
    want = _run(jax_test_cli.main, [ckpt, *args])
    got = _run(test_cli.main, [ckpt, *args, '--device', 'cpu'])
    assert got == want and '| Combined' in got


def test_bench_cli_int8_macs_equal_bf16_and_jax():
    args = ['--model', 'parseq', '--device', 'cpu', '--iters', '1', '--trials', '1',
            *(f'{k}:int={v}' for k, v in PARSEQ.items())]
    (bf16,) = bench_cli.main(args)
    (int8,) = bench_cli.main(args + ['--int8'])
    assert int8['flops_per_img_G'] == bf16['flops_per_img_G'] > 0
    assert int8['params_M'] == pytest.approx(bf16['params_M'], abs=2e-3)
    # exact MACs: the port's count through the int8 encoder, the JAX walk's
    # through its quantized tree (scan AR path, einsum attention, as both benches)
    jb, tb = _pair()
    jq, tq = jquant.quantize_bundle(jb), quant.quantize_bundle(tb)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    with jattention.force_einsum():
        want = jax_count_flops(lambda p, im: jparseq.forward(p, jq.cfg, im, use_fused_ar=False),
                               jq.params, jnp.asarray(x)) / 2
    got = bench_cli.per_image_flops(tq, torch.from_numpy(x))
    assert got == want == bench_cli.per_image_flops(tb, torch.from_numpy(x))


def test_serve_cli_int8_serves_a_quantized_bundle(tmp_path, monkeypatch):
    ckpt = _jax_ckpt(tmp_path)
    served = {}

    class _Httpd:
        def __init__(self, addr, handler):
            served['handler'] = handler

        def serve_forever(self):  # returns at once: main closes the server and stops
            served['served'] = True

        def server_close(self):
            served['closed'] = True

    def make_handler(srv, bundle):
        served['bundle'] = bundle
        return object

    monkeypatch.setattr(serve_cli, 'ThreadingHTTPServer', _Httpd)
    monkeypatch.setattr(serve_cli, 'make_handler', make_handler)
    _run(serve_cli.main, [ckpt, '--int8', '--device', 'cpu', '--no_warmup'])
    bundle = served['bundle']
    assert served['served'] and served['closed'] and isinstance(bundle.module.encoder.blocks[0].mlp.fc2,
                                           quant.Int8Linear)
    with quant.count_int_mm() as c:
        bundle.read(np.zeros((1, 32, 128, 3), np.float32))
    assert c.calls == 4 * PARSEQ['enc_depth']
