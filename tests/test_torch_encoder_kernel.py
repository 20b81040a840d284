"""Kernel B5 (all encoder blocks in one kernel): the port's
stack_block_params and plain version against the JAX package's
(`fused_encoder_blocks` in interpret mode) and against the port's eager
blocks, and the CUDA kernel against the plain version on the card (marked
`gpu`, skipped without one).

The GPU host has no jax, so jax is imported inside the fixtures that need
it: there the JAX comparisons skip and the `gpu` cases run
(`python -m pytest --noconftest -m gpu tests/test_torch_encoder_kernel.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from parseq_tpu_torch.models import vit as tvit
from parseq_tpu_torch.ops import encoder_kernel

# (L, D, heads, depth): a cut width, and the JAX test's depth-2 PARSeq-S width.
GEOMETRIES = [(32, 96, 3, 2), (128, 384, 6, 2)]
# bf16 both sides with the same rounding points, f32 sums in another order:
# a value may round to the neighbouring bf16 step, and the flip carries
# through the following sublayers; two steps at |x| < 8 (2^-4).
BF16_ATOL = 2.0 ** -4


def _perturb(blocks, rng):
    """Non-trivial LayerNorm parameters and biases (vit.init draws unit scales
    and zero biases), so every operand of the kernel matters."""
    for norm in ('norm1', 'norm2'):
        blocks[norm]['scale'] = 1 + 0.1 * rng.standard_normal(blocks[norm]['scale'].shape)
        blocks[norm]['bias'] = 0.1 * rng.standard_normal(blocks[norm]['bias'].shape)
    for lin in (blocks['attn']['q'], blocks['attn']['k'], blocks['attn']['v'],
                blocks['attn']['out'], blocks['mlp']['fc1'], blocks['mlp']['fc2']):
        lin['b'] = 0.02 * rng.standard_normal(lin['b'].shape)
    return blocks


def _case(L, D, heads, depth, seed=0):
    """JAX vit.init blocks (perturbed, as float32 numpy) and the port's
    VisionTransformer carrying the same weights."""
    jax = pytest.importorskip('jax')
    from parseq_tpu.models import vit as jvit
    from parseq_tpu_torch.utils.convert import vit_state_dict

    kw = dict(img_size=(32, L), patch_size=(4, 8), embed_dim=D, depth=depth, num_heads=heads)
    params = jvit.init(jax.random.key(seed), jvit.ViTConfig(**kw))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    params['blocks'] = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        _perturb(params['blocks'], np.random.default_rng(seed)))
    enc = tvit.VisionTransformer(tvit.ViTConfig(**kw)).eval()
    enc.load_state_dict(vit_state_dict(params, prefix='', patch_size=(4, 8)), strict=True)
    return params['blocks'], enc


@pytest.fixture(scope='module')
def bench():
    """experiments/torch_encoder_kernel_bench.py as a module."""
    path = Path(__file__).resolve().parents[1] / 'experiments' / 'torch_encoder_kernel_bench.py'
    spec = importlib.util.spec_from_file_location('torch_encoder_kernel_bench', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _normal(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
                            ).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_stack_block_params_matches_jax(dtype):
    """The same values as JAX stack_block_params: weights transposed from
    (depth, in, out) to torch's (depth, out, in), vectors (depth, 1, n) ->
    (depth, n); LayerNorm parameters f32, the rest in `dtype`."""
    import jax.numpy as jnp
    from parseq_tpu.ops.encoder_kernel import stack_block_params as jax_stack

    blocks, enc = _case(32, 96, 3, 2)
    want = jax_stack(blocks, {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    got = encoder_kernel.stack_block_params(enc.blocks, dtype)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w.astype(jnp.float32))
        w = w.transpose(0, 2, 1) if name[0] == 'w' else w[:, 0]
        assert got[name].dtype == (torch.float32 if name.startswith('ln') else dtype), name
        assert got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].float().numpy(), w, err_msg=name)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('L,D,heads,depth', GEOMETRIES)
def test_plain_matches_jax_kernel(L, D, heads, depth, dtype):
    """The plain B5 against the Pallas kernel in interpret mode on the same
    weights and input. f32: the sums' order and the kernel's rational erf
    (1.5e-7) differ, atol 1e-4; bf16: BF16_ATOL."""
    import jax.numpy as jnp
    from parseq_tpu.ops.encoder_kernel import fused_encoder_blocks, stack_block_params

    blocks, enc = _case(L, D, heads, depth)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x = np.random.default_rng(1).standard_normal((3, L, D)).astype(np.float32)
    want = fused_encoder_blocks(stack_block_params(blocks, jdt), jnp.asarray(x, jdt),
                                num_heads=heads, block_b=1, interpret=True)
    before = encoder_kernel.launches
    got = encoder_kernel.fused_encoder_blocks(encoder_kernel.stack_block_params(enc.blocks, dtype),
                                              torch.from_numpy(x).to(dtype), num_heads=heads)
    assert encoder_kernel.launches == before  # no kernel launch for a CPU tensor
    assert got.dtype == dtype and got.shape == (3, L, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-4 if dtype == torch.float32 else BF16_ATOL)


@pytest.mark.parametrize('L,D,heads,depth', [(32, 96, 3, 2), (7, 64, 1, 3)])
def test_plain_matches_eager_blocks(bench, L, D, heads, depth):
    """At f32 the port's eager Blocks (exact GELU at f32) compute the same
    function as the plain B5: atol 1e-5, the sums in another order."""
    blocks = bench.make_blocks(depth, 0, D, heads, 4 * D)
    x = _normal((4, L, D), 1)
    with torch.no_grad():
        want = x
        for blk in blocks:
            want = blk(want)
    got = encoder_kernel.fused_encoder_blocks(encoder_kernel.stack_block_params(blocks, torch.float32),
                                              x, num_heads=heads)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_batch_rows_are_independent():
    """Any B: each image's output is the one it gets alone (B = 1 and 7)."""
    torch.manual_seed(1)
    cfg = tvit.ViTConfig(embed_dim=64, depth=2, num_heads=1)
    op = encoder_kernel.stack_block_params([tvit.Block(cfg) for _ in range(2)], torch.float32)
    x = torch.randn(7, 12, 64)
    together = encoder_kernel.fused_encoder_blocks(op, x, num_heads=1)
    alone = torch.cat([encoder_kernel.fused_encoder_blocks(op, x[i:i + 1], num_heads=1)
                       for i in range(7)])
    torch.testing.assert_close(together, alone, rtol=0, atol=1e-6)


_ATTENTION = encoder_kernel._attention


def _uniform_attention(q, k, v, scale):
    return _ATTENTION(q, k, v, 0.0)


def _other_heads_keys(q, k, v, scale):
    return _ATTENTION(q, k.roll(1, dims=1), v, scale)


def _last_keys_masked(q, k, v, scale):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s[..., -8:] = float('-inf')
    return (torch.softmax(s, dim=-1).to(q.dtype).float() @ v.float()).to(q.dtype)


@pytest.fixture(scope='module')
def full_geometry(bench):
    """PARSeq-S blocks of the bench's weights, an input of 2 images and the
    plain version's bf16 outputs at depth 1 and 12."""
    blocks = bench.make_blocks(12, bench.SEED)
    x = _normal((2, bench.L, bench.D), 5, torch.bfloat16)
    ops = {depth: encoder_kernel.stack_block_params(blocks[:depth]) for depth in (1, 12)}
    with torch.inference_mode():
        wants = {depth: encoder_kernel.fused_encoder_blocks_reference(op, x, bench.HEADS)
                 for depth, op in ops.items()}
    return x, ops, wants


@pytest.mark.parametrize('depth', [1, 12])
@pytest.mark.parametrize('fault', [_uniform_attention, _other_heads_keys, _last_keys_masked])
def test_b5_limits_catch_attention_faults(bench, full_geometry, monkeypatch, depth, fault):
    """The limits that hold B5 against its plain version (chip_smoke.py and
    the gpu case below) fail a plain version with a planted attention fault,
    on the weights and at the geometry the smoke checks: each exceeds the
    max limit and twice the mean limit."""
    x, ops, wants = full_geometry
    monkeypatch.setattr(encoder_kernel, '_attention', fault)
    with torch.inference_mode():
        bad = encoder_kernel.fused_encoder_blocks_reference(ops[depth], x, bench.HEADS)
    rel_max, rel_mean = bench.contribution_errors(bad, wants[depth], x)
    print(f'{fault.__name__} depth {depth}: relative max {rel_max:.4f}, mean {rel_mean:.4f}')
    limit_max, limit_mean = bench.B5_LIMITS[depth]
    assert rel_mean > 2 * limit_mean and rel_max > limit_max


_DENSE = encoder_kernel._dense


def _mlp2_last_slice_dropped(a, w, b):
    """MLP2 (the one product deeper than it is wide) without its last 64-deep
    k-slice: a ring step lost."""
    if w.shape[1] > w.shape[0]:
        a = a.clone()
        a[..., -64:] = 0
    return _DENSE(a, w, b)


def _rows_64_127_repeat_rows_0_63(a, w, b):
    """Every product's rows 64-127 (warpgroup 1's) given rows 0-63's."""
    out = _DENSE(a, w, b)
    out[:, 64:128] = out[:, 0:64]
    return out


def _qkv_bias_dropped(a, w, b):
    return _DENSE(a, w, torch.zeros_like(b) if w.shape[0] == 3 * w.shape[1] else b)


@pytest.mark.parametrize('depth', [1, 12])
@pytest.mark.parametrize('fault', [_mlp2_last_slice_dropped, _rows_64_127_repeat_rows_0_63,
                                   _qkv_bias_dropped])
def test_b5_limits_catch_product_faults(bench, full_geometry, monkeypatch, depth, fault):
    """B5_LIMITS fail a plain version with a planted fault in its matrix
    products, on the smoke's weights and geometry, as they do the attention
    faults above: each exceeds the max limit and twice the mean limit."""
    x, ops, wants = full_geometry
    monkeypatch.setattr(encoder_kernel, '_dense', fault)
    with torch.inference_mode():
        bad = encoder_kernel.fused_encoder_blocks_reference(ops[depth], x, bench.HEADS)
    rel_max, rel_mean = bench.contribution_errors(bad, wants[depth], x)
    print(f'{fault.__name__} depth {depth}: relative max {rel_max:.4f}, mean {rel_mean:.4f}')
    limit_max, limit_mean = bench.B5_LIMITS[depth]
    assert rel_mean > 2 * limit_mean and rel_max > limit_max


def test_bench_weights_make_attention_matter(bench, full_geometry):
    """With make_blocks' q/k/v weights the first layer's scores spread by
    about SCORE_STD (well away from a uniform softmax)."""
    x, ops, _ = full_geometry
    op = ops[1]
    h = encoder_kernel._ln(x.float(), op['ln1_s'][0], op['ln1_b'][0])
    q, k, _ = (h @ op['wqkv'][0].float().t()).split(bench.D, dim=-1)
    dh = bench.D // bench.HEADS
    scores = torch.einsum('bqhd,bkhd->bhqk', q.unflatten(-1, (bench.HEADS, dh)),
                          k.unflatten(-1, (bench.HEADS, dh))) * dh ** -0.5
    assert 0.7 * bench.SCORE_STD < float(scores.std(-1).mean()) < 1.3 * bench.SCORE_STD


def test_bench_library_yardstick_is_the_same_function(bench):
    """The bench's nn.TransformerEncoder, loaded with the blocks' weights,
    computes what the eager blocks do (f32, inference: its fused fast path;
    atol 1e-4, the sums in another order)."""
    blocks = bench.make_blocks(2, seed=3)
    x = torch.randn(2, bench.L, bench.D, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        torch.testing.assert_close(bench.library_encoder(blocks)(x), bench.eager(blocks, x),
                                   rtol=0, atol=1e-4)


def test_bench_runs_the_plain_versions_on_cpu(bench):
    result = bench.main(['--device', 'cpu', '--batch', '2', '--depth', '1'])
    assert result['max_abs_diff_f32'] <= 1e-5
    assert result['flops'] == 2 * 2 * 128 * 384 * (4 * 384 + 2 * 128 + 2 * 1536)


def test_bench_without_a_card_raises(bench):
    if torch.cuda.is_available():
        pytest.skip('the host has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.main(['--batch', '2', '--depth', '1'])


def test_other_devices_raise():
    cfg = tvit.ViTConfig(embed_dim=64, depth=1, num_heads=1)
    op = encoder_kernel.stack_block_params([tvit.Block(cfg)])
    with pytest.raises(ValueError, match='unsupported device'):
        encoder_kernel.fused_encoder_blocks(op, torch.empty(1, 8, 64, device='meta'), num_heads=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('B,L,D,heads,F,depth', [(1, 128, 384, 6, 1536, 2),
                                                 (7, 128, 384, 6, 1536, 2),
                                                 # PARSeq-S's read batch: two
                                                 # waves of two blocks an SM
                                                 # on 132 SMs; and one block
                                                 # into the second wave
                                                 (512, 128, 384, 6, 1536, 12),
                                                 (265, 128, 384, 6, 1536, 12),
                                                 (3, 37, 128, 2, 256, 3),
                                                 # Depth 1 (the tight limits).
                                                 # L <= 64: warpgroup 0 alone
                                                 # has rows; 65: one in
                                                 # warpgroup 1
                                                 (3, 1, 384, 6, 1536, 1),
                                                 (3, 37, 384, 6, 1536, 1),
                                                 (3, 64, 384, 6, 1536, 1),
                                                 (3, 65, 384, 6, 1536, 1),
                                                 (3, 127, 384, 6, 1536, 1),
                                                 (3, 128, 512, 8, 2048, 1),
                                                 (3, 128, 384, 6, 128, 1),
                                                 (3, 128, 384, 6, 2048, 1)])
def test_cuda_kernel_matches_plain(bench, cuda_device, B, L, D, heads, F, depth):
    """bf16 kernel against the plain version on the card (f32 matmuls, TF32
    off), on weights where attention matters: the same rounding points, sums
    in another order, within the bench's B5_LIMITS relative to what the
    blocks add."""
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = bench.make_blocks(depth, B + L, D, heads, F)
    op = {k: v.to(cuda_device) for k, v in encoder_kernel.stack_block_params(blocks).items()}
    x = _normal((B, L, D), B + L).to(cuda_device, torch.bfloat16)
    before = encoder_kernel.launches
    got = encoder_kernel.fused_encoder_blocks(op, x, num_heads=heads)
    torch.cuda.synchronize()
    assert encoder_kernel.launches == before + 1
    want = encoder_kernel.fused_encoder_blocks_reference(op, x, heads)
    assert got.shape == (B, L, D) and torch.isfinite(got.float()).all()
    rel_max, rel_mean = bench.contribution_errors(got, want, x)
    limit_max, limit_mean = bench.B5_LIMITS[1 if depth == 1 else 12]
    assert rel_max <= limit_max and rel_mean <= limit_mean
