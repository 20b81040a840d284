"""The route of a ViT encoder's blocks to kernel B5 (models/vit.py:
takes_encoder_kernel, VisionTransformer.stacked_blocks / fused_blocks):
the gate's decision table, the stacked operands kept between calls and
stacked anew after a parameter changes, a CPU forward that never takes the
route, the benchmark's readers of the route, and (marked `gpu`, skipped
without a card) PARSeq-S routed at B = 512 against its eager blocks, and a
routed read forward that never makes the host wait for the card.

No jax import: the GPU host runs the `gpu` case
(`python -m pytest --noconftest -m gpu tests/test_torch_encoder_route.py`).
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.models import vit
from parseq_tpu_torch.ops import encoder_kernel, quant
from parseq_tpu_torch.ops.layers import layer_norm
from parseq_tpu_torch.train.optim import AdamW, OptimConfig
from parseq_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
# kMaxL of the kernel's source: what library().parseq_encoder_blocks_max_len()
# returns on the card (the library is not built here)
K_MAX_L = int(re.search(r'constexpr int kMaxL = (\d+);',
                        (encoder_kernel.CSRC / 'encoder_blocks.cu').read_text()).group(1))


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library unbuildable: the gate must answer without it."""
    def refuse():
        raise AssertionError('the gate built or loaded the B5 library')

    monkeypatch.setattr(encoder_kernel, 'library', refuse)


@pytest.fixture(scope='module')
def bench():
    """experiments/torch_encoder_kernel_bench.py as a module."""
    path = ROOT / 'experiments' / 'torch_encoder_kernel_bench.py'
    spec = importlib.util.spec_from_file_location('torch_encoder_kernel_bench', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _blocks(D, heads=None, F=None, depth=1, int8=False):
    cfg = vit.ViTConfig(embed_dim=D, depth=depth, num_heads=heads or D // 64,
                        mlp_ratio=(F or 4 * D) / D)
    blocks = torch.nn.ModuleList(vit.Block(cfg) for _ in range(depth))
    if int8:
        blocks = quant.quantize_tree(blocks, [f'{i}.{p}' for i in range(depth)
                                              for p in quant.BLOCK_LINEARS])
    return blocks


_ROUTED = dict(device='cuda', dtype=torch.bfloat16, grad=False, B=512, L=128, D=384,
               int8=False, forced=False)


@pytest.mark.parametrize('change,routed', [
    ({}, True),  # PARSeq-S's encoder in inference
    ({'D': 512}, True),  # 8 heads of 64, the widest the kernel takes
    ({'device': 'cpu'}, False),
    ({'dtype': torch.float32}, False),
    ({'grad': True}, False),  # training
    ({'L': 197}, False),  # ViTSTR-S
    ({'L': K_MAX_L + 1}, False),
    ({'D': 192}, False),  # PARSeq-Ti
    ({'D': 768}, False),  # PARSeq-B
    ({'int8': True}, False),
    ({'B': 1}, True),  # B5 wins at every batch (the sweep in models/vit.py)
    ({'forced': True}, False),  # inside kernels.plain() (the FLOP count)
], ids=lambda v: repr(v) if isinstance(v, dict) else None)
def test_gate_decision_table(no_library, change, routed):
    case = {**_ROUTED, **change}
    blocks = _blocks(case['D'], int8=case['int8'])
    forced = kernels.plain() if case['forced'] else contextlib.nullcontext()
    with torch.set_grad_enabled(case['grad']), forced:
        got = vit.takes_encoder_kernel(torch.device(case['device']), case['dtype'],
                                       (case['B'], case['L'], case['D']), case['D'] // 64,
                                       blocks)
    assert got is routed


def test_max_len_is_the_sources_without_the_library(no_library):
    """max_len reads kMaxL from the kernel's source: ViTSTR-S's first
    forward (D = 384, L = 197) neither builds nor loads the library."""
    assert encoder_kernel.max_len() == K_MAX_L
    assert not encoder_kernel.takes(197, 384, 6, 1536)


@pytest.mark.parametrize('L,D,heads,F', [(128, 384, 6, 1536), (1, 128, 2, 128),
                                         (K_MAX_L + 1, 384, 6, 1536), (128, 384, 4, 1536),
                                         (128, 192, 3, 768), (128, 640, 10, 2560),
                                         (128, 384, 6, 960)])
def test_takes_is_where_the_kernels_check_passes(no_library, L, D, heads, F):
    """encoder_kernel.takes is False exactly where _check raises on the
    shapes (operands of the right dtypes and layout)."""
    op = encoder_kernel.stack_block_params(_blocks(D, heads, F))
    x = torch.zeros(1, L, D, dtype=torch.bfloat16)
    if encoder_kernel.takes(L, D, heads, F):
        assert encoder_kernel._check(op, x, heads) == (1, F)
    else:
        with pytest.raises(ValueError, match='the kernel needs'):
            encoder_kernel._check(op, x, heads)


@pytest.fixture
def gate_on_cuda(no_library, monkeypatch):
    """[(shape, heads, answer)] of each question to the gate, answered again
    as on a CUDA device (the question itself is answered as asked)."""
    gate, asked = vit.takes_encoder_kernel, []

    def on_cuda(device, dtype, shape, num_heads, blocks):
        asked.append((tuple(shape), num_heads, gate(torch.device('cuda'), dtype, shape,
                                                    num_heads, blocks)))
        return gate(device, dtype, shape, num_heads, blocks)

    monkeypatch.setattr(vit, 'takes_encoder_kernel', on_cuda)
    return asked


@pytest.mark.parametrize('family,routed', [('parseq', True), ('vitstr', False)])
def test_forward_asks_the_gate_about_its_tokens(gate_on_cuda, family, routed):
    """A forward hands the gate its tokens' (B, L, D) and its blocks' heads,
    whatever config its subclass keeps (ViTSTR's counts characters in
    num_tokens): PARSeq-S's L = 128 would take B5 on the card, ViTSTR-S's
    L = 197 would not. Two blocks of the published widths."""
    from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
    from parseq_tpu_torch.models.vitstr import ViTSTR, ViTSTRConfig

    enc = (PARSeq(PARSeqConfig(enc_depth=2)).encoder if family == 'parseq'
           else ViTSTR(ViTSTRConfig(depth=2))).eval()
    H, W = enc.cfg.img_size
    images = torch.zeros(2, H, W, 3, dtype=torch.bfloat16)
    with torch.inference_mode():
        tokens = enc.tokens(images)
        vit.VisionTransformer.forward(enc, images)
    assert gate_on_cuda == [(tuple(tokens.shape), 6, routed)]


def test_flop_count_takes_the_eager_blocks(gate_on_cuda):
    """cli.bench's per_image_flops counts through the plain paths: the FLOP
    counter sees no product inside B5, so while it counts the gate keeps the
    eager blocks where a read on the card takes B5."""
    from parseq_tpu_torch.cli.bench import per_image_flops
    from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig

    model = SimpleNamespace(module=PARSeq(PARSeqConfig(enc_depth=1)).eval(),
                            dtype=torch.bfloat16)
    assert per_image_flops(model, torch.zeros(1, 32, 128, 3)) > 0
    with torch.inference_mode():
        model.module.encoder(torch.zeros(1, 32, 128, 3, dtype=torch.bfloat16))
    assert [answer for *_, answer in gate_on_cuda] == [False, True]


def _small_encoder(seed=0):
    torch.manual_seed(seed)
    return vit.VisionTransformer(vit.ViTConfig(embed_dim=128, depth=2, num_heads=2)).eval()


def _assert_current(enc, op):
    want = encoder_kernel.stack_block_params(enc.blocks)
    assert set(op) == set(want)
    for name, w in want.items():
        assert torch.equal(op[name], w), name


def test_stacked_operands_are_kept_until_a_parameter_changes():
    """Kept across calls; stacked anew after an AdamW step (in place),
    load_state_dict (in place) and .to() (new tensors); never in the
    state_dict."""
    enc = _small_encoder()
    op = enc.stacked_blocks()
    _assert_current(enc, op)
    assert enc.stacked_blocks() is op

    named = list(enc.named_parameters())
    params = [p for _, p in named]
    AdamW(named, OptimConfig()).step(params, [torch.ones_like(p) for p in params])
    stepped = enc.stacked_blocks()
    assert stepped is not op and not torch.equal(stepped['wqkv'], op['wqkv'])
    _assert_current(enc, stepped)
    assert enc.stacked_blocks() is stepped

    enc.load_state_dict(_small_encoder(seed=1).state_dict())
    loaded = enc.stacked_blocks()
    assert loaded is not stepped
    _assert_current(enc, loaded)

    enc.to(torch.float64)
    moved = enc.stacked_blocks()
    assert moved is not loaded and moved['ln1_s'].dtype == torch.float32
    _assert_current(enc, moved)
    assert enc.stacked_blocks() is moved
    assert all('stack' not in k for k in enc.state_dict())


def test_stacked_operands_follow_a_replaced_parameter():
    """A Parameter set anew (as load_state_dict(assign=True) does) makes the
    kept operands stale, even where its storage takes the old one's address
    and version; a pickled module keeps none of them."""
    enc = _small_encoder()
    op = enc.stacked_blocks()
    qkv = enc.blocks[0].attn.qkv
    fresh = torch.nn.Parameter(torch.randn_like(qkv.weight))
    enc.load_state_dict({**enc.state_dict(), 'blocks.0.attn.qkv.weight': fresh}, assign=True)
    assert qkv.weight is fresh
    replaced = enc.stacked_blocks()
    assert replaced is not op and not torch.equal(replaced['wqkv'], op['wqkv'])
    _assert_current(enc, replaced)
    assert enc.stacked_blocks() is replaced

    buf = io.BytesIO()
    torch.save(enc, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=False)
    assert loaded._stacked is None and enc._stacked is not None
    _assert_current(loaded, loaded.stacked_blocks())


def test_inference_tensor_operands_are_stacked_every_call():
    """Parameters made inside torch.inference_mode() keep no version counter:
    the operands are stacked on every call, so an in-place change there
    shows at once."""
    with torch.inference_mode():
        enc = _small_encoder()
        op = enc.stacked_blocks()
        _assert_current(enc, op)
        enc.blocks[0].attn.qkv.weight.mul_(2)
        again = enc.stacked_blocks()
    assert again is not op and not torch.equal(again['wqkv'], op['wqkv'])
    _assert_current(enc, again)


def test_cpu_forward_runs_the_eager_blocks_bit_for_bit():
    """A bf16 inference forward on the CPU at a width and length the kernel
    takes: no launch, the span's `fused` False, and exactly the eager
    blocks' result."""
    enc = _small_encoder()
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 32, 128, 3), dtype=np.float32)).to(torch.bfloat16)
    before = encoder_kernel.launches
    trace.clear()
    with torch.inference_mode(), trace.recording():
        got = enc(images)
        x = enc.tokens(images)
        for blk in enc.blocks:
            x = blk(x)
        want = layer_norm(x, enc.norm.weight, enc.norm.bias)
    spans = [s for s in trace.spans() if s['name'] == 'vit.encoder']
    trace.clear()
    assert encoder_kernel.launches == before
    assert torch.equal(got, want)
    assert spans[0]['attrs'] == {'rows': 3, 'fused': False}


@pytest.fixture
def harness(monkeypatch):
    """The benchmark's harness modules importable (benchmark/ on sys.path)."""
    monkeypatch.syspath_prepend(str(ROOT / 'benchmark'))
    from harness import spec

    return spec


def _reader_run(harness, fused, kernel_ms):
    """The three route readers on a traced span of two read batches: spans
    of the program (each vit.encoder 10 device ms, `fused` as given, or no
    such attribute for None) and B5's calls in the trace."""
    from harness import spans as hspans

    class Trace:
        def kernels(self, pattern):
            return [('encoder_blocks_kernel(Params)', 2, 2 * kernel_ms * 1e-3)] \
                if kernel_ms and re.search(pattern, 'encoder_blocks_kernel(Params)') else []

    recorded = []
    for f in fused:
        recorded.append({'name': 'eval.h2d', 'attrs': {}, 'device_ms': None})
        recorded.append({'name': 'vit.encoder', 'device_ms': 10.0,
                         'attrs': {} if f is None else {'fused': f}})
    p = SimpleNamespace(spans=recorded, count=lambda n: sum(s['name'] == n for s in recorded),
                        device_ms=lambda n: [s['device_ms'] for s in recorded
                                             if s['name'] == n and s['device_ms'] is not None])
    ctx = SimpleNamespace(cell=harness.load_cell('parseq-s.read-b512'), keep={'spans': p})
    outcome = SimpleNamespace(trace=Trace(), layer={'batch': 512})
    assert hspans.placed(outcome, ctx) is p
    return {name: harness.reader(name).read(outcome, ctx)
            for name in ('encoder_span_ms', 'encoder_fused_share', 'b5_roofline')}


def test_route_readers(harness):
    """encoder_span_ms: device ms a batch; encoder_fused_share: the share of
    spans with `fused` true, None without the attribute (a program from
    before the route); b5_roofline: the bound at (512, 128, 384, 1536, 12)
    over B5's ms a call, None without a call."""
    kernel = harness.kernel('b5')
    bound_ms = kernel.bound_ms(512, 128, 384, 1536, 12)[0]
    got = _reader_run(harness, [True, True], kernel_ms=4 * bound_ms)
    assert got == {'encoder_span_ms': 10.0, 'encoder_fused_share': 1.0,
                   'b5_roofline': pytest.approx(25.0)}
    assert _reader_run(harness, [True, False], kernel_ms=None) == {
        'encoder_span_ms': 10.0, 'encoder_fused_share': 0.5, 'b5_roofline': None}
    assert _reader_run(harness, [None, None], kernel_ms=None) == {
        'encoder_span_ms': 10.0, 'encoder_fused_share': None, 'b5_roofline': None}
    # the bound as chip_smoke.py's b5_bound gives it at the smoke's B = 256
    assert kernel.bound_ms(256, 128, 384, 1536, 12)[0] == pytest.approx(1.4852, abs=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel B5 has no CPU mode)')
    return torch.device('cuda')


# chip_smoke.py's hold on the bf16 main path against the f32 plain path:
# greedy picks equal where the f32 top-2 margin exceeds MAIN_MARGIN
MAIN_MARGIN = 0.1
# The routed read's max and mean |logit difference| from the f32 path, at
# most this multiple of the eager bf16 blocks' (no worse than the path it
# replaces, but for the luck of bf16 rounding; on the H100 the two read
# 6.25e-2 / 6.686e-3 and 6.25e-2 / 6.676e-3)
NO_WORSE = 1.25


def _read_passes(model, memory, ar):
    """A PARSeq read's two passes from `memory` on fixed picks: the AR pass's
    logits teacher-forced on ar's picks (B1's plain version) and the
    refinement of ar's logits, both at bf16."""
    from parseq_tpu_torch.ops import ar_kernel

    memory = memory.to(torch.bfloat16)
    return torch.cat([ar_kernel.ar_decode_fused_reference(model, memory, ar.argmax(-1)),
                      model.refine(memory, ar, torch.bfloat16).float()], dim=1)


def _agreement(got, want):
    """(max and mean |got - want|, picks equal where want's margin >
    MAIN_MARGIN, how many positions that is)."""
    top2 = want.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > MAIN_MARGIN
    agree = bool((got.argmax(-1) == want.argmax(-1))[confident].all())
    diff = (got - want).abs()
    return float(diff.max()), float(diff.mean()), agree, int(confident.sum())


@pytest.mark.gpu
def test_routed_parseq_s_matches_its_eager_blocks(bench, cuda_device):
    """PARSeq-S at B = 512 on the card (two waves of B5's blocks): the routed
    blocks against the eager ones within the bench's B5_LIMITS at depth 12
    (relative to what the blocks add); the routed forward one launch; and a
    full read's passes (AR teacher-forced on the routed read's picks, and the
    refinement) from the routed encoder held to the f32 encoder's: greedy
    picks equal where the f32 margin exceeds MAIN_MARGIN, as chip_smoke.py
    holds the bf16 main path, and the logits no farther (NO_WORSE) than the
    eager bf16 blocks'; the routed and eager reads' picks equal where the
    eager margin exceeds MAIN_MARGIN. Encoder weights: the bench's
    make_blocks (attention matters); decoder: ar_kernel.check_model's; the
    rest of the encoder from torch's generator at seed 0."""
    from parseq_tpu_torch.models.parseq import PARSeqConfig
    from parseq_tpu_torch.ops import ar_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = ar_kernel.check_model(PARSeqConfig(), seed=0)
    model.encoder.blocks.load_state_dict(bench.make_blocks(12, bench.SEED).state_dict())
    model = model.to(cuda_device)
    enc = model.encoder
    images = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (512, 32, 128, 3), dtype=np.float32)).to(cuda_device)
    assert encoder_kernel.library().parseq_encoder_blocks_max_len() == encoder_kernel.max_len()
    with torch.inference_mode():
        x = enc.tokens(images.to(torch.bfloat16))
        assert vit.takes_encoder_kernel(x.device, x.dtype, x.shape, 6, enc.blocks)
        fused, eager = enc.fused_blocks(x), enc.eager_blocks(x)
        rel_max, rel_mean = bench.contribution_errors(fused, eager, x)
        print(f'routed vs eager blocks, B = 512: relative max {rel_max:.4e}, mean {rel_mean:.4e}')
        assert rel_max <= bench.B5_LIMITS[12][0] and rel_mean <= bench.B5_LIMITS[12][1]

        before = encoder_kernel.launches
        routed = enc(images.to(torch.bfloat16))
        assert encoder_kernel.launches == before + 1
        assert torch.equal(routed, layer_norm(fused, enc.norm.weight, enc.norm.bias))
        ar = ar_kernel.ar_decode_fused(model, routed)
        with kernels.plain():
            eager = enc(images.to(torch.bfloat16))
        f32 = enc(images)
        assert encoder_kernel.launches == before + 1
        want = _read_passes(model, f32, ar)
        reads = {'routed': _read_passes(model, routed, ar), 'eager': _read_passes(model, eager, ar)}
    found = {f'{name} vs f32': _agreement(got, want) for name, got in reads.items()}
    found['routed vs eager'] = _agreement(reads['routed'], reads['eager'])
    for name, (err, mean, agree, confident) in found.items():
        print(f'{name}: |logit difference| max {err:.4e}, mean {mean:.4e}; picks equal at '
              f'the {confident} positions of margin > {MAIN_MARGIN}: {agree}')
        assert agree and confident > 0, name
    routed, eager = found['routed vs f32'], found['eager vs f32']
    assert routed[0] <= NO_WORSE * eager[0] and routed[1] <= NO_WORSE * eager[1]


@pytest.mark.gpu
def test_routed_parseq_s_read_forward_never_synchronizes(cuda_device):
    """PARSeq-S's bf16 read forward through ModelBundle at B = 8 (B5's
    blocks, B1's AR decode, the refinement with its key-padding mask) makes
    no synchronizing CUDA call: under sync-debug mode 'error' such a call
    (a pageable copy to the card, an .item()) raises. One forward first,
    outside the mode, loads the kernels and stacks B5's operands."""
    from parseq_tpu_torch.ops import ar_kernel
    from parseq_tpu_torch.utils import registry

    bundle = registry.create_model('parseq', device=cuda_device, dtype=torch.bfloat16)
    images = torch.rand((8, 32, 128, 3), generator=torch.Generator().manual_seed(0))
    images = (2 * images - 1).to(cuda_device)
    bundle(images)
    torch.cuda.synchronize()
    launches = encoder_kernel.launches, ar_kernel.launches
    torch.cuda.set_sync_debug_mode('error')
    try:
        logits = bundle(images)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert (encoder_kernel.launches, ar_kernel.launches) == (launches[0] + 1, launches[1] + 1)
    assert logits.shape == (8, bundle.cfg.num_steps, bundle.cfg.num_classes)
    assert bool(torch.isfinite(logits).all())
