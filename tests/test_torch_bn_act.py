"""Eval-mode batch norm, shortcut and ReLU in one pass (ops/cnn.py:bn_act,
conv_bn; the kernel csrc/bn_act.cu).

On the CPU: the kernel's gate (`takes_kernel`, its part `_allowed` that
asks no layout) answers no on
the CPU, in training mode, under autograd, inside `kernels.plain()` and for
tensors the kernel does not take; the fused form's eager path equals the
separate calls it replaced in ABINet's, CRNN's and TRBA's blocks, in eval
and training mode (running statistics moved alike).

Marked `gpu` (skipped without a card): the kernel bit for bit against those
calls (inside `kernels.plain()`) at every (C, H, W) of ABINet's ResNet45 and
its U-Net at B = 512 and B = 3, in bf16 and f32, channels-last and NCHW, in
all four forms, with random non-identity statistics; ABINet's ResNet45 and
position attention on the card bit for bit against their plain runs, with
the launches a forward counted.

No jax import: the GPU host runs the `gpu` cases
(`python -m pytest --noconftest -m gpu tests/test_torch_bn_act.py`)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch import kernels
from parseq_tpu_torch.models import abinet, crnn, trba
from parseq_tpu_torch.ops import cnn

CUDA = torch.device('cuda')


def _random_bn(C, seed, device='cpu'):
    """An eval-mode BatchNorm2d with random, non-identity statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.5)
        bn.weight.copy_(1 + torch.randn(C, generator=g) * 0.3)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.5)
    return bn.to(device).eval()


# ---------------------------------------------------------------------------
# The gate, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', ['cuda', 'float32', 'cpu', 'training', 'autograd', 'plain',
                                  'float16'])
def test_the_gate_answers_yes_only_on_the_card_in_eval_without_autograd(case):
    device = torch.device('cpu' if case == 'cpu' else 'cuda')
    dtype = {'float32': torch.float32, 'float16': torch.float16}.get(case, torch.bfloat16)
    with torch.set_grad_enabled(case == 'autograd'):
        if case == 'plain':
            with kernels.plain():
                on = cnn._allowed(device, dtype, False)
        else:
            on = cnn._allowed(device, dtype, case == 'training')
    assert on == (case in ('cuda', 'float32'))


def test_no_cpu_tensor_takes_the_kernel():
    """On the CPU the gate answers no, bn_act makes the separate calls and
    nothing launches."""
    bn, bn_r = _random_bn(8, 0), _random_bn(8, 1)
    y = torch.randn(2, 8, 4, 4)
    r = torch.randn(2, 8, 4, 4)
    launches = cnn.launches
    with torch.inference_mode():
        assert not cnn.takes_kernel(y, bn)
        assert not cnn.takes_kernel(y, bn, r, bn_r)
        got = cnn.bn_act(y, bn, True, r, bn_r)
        want = F.relu(cnn.batchnorm(y, bn) + cnn.batchnorm(r, bn_r))
    assert torch.equal(got, want) and cnn.launches == launches


@pytest.mark.parametrize('case', ['nchw', 'channels_last', 'both', 'strided', 'float16', '3d',
                                  'residual_layout', 'residual_dtype', 'residual_shape',
                                  'bn_channels', 'bn_alone', 'bn_float64', 'bn_no_affine',
                                  'bn_no_running'])
def test_which_tensors_the_kernel_takes(case):
    """cnn._unfit: dense NCHW or channels-last y in bf16 or f32; a residual of
    y's shape, dtype and layout; running statistics, weight and bias of y's
    channels in float32, which the kernel reads."""
    y = torch.randn(2, 16, 4, 6, dtype=torch.bfloat16)
    bn, residual, residual_bn = _random_bn(16, 0), None, None
    if case == 'channels_last':
        y = y.to(memory_format=torch.channels_last)
    elif case == 'both':  # H = W = 1: dense in both layouts
        y = y[:, :, :1, :1].contiguous()
        residual = y.to(memory_format=torch.channels_last)
    elif case == 'strided':
        y = y[:, :, :, ::2]
    elif case == 'float16':
        y = y.half()
    elif case == '3d':
        y = y.flatten(2)
    elif case == 'residual_layout':
        residual = y.to(memory_format=torch.channels_last)
    elif case == 'residual_dtype':
        residual = y.float()
    elif case == 'residual_shape':
        residual = y[:1]
    elif case == 'bn_channels':
        bn = _random_bn(8, 0)
    elif case == 'bn_alone':
        residual_bn = _random_bn(16, 1)
    elif case == 'bn_float64':
        bn = _random_bn(16, 0).double()
    elif case == 'bn_no_affine':
        bn = nn.BatchNorm2d(16, affine=False).eval()
    elif case == 'bn_no_running':
        bn = nn.BatchNorm2d(16, track_running_stats=False).eval()
    takes = case in ('nchw', 'channels_last', 'both')
    assert (cnn._unfit(y, bn, residual, residual_bn) is None) == takes


def test_the_ctypes_signature_is_the_c_entrys():
    """cnn.ARGTYPES, parameter for parameter, against parseq_bn_act's
    prototype in csrc/bn_act.cu: a pointer, an int or a float each (a
    mismatch passes the stream truncated)."""
    import ctypes
    import re

    from parseq_tpu_torch.kernels.build import CSRC

    source = (CSRC / 'bn_act.cu').read_text()
    params = re.search(r'int parseq_bn_act\(([^)]*)\)', source).group(1).split(',')
    kinds = [ctypes.c_void_p if '*' in p else ctypes.c_float if p.split()[0] == 'float'
             else ctypes.c_int for p in params]
    assert [p.split()[0] for p in params if '*' not in p] == ['float'] * 2 + ['int'] * 6
    assert kinds == cnn.ARGTYPES


# ---------------------------------------------------------------------------
# The fused form's eager path against the separate calls, on the CPU
# ---------------------------------------------------------------------------


def _randomize_bns(module, seed):
    for i, m in enumerate(m for m in module.modules() if isinstance(m, nn.BatchNorm2d)):
        m.load_state_dict(_random_bn(m.num_features, seed + i).state_dict())


def _block_separately(block, x):
    """A residual block by the separate calls (_R45Block's forward as it
    was; TRBA's BasicBlock's forward as it is)."""
    out = F.relu(cnn.conv_bn(x, block.conv1, block.bn1))
    out = cnn.conv_bn(out, block.conv2, block.bn2)
    if block.downsample is not None:
        x = cnn.conv_bn(x, block.downsample[0], block.downsample[1])
    return F.relu(out + x)


def _block_fused(block, x):
    """A residual block by the fused form (_R45Block's forward)."""
    out = cnn.conv_bn(x, block.conv1, block.bn1, relu=True)
    if block.downsample is None:
        return cnn.conv_bn(out, block.conv2, block.bn2, relu=True, residual=x)
    return cnn.conv_bn(out, block.conv2, block.bn2, relu=True,
                       residual=cnn.conv2d(x, block.downsample[0]),
                       residual_bn=block.downsample[1])


def _cases(family):
    """(module, input, forward by the fused form, forward by the separate
    calls): ABINet's block forwards by the fused form itself, TRBA's block
    and CRNN's stage by the separate calls."""
    g = torch.Generator().manual_seed(3)
    if family.startswith('abinet'):
        block = (abinet._R45Block(16, 16, 1) if family == 'abinet_identity'
                 else abinet._R45Block(8, 16, 2))
        x = torch.randn(2, block.conv1.in_channels, 6, 10, generator=g)
        return block, x, lambda m, t: m(t), _block_separately
    if family.startswith('trba'):
        block = trba.BasicBlock(16, 16) if family == 'trba_identity' else trba.BasicBlock(8, 16, 2)
        x = torch.randn(2, block.conv1.in_channels, 6, 10, generator=g)
        return block, x, _block_fused, lambda m, t: m(t)
    model = crnn.CRNN(crnn.CRNNConfig(num_tokens=12, hidden_size=16))
    i = next(i for i in range(9) if hasattr(model.cnn, f'batchnorm{i}'))
    conv, bn = getattr(model.cnn, f'conv{i}'), getattr(model.cnn, f'batchnorm{i}')
    x = torch.randn(2, conv.in_channels, 6, 10, generator=g)
    return (model, x, lambda m, t: cnn.conv_bn(t, conv, bn, relu=True),
            lambda m, t: F.relu(cnn.batchnorm(cnn.conv2d(t, conv), bn)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('mode', ['eval', 'train'])
@pytest.mark.parametrize('family', ['abinet_identity', 'abinet_downsample', 'trba_identity',
                                    'trba_downsample', 'crnn'])
def test_the_fused_form_equals_the_separate_calls(family, mode, dtype):
    module, x, fused, separately = _cases(family)
    _randomize_bns(module, 10)
    module.train(mode == 'train')
    start = {k: v.clone() for k, v in module.state_dict().items()}
    x = x.to(dtype)
    with torch.no_grad():
        want = separately(module, x)
        moved = {k: v.clone() for k, v in module.state_dict().items()}
        module.load_state_dict(start)
        got = fused(module, x)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    for k, v in module.state_dict().items():  # training moved the running statistics alike
        assert torch.equal(v, moved[k]), k
    if mode == 'train':
        assert not all(torch.equal(v, start[k]) for k, v in moved.items())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# every (C, H, W) a batch norm of ABINet meets at 32 x 128: ResNet45's stem
# and five layers, then the U-Net's encoder and decoder maps
SHAPES = [(32, 32, 128), (32, 16, 64), (64, 16, 64), (128, 16, 64), (128, 8, 32), (256, 8, 32),
          (512, 8, 32), (64, 8, 16), (64, 4, 8), (64, 2, 4), (64, 1, 2)]
FORMS = ['plain', 'relu', 'identity', 'normed']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (csrc/bn_act.cu has no CPU mode)')


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _check_form(form, shape, dtype, layout, relu, seed):
    """One call of the kernel against the separate calls, bit for bit."""
    g = torch.Generator(device=CUDA).manual_seed(seed)
    B, C, H, W = shape
    y = torch.randn(shape, generator=g, device=CUDA).to(dtype).contiguous(memory_format=layout)
    bn, residual, residual_bn = _random_bn(C, seed, CUDA), None, None
    if form in ('identity', 'normed'):
        residual = (torch.randn(shape, generator=g, device=CUDA) * 2).to(dtype)
        residual = residual.contiguous(memory_format=layout)
    if form == 'normed':
        residual_bn = _random_bn(C, seed + 1, CUDA)
    with torch.inference_mode():
        with kernels.plain():
            want = cnn.bn_act(y, bn, relu, residual, residual_bn)
        launches = cnn.launches
        assert cnn.takes_kernel(y, bn, residual, residual_bn)
        got = cnn.bn_act(y, bn, relu, residual, residual_bn)
        torch.cuda.synchronize()
    assert cnn.launches == launches + 1
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert torch.equal(_bits(got), _bits(want)), (form, shape, dtype, layout, relu)


@pytest.mark.gpu
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('chw', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_the_kernel_equals_the_separate_calls(card, chw, form):
    for B in (512, 3):
        for dtype in (torch.bfloat16, torch.float32):
            for layout in (torch.channels_last, torch.contiguous_format):
                for relu in ((form == 'relu',) if form in ('plain', 'relu') else (True, False)):
                    _check_form(form, (B, *chw), dtype, layout, relu, seed=B + chw[0])


@pytest.mark.gpu
@pytest.mark.parametrize('form', FORMS)
def test_the_kernel_on_odd_shapes_and_unaligned_starts(card, form):
    """The scalar path: C not a multiple of the vector (channels-last), H * W
    not one (NCHW), and a start off 16 bytes."""
    for shape in ((3, 12, 5, 7), (2, 4, 3, 3), (1, 1, 1, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            for layout in (torch.channels_last, torch.contiguous_format):
                _check_form(form, shape, dtype, layout, True, seed=7)
    bn = _random_bn(16, 3, CUDA)
    flat = torch.randn(2 * 16 * 8 * 8 + 1, device=CUDA).bfloat16()
    y = flat[1:].view(2, 16, 8, 8)  # 2 bytes past an aligned start
    with torch.inference_mode():
        with kernels.plain():
            want = cnn.bn_act(y, bn, relu=True)
        got = cnn.bn_act(y, bn, relu=True)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_the_kernel_passes_nan_inf_and_signed_zeros_as_the_separate_calls(card):
    specials = torch.tensor([float('nan'), float('inf'), -float('inf'), 0.0, -0.0, 1e38, -1e38,
                             1e-40], device=CUDA)
    for dtype in (torch.bfloat16, torch.float32):
        y = specials.repeat(4 * 16 * 4).view(4, 16, 4, 8).to(dtype)
        r = specials.flip(0).repeat(4 * 16 * 4).view(4, 16, 4, 8).to(dtype)
        bn = _random_bn(16, 5, CUDA)
        with torch.no_grad():
            bn.running_mean.zero_()
            bn.bias[::2] = 0.0
        for form in FORMS:
            residual = r if form in ('identity', 'normed') else None
            residual_bn = _random_bn(16, 6, CUDA) if form == 'normed' else None
            for relu in (False, True):
                with torch.inference_mode():
                    with kernels.plain():
                        want = cnn.bn_act(y, bn, relu, residual, residual_bn)
                    got = cnn.bn_act(y, bn, relu, residual, residual_bn)
                assert torch.equal(_bits(got), _bits(want)), (dtype, form, relu)


@pytest.mark.gpu
def test_abinet_resnet_and_position_attention_on_the_card(card):
    """ABINet's ResNet45 (50 batch norms: 45 launches) and position attention
    (8: 8 launches) at the published widths, bf16, B = 32, random statistics:
    bit for bit their runs inside kernels.plain()."""
    from parseq_tpu_torch.utils import registry

    bundle = registry.create_model('abinet', device='cuda', dtype=torch.bfloat16)
    model = bundle.module
    _randomize_bns(model, 100)
    model.to(CUDA).eval()
    resnet, attention = model.vision.backbone.resnet, model.vision.attention
    images = torch.rand((32, 32, 128, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    x = images.to(CUDA, torch.bfloat16).permute(0, 3, 1, 2)
    with torch.inference_mode():
        with kernels.plain():
            want = resnet(x)
            want_k = attention(want)
        launches = cnn.launches
        got = resnet(x)
        assert cnn.launches == launches + 45
        got_k = attention(got)
        assert cnn.launches == launches + 45 + 8
        torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_k), _bits(want_k))
