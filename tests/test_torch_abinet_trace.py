"""ABINet's spans (models/abinet.py, utils/trace.py) on the CPU at tiny
widths, read through eval_dataset as the benchmark's read cell reads it:
abinet.vision holds abinet.backbone, abinet.transformer and
abinet.position_attention, then one abinet.iteration a language pass and
its alignment, numbered 0 to iter_size - 1; abinet.backbone counts the
launches of csrc/bn_act.cu in it (`bn_kernel`); nothing is recorded while
recording is off. Marked `gpu` (skipped without a card): ABINet's read
forward at its published widths never makes the host wait for the card.

No jax import: the GPU host runs the `gpu` case
(`python -m pytest --noconftest -m gpu tests/test_torch_abinet_trace.py`)."""

import numpy as np
import pytest
import torch

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops import cnn
from parseq_tpu_torch.train.evaluate import eval_dataset
from parseq_tpu_torch.utils import registry, trace

# d_model stays 512 (ResNet45's width); 32 x 64 is the least crop the
# position attention's U-Net takes
TINY = dict(img_size=[32, 64], nhead=4, d_inner=64, v_num_layers=1, l_num_layers=1,
            max_label_length=5)
VISION = ['abinet.backbone', 'abinet.transformer', 'abinet.position_attention']


@pytest.fixture(scope='module')
def bundle():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield registry.create_model('abinet', device='cpu', dtype=torch.float32, **TINY)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean():
    trace.clear()
    yield
    trace.clear()


def _read(bundle, rows=2):
    images = np.random.default_rng(0).integers(0, 256, (rows, 32, 64, 3), dtype=np.uint8)
    return eval_dataset(bundle, [(images, ['ab'] * rows, None)])


def test_spans_nest_under_the_forward(bundle):
    with trace.recording():
        result = _read(bundle)
    assert result.num_samples == 2
    spans = trace.spans()
    names = [s['name'] for s in spans]
    forward = names.index('eval.forward')
    vision = names.index('abinet.vision')
    assert spans[vision]['parent'] == forward
    assert [s['name'] for s in spans if s['parent'] == vision] == VISION
    iterations = [s for s in spans if s['name'] == 'abinet.iteration']
    assert [s['attrs']['iteration'] for s in iterations] == [0, 1, 2]
    assert all(s['parent'] == forward for s in iterations)
    ours = [s for s in spans if s['name'].startswith('abinet.')]
    assert len(ours) == 7 and all(s['attrs']['rows'] == 2 for s in ours)
    assert all(s['end_ns'] >= s['start_ns'] for s in ours)
    # the vision model ends before the first language pass starts
    assert spans[vision]['end_ns'] <= iterations[0]['start_ns']


@pytest.mark.parametrize('launching', [False, True], ids=['cpu', 'counted_launches'])
def test_the_backbone_span_says_whether_its_batch_norms_ran_as_the_kernel(bundle, monkeypatch,
                                                                          launching):
    """abinet.backbone carries `bn_kernel`, the launches of csrc/bn_act.cu
    counted in it: 0 on the CPU and in training mode. With a stand-in for
    the launch that counts as the kernel does (eval mode, outside
    kernels.plain()), the read forward's ResNet45 counts its 45 sites: the
    attribute reads what ran, not what the gate predicts."""
    if launching:
        def launch(y, bn, relu=False, residual=None, residual_bn=None):
            cnn.launches += 1
            with kernels.plain():
                return cnn.bn_act(y, bn, relu, residual, residual_bn)

        monkeypatch.setattr(cnn, 'takes_kernel', lambda y, bn, residual=None, residual_bn=None:
                            not bn.training and kernels.enabled())
        monkeypatch.setattr(cnn, '_launch', launch)
    with trace.recording():
        _read(bundle)
        with torch.no_grad():
            bundle.module.train()
            try:
                bundle.module.vision_forward(torch.zeros(1, 32, 64, 3))
            finally:
                bundle.module.eval()
    backbone = [s['attrs'] for s in trace.spans() if s['name'] == 'abinet.backbone']
    assert [a['bn_kernel'] for a in backbone] == [45 if launching else 0, 0]


def test_nothing_is_recorded_while_off(bundle):
    _read(bundle)
    assert trace.spans() == []


@pytest.mark.gpu
def test_read_forward_never_synchronizes():
    """ABINet's bf16 read forward through ModelBundle at B = 8, all three
    iterations (each language layer's key-padding mask) and B2 in the vision
    transformer, makes no synchronizing CUDA call: under sync-debug mode
    'error' such a call (a pageable copy to the card, an .item()) raises.
    One forward first, outside the mode, loads the kernels and picks cuDNN's
    algorithms."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel B2 has no CPU mode)')
    from parseq_tpu_torch.ops import attention

    bundle = registry.create_model('abinet', device='cuda', dtype=torch.bfloat16)
    assert bundle.cfg.iter_size == 3
    images = torch.rand((8, 32, 128, 3), generator=torch.Generator().manual_seed(0))
    images = (2 * images - 1).to('cuda')
    bundle(images)
    torch.cuda.synchronize()
    launches, bn_launches = attention.launches, cnn.launches
    with trace.recording():
        torch.cuda.set_sync_debug_mode('error')
        try:
            logits = bundle(images)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    assert attention.launches == launches + bundle.cfg.v_num_layers
    # ResNet45's 50 batch norms in 45 launches, the U-Net's 8 in 8
    assert cnn.launches == bn_launches + 45 + 8
    assert [s['attrs']['bn_kernel'] for s in trace.spans()
            if s['name'] == 'abinet.backbone'] == [45]
    assert [s['attrs']['iteration'] for s in trace.spans()
            if s['name'] == 'abinet.iteration'] == [0, 1, 2]
    assert logits.shape == (8, bundle.cfg.max_length, bundle.cfg.num_classes)
    assert bool(torch.isfinite(logits).all())
