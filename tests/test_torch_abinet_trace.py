"""ABINet's spans (models/abinet.py, utils/trace.py) on the CPU at tiny
widths, read through eval_dataset as the benchmark's read cell reads it:
abinet.vision holds abinet.backbone, abinet.transformer and
abinet.position_attention, then one abinet.iteration a language pass and
its alignment, numbered 0 to iter_size - 1; nothing is recorded while
recording is off."""

import numpy as np
import pytest
import torch

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


def test_nothing_is_recorded_while_off(bundle):
    _read(bundle)
    assert trace.spans() == []
