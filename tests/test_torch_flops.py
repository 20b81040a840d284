"""utils/flops.py: the port's FLOP counter (torch's FlopCounterMode, halved to
fvcore's MAC convention), on the cases of tests/test_flops.py and against
the JAX package's jaxpr walk for whole models.

The model counts run both benches' way, per image: the port's through its
plain paths (kernels.plain(), in cli.bench's per_image_flops), the JAX
package's through PARSeq's AR scan and its attention.force_einsum().
The JAX side counts abstract parameters (jax.eval_shape of the init), so
no weights are drawn. Its TRBA grid sample is monkeypatched to the gather
path: the default one-hot form is a TPU layout workaround whose einsum the
jaxpr walk would count as MACs (the JAX package itself is unchanged).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from parseq_tpu.models import parseq as jparseq
from parseq_tpu.models import trba as jtrba
from parseq_tpu.ops import attention as jattention
from parseq_tpu.ops import grid_sample as jgrid
from parseq_tpu.utils import config as jconfig
from parseq_tpu.utils import registry as jregistry
from parseq_tpu.utils.flops import count_flops as jax_count_flops
from parseq_tpu_torch.cli.bench import per_image_flops
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.flops import count_flops


def test_plain_matmul():
    assert count_flops(lambda x, y: x @ y, torch.zeros(8, 32), torch.zeros(32, 16)) == 8 * 32 * 16


def test_batched_einsum():
    a, b = torch.zeros(4, 8, 32), torch.zeros(4, 32, 16)
    got = count_flops(lambda x, y: torch.einsum('bik,bkj->bij', x, y), a, b)
    assert got == 4 * 8 * 32 * 16


def test_loop_counts_every_iteration():
    """The counterpart of a scan: a Python loop over 12 stacked layers."""
    w = torch.zeros(12, 16, 16)

    def fn(x):
        for wi in w:
            x = x @ wi
        return x

    assert count_flops(fn, torch.zeros(8, 16)) == 12 * 8 * 16 * 16


def test_conv():
    ker = torch.zeros(8, 3, 3, 3)
    # out elements (2*16*16*8) x taps (3*3) x cin (3)
    got = count_flops(lambda x: F.conv2d(x, ker, padding=1), torch.zeros(2, 3, 16, 16))
    assert got == 2 * 16 * 16 * 8 * 9 * 3


def test_module_boundary_recursed():
    """A module's products (and its parameters, frozen while counted) count;
    the bias add does not."""
    lin = nn.Linear(32, 16)
    outer = nn.Sequential(lin, nn.ReLU())
    assert count_flops(outer, torch.zeros(8, 32)) == 8 * 32 * 16
    assert lin.weight.requires_grad


def test_branch_counts_the_one_taken():
    """Eager code runs one branch; the jaxpr walk's cond takes the larger."""
    w1, w2 = torch.zeros(16, 16), torch.zeros(16, 64)

    def fn(x, wide):
        return (x @ (w2 if wide else w1)).sum()

    assert count_flops(fn, torch.zeros(8, 16), True) == 8 * 16 * 64
    assert count_flops(fn, torch.zeros(8, 16), False) == 8 * 16 * 16


# Small widths at each experiment's own image size.
MODELS = {
    'parseq': dict(embed_dim=48, enc_num_heads=4, enc_depth=2, dec_num_heads=6,
                   max_label_length=10),
    'vitstr': dict(embed_dim=48, num_heads=4, depth=2, max_label_length=10),
    'crnn': dict(hidden_size=32),
    'trba': dict(hidden_size=16, output_channel=32, max_label_length=6),
    'trbc': dict(hidden_size=16, output_channel=32),
}


def _jax_macs_per_image(experiment, overrides, images):
    model_cfg = dict(jconfig.compose(experiment)['model'], **overrides)
    build = jregistry._BUILDERS[jregistry._family(experiment)]
    cfg, _, forward_fn, init_fn, _ = build(jregistry._TrackedCfg(model_cfg), jnp.float32)
    if jregistry._family(experiment) == 'parseq':  # the bench's count: the scan AR path
        forward_fn = lambda p, x: jparseq.forward(p, cfg, x, use_fused_ar=False)  # noqa: E731
    params = jax.eval_shape(init_fn, jax.random.key(0))
    with jattention.force_einsum():
        return jax_count_flops(forward_fn, params, jnp.asarray(images)) / images.shape[0]


@pytest.mark.parametrize('experiment', sorted(MODELS))
def test_per_image_macs_equal_jax(experiment, monkeypatch):
    monkeypatch.setattr(jtrba, 'grid_sample', jgrid._grid_sample_gather)
    model = registry.create_model(experiment, device='cpu', dtype=torch.float32,
                                  **MODELS[experiment])
    images = np.random.default_rng(0).uniform(-1, 1, (2, *model.img_size, 3)).astype(np.float32)
    want = _jax_macs_per_image(experiment, MODELS[experiment], images)
    got = per_image_flops(model, torch.from_numpy(images))
    assert want > 0 and got == want


def test_abinet_macs_differ_by_its_query_projection():
    """One structural difference: the port projects ABINet's T positional
    queries once a batch (T x E x E MACs), the JAX package once an image.
    Per image over B images the port counts T*E*E*(1 - 1/B) fewer."""
    overrides = dict(nhead=4, d_inner=128, v_num_layers=1, l_num_layers=1, iter_size=2,
                     max_label_length=10)
    model = registry.create_model('abinet', device='cpu', dtype=torch.float32, **overrides)
    B = 2
    images = np.random.default_rng(1).uniform(-1, 1, (B, 32, 128, 3)).astype(np.float32)
    want = _jax_macs_per_image('abinet', overrides, images)
    got = per_image_flops(model, torch.from_numpy(images))
    T, E = model.cfg.max_length, model.cfg.d_model
    assert got == want - T * E * E * (1 - 1 / B)
