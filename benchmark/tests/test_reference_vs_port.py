"""The plain reference against the port's plain paths at tiny widths, in
float32 on the CPU: PARSeq's AR pass teacher-forced on the port's greedy
picks and its refinement, ViTSTR's logits, and one PARSeq training step
(loss, gradients, AdamW's update) on the same dropout bits."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from harness import weights
from reference import parseq as rparseq
from reference import train as rtrain
from reference import vitstr as rvitstr
from reference.ops import normalize_u8
from reference.tokenizer import Ids

TOL = 1e-4  # float32 on both sides; only the order of sums differs


def _bundle(cell, sd):
    from parseq_tpu_torch.utils import registry

    cfg = cell.config
    return registry._bundle(cfg['experiment'], dict(cfg['model']), dtype=torch.float32,
                            device='cpu', state_dict=sd)


def _images(cell, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *cell.config['model']['img_size'], 3), generator=g,
                         dtype=torch.uint8)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize('seed', [0, 1])
def test_parseq_read(seed):
    cell = tiny_cell('parseq-s.read-b512')
    m = cell.config['model']
    ids = Ids(m['charset_train'])
    sd = weights.draw(rparseq.param_shapes(m, ids), seed, 'cpu', rparseq.init_kind)
    port = _bundle(cell, sd).module
    x = normalize_u8(_images(cell, 5, seed))
    with torch.no_grad():
        memory = port.encode(x)
        ar = port.ar_decode(memory, torch.float32)
        refined = port.refine(memory, ar, torch.float32)
        ref_ar, ref_refined = rparseq.read(sd, m, ids, x, ar.argmax(-1))
    assert _rel(ar, ref_ar) < TOL
    assert _rel(refined, ref_refined) < TOL


def test_vitstr_read():
    cell = tiny_cell('vitstr-s.read-b512')
    m = cell.config['model']
    ids = Ids(m['charset_train'])
    sd = weights.draw(rvitstr.param_shapes(m, ids), 3, 'cpu', rvitstr.init_kind)
    port = _bundle(cell, sd).module
    x = normalize_u8(_images(cell, 4, 3))
    with torch.no_grad():
        assert _rel(port(x, torch.float32), rvitstr.logits(sd, x, m)) < TOL


def test_parseq_train_step():
    from parseq_tpu_torch.models.parseq import gen_tgt_perms
    from parseq_tpu_torch.train import optim

    cell = tiny_cell('parseq-s.train-b384')
    m = cell.config['model']
    ids = Ids(m['charset_train'])
    sd = weights.draw(rparseq.param_shapes(m, ids), 4, 'cpu', rparseq.init_kind)
    bundle = _bundle(cell, sd)
    port, tok = bundle.module.train(), bundle.tokenizer
    labels = ['a', 'hello', 'W0RLD~', 'x' * 25, 'Zq']
    tgt = tok.encode(labels, m['max_label_length'])
    np.testing.assert_array_equal(tgt, ids.encode(labels, m['max_label_length']))
    perms = gen_tgt_perms(np.random.default_rng(5), bundle.cfg)
    ref_perms = rparseq.gen_tgt_perms(np.random.default_rng(5), m['perm_num'],
                                      m['max_label_length'])
    np.testing.assert_array_equal(perms, ref_perms)
    x = normalize_u8(_images(cell, len(labels), 6))
    loss, _ = port.multi_perm_loss(x, torch.as_tensor(tgt), perms, dtype=torch.float32,
                                   rng=torch.Generator().manual_seed(7))
    loss.backward()
    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    bits = rparseq.draw_dropout_bits(m, len(perms), len(labels), m['max_label_length'] + 1,
                                     (H // ph) * (W // pw), torch.Generator().manual_seed(7))
    params = {k: v.clone().requires_grad_() for k, v in sd.items()}
    ref_loss = rparseq.multi_perm_loss(params, m, ids, x, torch.as_tensor(tgt), ref_perms, bits)
    ref_grads = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < TOL * float(ref_loss.detach())
    for name, p in port.named_parameters():
        scale = max(float(ref_grads[name].abs().max()), 1e-6)
        assert float((p.grad - ref_grads[name]).abs().max()) / scale < 1e-3, name
    opt = dict(lr=m['lr'], batch_size=len(labels), weight_decay=0.0, warmup_pct=0.075,
               total_steps=1000, grad_clip=20.0, div_factor=25.0, final_div_factor=1e4)
    port_opt = optim.AdamW(port.named_parameters(), optim.OptimConfig(
        lr=m['lr'], batch_size=len(labels), total_steps=1000, grad_clip=20.0))
    # AdamW on the same gradients: the same update
    names = [n for n, _ in port.named_parameters()]
    ps = [p for p in port.parameters()]
    with torch.no_grad():
        port_opt.step(ps, [ref_grads[n] for n in names])
    ref_p = {k: v.detach().clone() for k, v in sd.items()}
    rtrain.AdamW(ref_p, opt).step(ref_p, ref_grads)
    lr = rtrain.onecycle_lr(opt, 0)
    for name, p in zip(names, ps):
        assert float((p.detach() - ref_p[name]).abs().max()) <= 1e-3 * lr, name
