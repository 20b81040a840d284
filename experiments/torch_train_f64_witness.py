#!/usr/bin/env python
"""Which side's float32 gradient is off: one train step of the port's family
in float32 and in float64, and the JAX package's step in float32, on the
same weights and batch as tests/test_torch_train_families.py.

    python experiments/torch_train_f64_witness.py --family trba [--microbatches 1 2]
        [--seed 0 1 2] [--stage pretraining|joint|lm_only] [--images noise|smooth] [--top 12]

Each seed and microbatch count is one run. Its first line reads the two f32
steps as the test holds them: loss and gradient-norm differences, the worst
parameter's max difference over the test's limit (GRAD_REL of its largest
gradient, or GRAD_FLOOR of the model's largest), and the worst relative L2
difference among the parameters that miss that limit (what TRUNK bounds).

The float64 step is the port's model in float64 (`.float()` leaves a float64
tensor as it is while it runs, so batch norms, softmaxes and logits stay in
float64): the float32 steps' rounding is absent, so its gradient stands in
for the exact one. For every parameter the script prints the relative L2
distance of the port's float32 gradient to it, of the JAX package's, and of
the two float32 gradients to each other, then each gradient's size against
the model's largest; worst rows first. `--images smooth` draws the images as
the tests draw them for TRBA and TRBC (low-resolution noise, upsampled);
`noise` is a uniform value per pixel. CPU only; a run takes about a minute.
"""

import argparse
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tests import test_torch_train_families as T  # noqa: E402

STAGES = {'none': {}, 'pretraining': {'pretraining': True}, 'joint': {'pretraining': False},
          'lm_only': {'lm_only': True}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--family', default='trba', choices=sorted(T.GEOMETRY))
    ap.add_argument('--microbatches', type=int, nargs='+', default=[1])
    ap.add_argument('--seed', type=int, nargs='+', default=[0])
    ap.add_argument('--stage', default='none', choices=sorted(STAGES))
    ap.add_argument('--images', default=None, choices=('noise', 'smooth'),
                    help="default: the tests' choice for the family")
    ap.add_argument('--top', type=int, default=12)
    args = ap.parse_args(argv)
    if args.images is not None:
        T.SMOOTH_IMAGES = {args.family} if args.images == 'smooth' else set()
    T.jtrba.grid_sample = T.jgrid._grid_sample_gather  # as the tests' fixture
    for seed in args.seed:
        for mb in args.microbatches:
            witness(args.family, mb, seed, args.stage, args.top)


def witness(family, mb, seed, stage, top_rows):
    static = STAGES[stage]
    jcfg, params, stats, model, jtok, ttok, kw = T._setup(family, seed)
    jbatch, tbatch = T._batches(family, jcfg, model, jtok, ttok, seed)
    model64 = copy.deepcopy(model)

    ocfg = T.joptim.OptimConfig(**T.OCFG)
    tx = (T.joptim.make_abinet_optimizer(ocfg, T.L_LR, T.PRETRAIN_END, params)[0]
          if family == 'abinet' else T.joptim.make_optimizer(ocfg, params)[0])
    tx = optax.chain(T._stash_grads(), tx)
    jstep = jax.jit(T.jmake_train_step(T.JFAMILIES[family], jcfg, tx, jnp.float32,
                                       microbatches=mb, **static))
    jstate = {'params': params, 'stats': stats, 'opt_state': tx.init(params),
              'step': jnp.zeros((), jnp.int32)}
    jstate, jm = jstep(jstate, jbatch, jax.random.key(0))
    jax_grads = T._state_dict(family, jstate['opt_state'][0], jstate['stats'], kw)

    def port_grads(m, dtype, batch):
        state = T.init_state(m, T.optim.OptimConfig(**T.OCFG))
        if family == 'abinet':
            state['opt_state'] = T.optim.make_abinet_optimizer(
                m.named_parameters(), T.optim.OptimConfig(**T.OCFG), T.L_LR, T.PRETRAIN_END)
        metrics = T.make_train_step(T.get_family(family), m.cfg, dtype, microbatches=mb,
                                    **static)(state, batch, None)
        return metrics, {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().numpy()
                         for n, p in m.named_parameters()}

    m32, g32 = port_grads(model, torch.float32, tbatch)
    jtop = max(np.abs(g.numpy()).max() for g in jax_grads.values())
    worst, missed = (0.0, ''), (0.0, '')
    for n, g in g32.items():
        j = jax_grads[n].numpy().astype(np.float64)
        share = np.abs(g - j).max() / (T.GRAD_REL * max(np.abs(j).max(), T.GRAD_FLOOR * jtop))
        worst = max(worst, (share, n))
        if share > 1:
            missed = max(missed, (np.linalg.norm(g - j) / np.linalg.norm(j), n))
    print(f'{family} {stage} microbatches {mb} seed {seed}, port f32 vs JAX f32 as the test '
          f'holds them: loss {abs(float(m32["loss"]) - float(jm["loss"])):.1e}, grad norm '
          f'{abs(float(m32["grad_norm"]) / float(jm["grad_norm"]) - 1):.1e} relative, worst '
          f'parameter {worst[0]:.3g} x its limit ({worst[1]}), worst relative L2 of those '
          f'missing it {missed[0]:.3e} ({missed[1] or "none"})')
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (self if self.dtype == torch.float64
                                                else to_float(self, *a, **k))
    try:
        images = (tbatch['images'].double() / 255.0 - 0.5) / 0.5
        g64 = port_grads(model64.double(), torch.float64, dict(tbatch, images=images))[1]
    finally:
        torch.Tensor.float = to_float

    top = max(np.abs(g).max() for g in g64.values())
    rows = []
    for n, g in g64.items():
        norm = max(np.linalg.norm(g), 1e-300)
        j = jax_grads[n].numpy().astype(np.float64)
        rows.append((np.linalg.norm(g32[n] - g) / norm, np.linalg.norm(j - g) / norm,
                     np.linalg.norm(g32[n] - j) / norm, np.abs(g).max() / top, n))
    rows.sort(key=lambda r: -max(r[0], r[1]) if r[3] > 1e-12 else 0.0)
    print(f'{family} {stage} microbatches {mb} seed {seed} images '
          f'{"smooth" if family in T.SMOOTH_IMAGES else "noise"}: relative L2 to the port\'s '
          f'float64 gradient of the port\'s f32 and the JAX package\'s f32, and of the two f32 '
          f'to each other; max|g| / the model\'s largest (rows with a gradient below 1e-12 of '
          f'it last)')
    print(f'{"port f32":>10} {"JAX f32":>10} {"port-JAX":>10} {"size":>8}  parameter')
    for r in rows[:top_rows]:
        print(f'{r[0]:10.3e} {r[1]:10.3e} {r[2]:10.3e} {r[3]:8.1e}  {r[4]}')
    live = [r for r in rows if r[3] > 1e-12]
    print(f'worst: port f32 {max(r[0] for r in live):.3e}, JAX f32 '
          f'{max(r[1] for r in live):.3e}, port-JAX {max(r[2] for r in live):.3e}')


if __name__ == '__main__':
    main()
