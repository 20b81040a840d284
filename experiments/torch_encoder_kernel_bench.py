#!/usr/bin/env python
"""Encoder microbench of the PyTorch port: eager ViT blocks, PyTorch's
nn.TransformerEncoder and kernel B5 (the port's counterpart of
experiments/encoder_kernel_bench.py).

    python experiments/torch_encoder_kernel_bench.py [--batch 256] [--depth 12] [--device cuda]

PARSeq-S geometry: L = 128 tokens, D = 384, 6 heads, MLP 1536, `--depth`
blocks, bf16, random weights from seed 0 (`make_blocks`: q/k/v weights
large enough that attention scores spread by about SCORE_STD) and an N(0,
1) input from seed 1, both drawn with numpy. The three versions run the
same weights on the same input:

  eager    a loop of the port's `models.vit.Block`s (the JAX script's scan);
  library  nn.TransformerEncoder of TransformerEncoderLayer(384, 6, 1536,
           dropout=0, activation='gelu', batch_first=True, norm_first=True)
           in eval and bf16: PyTorch's one call for the same function, on
           its fused fast path;
  B5       ops.encoder_kernel.fused_encoder_blocks, one kernel launch.

On cuda (the default; it raises without a card) each is timed with CUDA
events around one call, median of 20 after warm-up, and printed as
ms/batch, TF/s (the JAX script's FLOP count, 2 B L D (4D + 2L + 2F) per
layer) and img/s, with the card's name and power limit. `--device cpu`
runs the plain versions (the eager loop and B5's plain version) once and
prints how far they agree; it times nothing. The last line is one JSON
object with the results.

`--sweep` (cuda) times instead, at every B of SWEEP_BATCHES, the wall ms a
call (a synchronize before and after, host work included, median of 20):
B5 with its operands built, the model's route to it
(`VisionTransformer.fused_blocks`: the stacked operands' check, then B5)
and the eager blocks; and the smallest B from which the route beats the
eager blocks at every larger B (1 on the H100, so models/vit.py routes every
batch; its docstring keeps the table).
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import numpy as np
import torch
from torch import nn

from parseq_tpu_torch.cli.bench import card_line
from parseq_tpu_torch.models import vit
from parseq_tpu_torch.ops import encoder_kernel

L, D, HEADS, MLP = 128, 384, 6, 1536
SEED = 0
RUNS = 20
SPIN_CYCLES = 50_000_000  # ~25 ms of GPU clock: longer than the host takes to enqueue a timed run
SWEEP_BATCHES = (1, 8, 32, 64, 128, 256, 512)
# Standard deviation of the attention scores that make_blocks aims at: with
# LayerNorm outputs of about N(0, 1), q/k/v weights of variance SCORE_STD / D
# give scores (scaled by 1/sqrt(dh)) of standard deviation about SCORE_STD,
# so the softmax is far from uniform and each head's keys decide its output.
SCORE_STD = 2.5
# Limits of contribution_errors (max, mean) for B5 against its plain version
# on make_blocks weights, at depth 1 and at any depth up to 12. Both take the
# same rounding points with the f32 sums in another order: a value may round
# to the neighbouring bf16 step, and such flips compound over the layers.
# chip_smoke.py's B5 check on an H100 gives at most 0.017 / 3.4e-4 at depth
# 1 and 0.029 / 0.021 at depth 12 (L = 64, 65, 128; B up to 256).
# Planted faults exceed both limits, the mean one twice
# (tests/test_torch_encoder_kernel.py): a head reading another head's keys,
# uniform attention, 8 keys masked, MLP2's last 64-deep k-slice dropped,
# rows 64-127 given rows 0-63's products, the qkv bias dropped.
B5_LIMITS = {1: (2.0 ** -5, 2.0 ** -8), 12: (2.0 ** -4, 2.0 ** -5)}


def make_blocks(depth, seed, dim=D, heads=HEADS, mlp=MLP):
    """`depth` pre-LN blocks (the port's Blocks, f32 parameters) drawn with
    numpy from `seed`, the same on every host: LayerNorm scales 1 + N(0,
    0.1^2), LayerNorm biases N(0, 0.1^2), q/k/v weights N(0, SCORE_STD /
    dim), the other weights and all biases N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    cfg = vit.ViTConfig(embed_dim=dim, depth=depth, num_heads=heads, mlp_ratio=mlp / dim)
    blocks = nn.ModuleList(vit.Block(cfg) for _ in range(depth))
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(tuple(p.shape), dtype=np.float32))
            if '.norm' in name:
                p.copy_(float(name.endswith('weight')) + 0.1 * noise)
            elif name.endswith('qkv.weight'):
                p.copy_((SCORE_STD / dim) ** 0.5 * noise)
            else:
                p.copy_(0.02 * noise)
    return blocks


def contribution_errors(got, want, x):
    """(max, mean) of |got - want| over the (max, mean) of |want - x|: how far
    an encoder output lies from its plain version, relative to what the
    blocks add to their input x (the residual stream would hide it)."""
    diff = (got.float() - want.float()).abs()
    added = (want.float() - x.float()).abs()
    return float(diff.max() / added.max()), float(diff.mean() / added.mean())


def library_encoder(blocks):
    """nn.TransformerEncoder carrying the blocks' weights (pre-LN, exact GELU)."""
    layer = nn.TransformerEncoderLayer(D, HEADS, MLP, dropout=0.0, activation='gelu',
                                       batch_first=True, norm_first=True)
    enc = nn.TransformerEncoder(layer, len(blocks), enable_nested_tensor=False)
    with torch.no_grad():
        for lib, blk in zip(enc.layers, blocks):
            lib.self_attn.in_proj_weight.copy_(blk.attn.qkv.weight)
            lib.self_attn.in_proj_bias.copy_(blk.attn.qkv.bias)
            for dst, src in ((lib.self_attn.out_proj, blk.attn.proj), (lib.linear1, blk.mlp.fc1),
                             (lib.linear2, blk.mlp.fc2), (lib.norm1, blk.norm1),
                             (lib.norm2, blk.norm2)):
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
    return enc.eval()


def eager(blocks, x):
    for blk in blocks:
        x = blk(x)
    return x


def cuda_median_ms(fn, runs=RUNS, warmup=3, calls=1):
    """Median over `runs` of the time per call between two CUDA events.

    calls = 1: one call per event pair, the wrapper's host work included.
    calls > 1: the card first spins for ~25 ms (torch.cuda._sleep) while the
    host enqueues `calls` back-to-back calls behind it, so the events time
    the device work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if calls > 1:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def wall_median_ms(fn, runs=RUNS, warmup=3):
    """Median over `runs` of the wall time of one call, from a synchronized
    card to the card synchronized after it: host and device work both."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def min_batch(rows):
    """The smallest measured B from which the route is faster than the eager
    blocks at every larger measured B (None if it loses at the largest)."""
    best = None
    for row in sorted(rows, key=lambda r: -r['batch']):
        if row['route_ms'] >= row['eager_ms']:
            break
        best = row['batch']
    return best


def sweep(blocks, depth, dev, card):
    """The --sweep table (rows of batch, b5_ms, route_ms, eager_ms) and the
    host us a call of the gate and of the kept operands' check."""
    cfg = vit.ViTConfig(embed_dim=D, depth=depth, num_heads=HEADS, mlp_ratio=MLP / D)
    enc = vit.VisionTransformer(cfg).to(dev)
    enc.blocks = blocks
    op = encoder_kernel.stack_block_params(blocks)
    rows = []
    for B in SWEEP_BATCHES:
        x = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
            (B, L, D), dtype=np.float32)).to(dev, torch.bfloat16)
        row = {'batch': B,
               'b5_ms': wall_median_ms(
                   lambda: encoder_kernel.fused_encoder_blocks(op, x, num_heads=HEADS)),
               'route_ms': wall_median_ms(lambda: enc.fused_blocks(x)),
               'eager_ms': wall_median_ms(lambda: eager(blocks, x))}
        rows.append(row)
        print(f'sweep B={B:4d} depth={depth} bf16 [{card}]: B5 {row["b5_ms"]:8.4f}  route '
              f'{row["route_ms"]:8.4f}  eager {row["eager_ms"]:8.4f} wall ms a call', flush=True)
    taken = vit.takes_encoder_kernel(x.device, x.dtype, x.shape, HEADS, enc.blocks)
    t0 = time.perf_counter()
    for _ in range(100):
        vit.takes_encoder_kernel(x.device, x.dtype, x.shape, HEADS, enc.blocks)
    gate_us = (time.perf_counter() - t0) * 1e4
    t0 = time.perf_counter()
    for _ in range(100):
        enc.stacked_blocks()
    kept_us = (time.perf_counter() - t0) * 1e4
    print(f'the gate (vit.takes_encoder_kernel) at B={B}: {taken}, {gate_us:.1f} us a call; '
          f'the kept operands (VisionTransformer.stacked_blocks) {kept_us:.1f} us a call')
    return rows, gate_us, kept_us


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--depth', type=int, default=12)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--sweep', action='store_true',
                    help=f'wall ms a call at B in {SWEEP_BATCHES} (cuda)')
    args = ap.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('torch_encoder_kernel_bench: no CUDA device (pass --device cpu for '
                           'the plain versions)')
    dev = torch.device(args.device)
    B, depth = args.batch, args.depth
    blocks = make_blocks(depth, SEED)
    x = torch.from_numpy(
        np.random.default_rng(SEED + 1).standard_normal((B, L, D), dtype=np.float32))
    flops = 2 * B * L * D * (4 * D + 2 * L + 2 * MLP) * depth
    result = {'batch': B, 'depth': depth, 'L': L, 'D': D, 'heads': HEADS, 'mlp': MLP,
              'device': args.device, 'flops': flops}

    with torch.inference_mode():
        if args.device == 'cpu':
            x32 = x.to(dev)
            want = eager(blocks, x32)
            got = encoder_kernel.fused_encoder_blocks(
                encoder_kernel.stack_block_params(blocks, torch.float32), x32, num_heads=HEADS)
            result['max_abs_diff_f32'] = float((got - want).abs().max())
            print(f'B={B} depth={depth} f32 on cpu: B5 plain version vs eager blocks, max abs '
                  f'difference {result["max_abs_diff_f32"]:.3e}; no times (no card)')
            print(json.dumps(result))
            return result

        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        blocks = blocks.to(dev)
        if args.sweep:
            rows, result['gate_us'], result['kept_us'] = sweep(blocks, depth, dev, card)
            result.update(sweep=rows, min_batch=min_batch(rows), card=card)
            print(f'route faster than the eager blocks from B = {result["min_batch"]} on')
            print(card)
            print(json.dumps(result))
            return result
        lib = library_encoder(blocks).to(dev, torch.bfloat16)
        op = encoder_kernel.stack_block_params(blocks)
        xb = x.to(dev, torch.bfloat16)
        versions = {
            'eager': lambda: eager(blocks, xb),
            'library': lambda: lib(xb),
            'b5': lambda: encoder_kernel.fused_encoder_blocks(op, xb, num_heads=HEADS),
        }
        outs = {name: fn().float() for name, fn in versions.items()}
        for name in ('library', 'b5'):
            result[f'max_abs_diff_{name}_vs_eager'] = float((outs[name] - outs['eager']).abs().max())
        del outs
        for name, fn in versions.items():
            ms = cuda_median_ms(fn)
            result[f'{name}_ms'] = ms
            print(f'{name:8s} B={B} depth={depth} bf16 [{card}]: {ms:8.4f} ms/batch  '
                  f'{flops / ms / 1e9:6.1f} TF/s  {B / ms * 1e3:8.0f} img/s', flush=True)
    result['card'] = card
    print(f'B5 vs eager {result["max_abs_diff_b5_vs_eager"]:.3e}, library vs eager '
          f'{result["max_abs_diff_library_vs_eager"]:.3e} (max abs, bf16; eager uses the tanh '
          f'GELU at bf16, B5 and the library the exact one)')
    print(card)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
