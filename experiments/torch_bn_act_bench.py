#!/usr/bin/env python
"""Microbench of csrc/bn_act.cu (ops/cnn.py:bn_act): eval-mode batch norm,
shortcut and ReLU in one pass, against the separate calls it replaces.

    python experiments/torch_bn_act_bench.py [--out bench_out/bn_act_bench.json]

Needs a card (raises without one). At every (C, H, W) an ABINet batch norm
meets at 32 x 128, B = 512, bf16, channels-last (the layout cuDNN returns
for the port's NHWC images), in the forms the model calls (`relu`:
relu(bn(y)); `identity`: relu(bn(y) + r); `normed`: relu(bn(y) + bn_s(r));
`plain`: bn(y), CRNN's and TRBA's call) with random statistics:

  kernel  cnn.bn_act, one launch;
  plain   the same call inside kernels.plain(): batchnorm's five passes,
          the shortcut's add, the ReLU.

Each is timed with CUDA events around 20 calls, median of 5 such windows
after 3 warm-up calls, as ms a call; the calls of a window are queued
behind a spin of the card (torch.cuda._sleep), so the events time device
work alone, not the host's pace of launches. `bound_ms` is the bytes one pass must
move (y read, out written, r read: 2 B an element each in bf16) over 3.35
TB/s; `roofline_pct` is bound / kernel. Maps under the 50 MB L2 stay
resident across calls, so their shares can pass what device memory allows.

`sites` sums those times over the 53 sites of one ABINet read forward
(`abinet_sites`). Then ABINet's ResNet45 and position attention (published widths, bf16,
B = 512, random statistics) as the read runs them, and inside
kernels.plain(): device ms a forward (events around 10 forwards queued
behind a longer spin, median of 5), and whether the outputs agree bit for
bit.

Prints a table and, as the last line, one JSON object with the card's name
and power limit; writes the same object to --out.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import torch
from torch import nn

from parseq_tpu_torch import kernels
from parseq_tpu_torch.ops import cnn

PEAK_BYTES_S = 3.35e12
# spins of the card before a timed window, longer than the host takes to
# queue the window's calls: ~25 ms for 20 calls of one site, ~250 ms for 10
# forwards (the plain ResNet45's ~500 launches a forward)
SPIN_CYCLES = 50_000_000
MODEL_SPIN_CYCLES = 500_000_000
SHAPES = [(32, 32, 128), (32, 16, 64), (64, 16, 64), (128, 16, 64), (128, 8, 32), (256, 8, 32),
          (512, 8, 32), (64, 8, 16), (64, 4, 8), (64, 2, 4), (64, 1, 2)]
FORMS = {'relu': (True, None), 'identity': (True, 'identity'), 'normed': (True, 'normed'),
         'plain': (False, None)}


def abinet_sites():
    """(C, H, W, form) of every batch norm site of an ABINet read forward at
    32 x 128: ResNet45's stem and blocks (relu(bn1(conv1)), then relu(bn2(conv2)
    + shortcut)), then the U-Net's four encoder and four decoder stages."""
    sites, cin, H, W = [(32, 32, 128, 'relu')], 32, 32, 128
    for planes, blocks, stride in zip((32, 64, 128, 256, 512), (3, 4, 6, 6, 3), (2, 1, 2, 1, 1)):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            sites.append((planes, H, W, 'relu'))
            H, W = H // s, W // s
            sites.append((planes, H, W, 'normed' if s != 1 or cin != planes else 'identity'))
            cin = planes
    for C, H, W in ((64, 8, 16), (64, 4, 8), (64, 2, 4), (64, 1, 2), (64, 2, 4), (64, 4, 8),
                    (64, 8, 16), (512, 8, 32)):
        sites.append((C, H, W, 'relu'))
    return sites


def _random_bn(C, seed):
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.5)
        bn.weight.copy_(1 + torch.randn(C, generator=g) * 0.3)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.5)
    return bn.cuda().eval()


def _time_ms(fn, calls=20, windows=5, warmup=3, spin=SPIN_CYCLES):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def bench_shapes(batch):
    rows = []
    for C, H, W in SHAPES:
        shape = (batch, C, H, W)
        g = torch.Generator(device='cuda').manual_seed(C * H)
        y = torch.randn(shape, generator=g, device='cuda').bfloat16()
        y = y.contiguous(memory_format=torch.channels_last)
        r = torch.randn(shape, generator=g, device='cuda').bfloat16()
        r = r.contiguous(memory_format=torch.channels_last)
        bn, bn_r = _random_bn(C, 1), _random_bn(C, 2)
        for form, (relu, shortcut) in FORMS.items():
            residual = None if shortcut is None else r
            residual_bn = bn_r if shortcut == 'normed' else None

            def call():
                return cnn.bn_act(y, bn, relu, residual, residual_bn)

            with torch.inference_mode():
                assert cnn.takes_kernel(y, bn, residual, residual_bn)
                kernel_ms = _time_ms(call)
                with kernels.plain():
                    plain_ms = _time_ms(call)
            nbytes = y.numel() * 2 * (2 + (shortcut is not None))
            bound_ms = nbytes / PEAK_BYTES_S * 1e3
            rows.append({'shape': list(shape), 'form': form, 'kernel_ms': kernel_ms,
                         'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bytes': nbytes,
                         'roofline_pct': 100 * bound_ms / kernel_ms,
                         'TB_s': nbytes / kernel_ms * 1e-9})
    return rows


def bench_model(batch):
    from parseq_tpu_torch.utils import registry

    model = registry.create_model('abinet', device='cuda', dtype=torch.bfloat16).module
    for i, m in enumerate(m for m in model.modules() if isinstance(m, nn.BatchNorm2d)):
        m.load_state_dict(_random_bn(m.num_features, 100 + i).state_dict())
    model.eval()
    resnet, attention = model.vision.backbone.resnet, model.vision.attention
    images = torch.rand((batch, 32, 128, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    x = images.to('cuda', torch.bfloat16).permute(0, 3, 1, 2)
    out = {}
    with torch.inference_mode():
        feats = resnet(x)
        for name, ctx in (('kernel', contextlib.nullcontext()), ('plain', kernels.plain())):
            with ctx:
                out[f'resnet_{name}_ms'] = _time_ms(lambda: resnet(x), calls=10, warmup=2,
                                                    spin=MODEL_SPIN_CYCLES)
                out[f'attention_{name}_ms'] = _time_ms(lambda: attention(feats), calls=10,
                                                       warmup=2, spin=MODEL_SPIN_CYCLES)
                out[name] = [t.view(torch.int16) for t in (resnet(x), attention(feats))]
        got, want = out.pop('kernel'), out.pop('plain')
        out['resnet_equal'] = bool(torch.equal(got[0], want[0]))
        out['attention_equal'] = bool(torch.equal(got[1], want[1]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--out', default='bench_out/bn_act_bench.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    result = {'card': card, 'device': torch.cuda.get_device_name(0), 'batch': args.batch,
              'shapes': bench_shapes(args.batch), 'model': bench_model(args.batch)}
    by = {(*r['shape'][1:], r['form']): r for r in result['shapes']}
    sites = abinet_sites()
    result['sites'] = {'count': len(sites),
                       **{f'{k}_ms': sum(by[s][f'{k}_ms'] for s in sites)
                          for k in ('kernel', 'plain', 'bound')}}
    print(f'{card}; B = {args.batch}, bf16, channels-last')
    print(f'{"shape":>22} {"form":>9} {"kernel ms":>10} {"plain ms":>10} {"bound ms":>9} '
          f'{"TB/s":>6} {"roofline":>8}')
    for r in result['shapes']:
        print(f'{str(tuple(r["shape"])):>22} {r["form"]:>9} {r["kernel_ms"]:10.4f} '
              f'{r["plain_ms"]:10.4f} {r["bound_ms"]:9.4f} {r["TB_s"]:6.3f} '
              f'{r["roofline_pct"]:7.1f}%')
    print('model:', json.dumps(result['model']))
    print('the forward\'s sites, each timed alone, summed:', json.dumps(result['sites']))
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
