"""Int8 serving path for the ViT encoder's products (port of
parseq_tpu/ops/quant.py).

- ``quantize_linear(linear)``: per-output-channel symmetric int8 weight
  quantization of an nn.Linear -> ``Int8Linear`` (buffers ``w_q`` int8
  (out, in), ``w_scale`` f32 (out,), ``bias``).
- ``int8_linear(x, weight, bias)``: dynamic per-token symmetric activation
  quantization (``max|x| / 127``, round half to even, clamp to +-127), an
  int8 x int8 -> int32 product (``torch._int_mm``), and the rescale
  ``acc * x_scale * w_scale + b`` in f32, cast to x's dtype.
  ``layers.linear`` dispatches to it when its weight is an ``Int8Weight``,
  so every call site of a quantized block runs it unchanged.
- ``quantize_tree(module, paths)``: a copy of a module with the nn.Linear
  submodules at `paths` quantized; ``quantize_vit_encoder`` and
  ``quantize_bundle`` apply it to the encoder blocks' four products (qkv,
  proj, fc1, fc2). The patch embedding, LayerNorms, positional table and
  any decoder stay in high precision.

The blocks hold q|k|v as one packed (3D, D) weight, quantized as one: the
JAX package quantizes q, k and v apart, but the per-token activation scale
is the same x for all three and the weight scales are per output row, so
the packed product's codes, accumulations and outputs are the three
products' concatenated. A PARSeq-S block runs 4 int8 products, where the
JAX package runs 6.

The JAX package does this product outside any Pallas kernel (a
dot_general with int32 accumulation), and so does the port: a library
product, as torch.matmul is for bf16. On a CUDA tensor `_int_mm` needs
M > 16 rows and K, N multiples of 8; another shape raises here, never
falling back to a bf16 product. Opt-in: nothing quantizes unless the
caller asks (`--int8` of cli/read.py, test.py, bench.py and serve.py).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch
from torch import nn

# The encoder block's products, as submodule paths of a ViT Block.
BLOCK_LINEARS = ('attn.qkv', 'attn.proj', 'mlp.fc1', 'mlp.fc2')


class Int8Weight(NamedTuple):
    """A quantized weight as layers.linear takes it: int8 codes (out, in)
    and their f32 per-output-channel scales (out,)."""

    w_q: torch.Tensor
    w_scale: torch.Tensor


class Int8Linear(nn.Module):
    """nn.Linear's place in a quantized block. `weight` is the Int8Weight
    that layers.linear dispatches on; `bias` stays f32."""

    def __init__(self, w_q, w_scale, bias=None):
        super().__init__()
        self.register_buffer('w_q', w_q)
        self.register_buffer('w_scale', w_scale)
        self.register_buffer('bias', bias)

    @property
    def weight(self) -> Int8Weight:
        return Int8Weight(self.w_q, self.w_scale)


def _div127(amax):
    """amax / 127, correctly rounded on every device: on CUDA a division by a
    Python scalar multiplies by its rounded reciprocal, which is an ulp off
    the CPU's and the JAX package's quotient for some amax."""
    return amax / torch.full_like(amax, 127.0)


def quantize_weight(w):
    """f32 (out, in) -> (int8 codes (out, in), f32 scales (out,)): symmetric,
    one scale per output channel, max|row| / 127 (at least 1e-12)."""
    w = w.detach().float()
    scale = torch.clamp_min(_div127(w.abs().amax(dim=1, keepdim=True)), 1e-12)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q.contiguous(), scale.reshape(-1)


def quantize_linear(linear: nn.Linear) -> Int8Linear:
    """An nn.Linear -> Int8Linear on the same device."""
    w_q, w_scale = quantize_weight(linear.weight)
    bias = None if linear.bias is None else linear.bias.detach().float().clone()
    return Int8Linear(w_q, w_scale, bias)


def is_quantized(weight) -> bool:
    return isinstance(weight, Int8Weight)


def quantize_activations(x2):
    """(M, K) activations -> (int8 codes (M, K), f32 scales (M, 1)):
    symmetric, one scale per token, max|row| / 127 (at least 1e-12)."""
    x32 = x2.float()
    x_scale = torch.clamp_min(_div127(x32.abs().amax(dim=-1, keepdim=True)), 1e-12)
    return torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8), x_scale


def _check_shape(M, K, N, device):
    if device.type == 'cuda' and not (M > 16 and K % 8 == 0 and N % 8 == 0):
        raise ValueError(f'int8 product of ({M}, {K}) x ({K}, {N}) on cuda: torch._int_mm '
                         f'needs M > 16 and K, N multiples of 8')


def int8_accumulate(x_q, w_q):
    """int8 (M, K) x int8 codes (N, K) -> int32 (M, N). `w_q` is stored
    (out, in) row-major and passed as its transpose, a column-major (K, N)
    view: the layout cuBLASLt's int8 product takes without a copy."""
    _check_shape(x_q.shape[0], x_q.shape[1], w_q.shape[0], x_q.device)
    return torch._int_mm(x_q, w_q.t())


def int8_linear(x, weight: Int8Weight, bias=None):
    """y = x @ dequant(w_q).T + b through an int8 x int8 -> int32 product,
    in x's dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    x_q, x_scale = quantize_activations(x.reshape(-1, K))
    acc = int8_accumulate(x_q, weight.w_q)
    y = acc.float() * x_scale * weight.w_scale
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, -1).to(x.dtype)


def quantize_tree(module: nn.Module, paths) -> nn.Module:
    """A copy of `module` with the nn.Linear submodules at `paths` (dotted
    names, e.g. 'encoder.blocks.0.mlp.fc1') replaced by Int8Linear; the
    original is left as it was. A path that names no nn.Linear raises
    KeyError."""
    module = copy.deepcopy(module)
    for path in paths:
        parent, _, name = path.rpartition('.')
        try:
            owner = module.get_submodule(parent) if parent else module
        except AttributeError as e:
            raise KeyError(path) from e
        child = getattr(owner, name, None)
        if not isinstance(child, nn.Linear):
            raise KeyError(f'{path}: {type(child).__name__}, not an nn.Linear')
        setattr(owner, name, quantize_linear(child))
    return module


def vit_paths(vit, prefix=''):
    """The four products of every block of a VisionTransformer."""
    return [f'{prefix}blocks.{i}.{p}' for i in range(len(vit.blocks)) for p in BLOCK_LINEARS]


def quantize_vit_encoder(vit):
    """A copy of a VisionTransformer with every block's qkv, proj, fc1 and
    fc2 quantized."""
    return quantize_tree(vit, vit_paths(vit))


def _encoder_paths(module, name):
    """The four products of every encoder block of a PARSeq or ViTSTR
    module; ValueError naming ViT for another family."""
    from parseq_tpu_torch.models.parseq import PARSeq
    from parseq_tpu_torch.models.vitstr import ViTSTR

    if isinstance(module, PARSeq):
        return vit_paths(module.encoder, 'encoder.')
    if isinstance(module, ViTSTR):
        return vit_paths(module)
    raise ValueError(f'int8 serving currently supports ViT-backed models '
                     f'(parseq/vitstr); {name!r} has no ViT encoder')


def quantize_bundle(bundle):
    """Opt-in int8 serving: a copy of a registry ModelBundle with its ViT
    encoder's products quantized (parseq and vitstr, the families with a
    ViT encoder). Other families raise ValueError."""
    paths = _encoder_paths(bundle.module, bundle.name)
    return dataclasses.replace(bundle, module=quantize_tree(bundle.module, paths))


# The card check of the int8 path against the model it was quantized from
# (chip_smoke.py phase 12; the CPU tests run it at a small width, with the
# same planted faults). Random init gives every weight row nearly the same
# max|w| (a truncated normal), where codes made with per-input-channel
# scales would look right, so the check first scales each block product's
# rows by seeded log-uniform factors in [1 / CHECK_SPREAD, CHECK_SPREAD],
# as a trained model's rows differ. It compares logits that depend on the
# encoder alone (ViTSTR's; PARSeq's NAR decode, whose context is BOS only,
# so no greedy pick feeds back): max |int8 - reference| relative to
# max|reference| within CHECK_LIMITS, and greedy picks equal wherever the
# reference's top-2 margin exceeds that error. On an H100 (random weights,
# rows spread, 32 images, seeds 0-2) the sound int8 path read at most
# 0.0163 (PARSeq-S) and 0.0538 (ViTSTR-S), codes made with per-input-channel
# scales at least 0.465 and 0.835: CHECK_LIMITS lies between, about 3x and
# 2x above the sound readings. `check_reads` then holds the reads' own
# logits (PARSeq's after the AR decode and refinement) image by image.
CHECK_SPREAD = 4.0
CHECK_LIMITS = {'parseq': 0.05, 'vitstr': 0.1}
PLANTED_FAULTS = ('input_channel_scales', 'fc2_unquantized')


@torch.no_grad()
def spread_rows(module, seed):
    """Scale the rows of every encoder block product of `module` (in place)
    by numpy-drawn log-uniform factors in [1 / CHECK_SPREAD, CHECK_SPREAD]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear) and name.endswith(BLOCK_LINEARS):
            f = np.exp(rng.uniform(-np.log(CHECK_SPREAD), np.log(CHECK_SPREAD),
                                   m.weight.shape[0])).astype(np.float32)
            m.weight.mul_(torch.from_numpy(f).to(m.weight.device)[:, None])


def check_logits(module, images, dtype):
    """Logits of `module` that depend on its encoder alone (see above)."""
    from parseq_tpu_torch.models.parseq import PARSeq

    with torch.inference_mode():
        if isinstance(module, PARSeq):
            return module.nar_decode(module.encode(images.to(dtype)), dtype).float()
        return module(images, dtype=dtype).float()


def check_errors(got, want, limit):
    """-> (max |got - want| / max|want|, positions whose margin exceeds the
    error, greedy picks equal there, passes)."""
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > err
    agree = bool((got.argmax(-1) == want.argmax(-1))[confident].all())
    passes = bool(torch.isfinite(got).all()) and got.shape == want.shape and rel <= limit and agree
    return rel, int(confident.sum()), agree, passes


def check_reads(got, want, eos_id):
    """The reads' logits (B, T, C), int8 against the reference, image by
    image: with err_i = max |got_i - want_i|, the greedy picks must be equal
    wherever want_i's top-2 margin exceeds err_i, and an image whose every
    step through the reference's first EOS has such a margin is decided:
    its read must be the reference's. -> (positions whose margin exceeds
    their image's error, picks equal there, a (B,) bool tensor of the
    decided images)."""
    err = (got - want).abs().amax(dim=(1, 2), keepdim=True)[..., 0]
    top2 = want.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > err
    picks = want.argmax(-1)
    agree = bool((got.argmax(-1) == picks)[confident].all())
    steps = torch.arange(picks.shape[1], device=picks.device)
    is_eos = picks == eos_id
    first_eos = torch.where(is_eos.any(1), is_eos.int().argmax(1), picks.shape[1] - 1)
    decided = (confident | (steps > first_eos[:, None])).all(1)
    return int(confident.sum()), agree, decided.cpu()


def planted_fault(module, name, fault):
    """A quantized copy of a PARSeq or ViTSTR module with one of
    PLANTED_FAULTS, which the card check must catch:
    'input_channel_scales' makes every code with per-input-channel scales
    (the stored scales stay per output channel); 'fc2_unquantized' leaves
    the last block's fc2 in high precision, one int8 product short."""
    paths = _encoder_paths(module, name)
    if fault == 'fc2_unquantized':
        return quantize_tree(module, paths[:-1])
    if fault != 'input_channel_scales':
        raise ValueError(f'{fault!r} is none of {PLANTED_FAULTS}')
    faulty = quantize_tree(module, paths)
    with torch.no_grad():
        for path in paths:
            w = module.get_submodule(path).weight.detach().float()
            s_in = torch.clamp_min(_div127(w.abs().amax(dim=0, keepdim=True)), 1e-12)
            faulty.get_submodule(path).w_q.copy_(
                torch.clamp(torch.round(w / s_in), -127, 127).to(torch.int8))
    return faulty


class count_int_mm:
    """Counts the aten._int_mm calls dispatched while active (`.calls`):
    the int8 products of a forward, 4 a quantized block."""

    def __init__(self):
        self.calls = 0
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten._int_mm.default:
                    counter.calls += 1
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
