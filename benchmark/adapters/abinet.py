"""The program's side of ABINet for the drivers: the lengths its language
passes took, handed over as the AR picks its reference is teacher-forced
on (reference/abinet.py), and its vision transformer's layers."""

# named in the read driver's check that every batch handed its lengths once
AR_ENTRIES = 'parseq_tpu_torch.models.abinet.ABINet.forward_iterations'


def wrap_ar(bundle, on_logits):
    """Wrap the bundle's ABINet.forward_iterations so that each call hands
    on_logits a (B, T, C) one-hot tensor whose argmax holds at position j
    the length derivation j gave (0: the vision logits; j >= 1: the
    alignment of iteration j - 1), before the clamp, for j < iter_size, and
    0 after; returns the callables that undo it."""
    import torch
    import torch.nn.functional as F

    module = bundle.module
    orig = module.forward_iterations

    def forward_iterations(images, dtype=torch.float32, rng=None):
        all_a, all_l, v_res = orig(images, dtype, rng)
        derived = [v_res, *all_a[:-1]]
        T, C = v_res['logits'].shape[1:]
        picks = torch.zeros(len(images), T, dtype=torch.long, device=images.device)
        picks[:, :len(derived)] = torch.stack([r['pt_lengths'] for r in derived], 1)
        on_logits(F.one_hot(picks, C))
        return all_a, all_l, v_res

    module.forward_iterations = forward_iterations
    return [lambda: delattr(module, 'forward_iterations')]


def encoder_blocks(bundle):
    return bundle.module.vision.backbone.transformer.layers
