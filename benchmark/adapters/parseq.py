"""The program's side of PARSeq for the drivers: the entries its greedy AR
pass runs through, and its encoder's blocks."""

# named in the read driver's check that every batch ran the AR pass once
AR_ENTRIES = ('parseq_tpu_torch.ops.ar_kernel.ar_decode_fused (on the card) or '
              'PARSeq.ar_decode (elsewhere)')


def wrap_ar(bundle, on_logits):
    """Wrap the AR pass of `bundle` so that each call hands its logits to
    on_logits; returns the callables that undo it."""
    import torch
    from parseq_tpu_torch.ops import ar_kernel

    module = bundle.module
    orig_fused, orig_scan = ar_kernel.ar_decode_fused, module.ar_decode

    def fused(model, memory, rows=None):
        logits = orig_fused(model, memory, rows=rows)
        on_logits(logits)
        return logits

    def scan(memory, dtype=torch.float32, early_exit=False):
        logits = orig_scan(memory, dtype, early_exit=early_exit)
        on_logits(logits)
        return logits

    ar_kernel.ar_decode_fused = fused
    module.ar_decode = scan
    return [lambda: setattr(ar_kernel, 'ar_decode_fused', orig_fused),
            lambda: delattr(module, 'ar_decode')]


def encoder_blocks(bundle):
    return bundle.module.encoder.blocks
