"""Host ms a batch inside the bundle's tokenizer.decode_ids, over the
window's batches (a wrapper the read driver puts on it)."""

from harness.readers import mean


def read(outcome, ctx):
    return mean(outcome.layer.get('host_decode_ms', []))
