"""Device ms a batch of the encoder's blocks: CUDA events recorded by a
forward pre-hook on the first block and a forward hook on the last, over
the window's batches of a traced run."""

from harness.readers import mean


def read(outcome, ctx):
    return mean(outcome.layer.get('encoder_ms', []))
