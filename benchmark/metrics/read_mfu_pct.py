"""The read's FLOPs an image (the configuration's `read_flops` formula,
roofline/flops/) times the images the traced span read, over the span's
length, as a share of the bf16 peak of 989 TFLOP/s."""

from harness.readers import mfu_pct


def read(outcome, ctx):
    return mfu_pct(outcome, ctx, ctx.cell.config['read_flops'])
