"""B2's least time at ABINet's shape (batch, the (H / 4) x (W / 4) feature
positions, heads, d_model; roofline/kernels/b2.py) over its mean device
time a call in the traced span."""

from harness.readers import roofline_pct


def read(outcome, ctx):
    m = ctx.cell.config['model']
    (H, W) = m['img_size']
    return roofline_pct(outcome, 'b2', lambda k: k.bound_ms(
        outcome.layer['batch'], (H // 4) * (W // 4), m['nhead'], m['d_model']))
