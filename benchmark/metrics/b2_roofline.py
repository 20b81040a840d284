"""B2's least time at the cell's shape (batch, tokens, heads, D;
roofline/kernels/b2.py) over its mean device time a call in the traced
span."""

from harness.readers import roofline_pct


def read(outcome, ctx):
    m = ctx.cell.config['model']
    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    L = (H // ph) * (W // pw) + 1  # the class token
    return roofline_pct(outcome, 'b2', lambda k: k.bound_ms(
        outcome.layer['batch'], L, m['num_heads'], m['embed_dim']))
