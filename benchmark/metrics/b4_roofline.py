"""B4's least time at the step's shape (batch a microbatch, heads, tokens,
head width; roofline/kernels/b4.py) over its mean device time a call in the
traced span."""

from harness.readers import roofline_pct


def read(outcome, ctx):
    m = ctx.cell.config['model']
    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    heads = m['enc_num_heads']
    B = outcome.layer['batch'] // ctx.cell.traffic['microbatches']
    return roofline_pct(outcome, 'b4', lambda k: k.bound_ms(
        B, heads, (H // ph) * (W // pw), m['embed_dim'] // heads))
