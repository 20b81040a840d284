"""B5's least time at the cell's shape (batch, patches, D, D * MLP ratio,
depth; roofline/kernels/b5.py) over its mean device time a call in the
traced span; None where the trace has no call of it (the eager blocks)."""

from harness.readers import roofline_pct


def read(outcome, ctx):
    m = ctx.cell.config['model']
    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    D = m['embed_dim']
    return roofline_pct(outcome, 'b5', lambda k: k.bound_ms(
        outcome.layer['batch'], (H // ph) * (W // pw), D, int(D * m['enc_mlp_ratio']),
        m['enc_depth']))
