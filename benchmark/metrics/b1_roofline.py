"""B1's least time at the cell's shape (memory (batch, patches, D) to
max_label_length + 1 steps of logits; roofline/kernels/b1.py) over its mean
device time a call in the traced span."""

from harness.readers import roofline_pct


def read(outcome, ctx):
    m = ctx.cell.config['model']
    (H, W), (ph, pw) = m['img_size'], m['patch_size']
    D, C = m['embed_dim'], len(m['charset_train']) + 1
    return roofline_pct(outcome, 'b1', lambda k: k.bound_ms(
        outcome.layer['batch'], (H // ph) * (W // pw), D, m['dec_num_heads'],
        m['max_label_length'] + 1, C, int(D * m['dec_mlp_ratio']), C + 2))
