"""The share of the traced span's vit.encoder spans whose blocks ran as one
launch of kernel B5 (the span's attribute `fused`); None where no such span
carries the attribute (a program from before the route)."""

from harness import spans


def read(outcome, ctx):
    p = spans.placed(outcome, ctx)
    if p is None:
        return None
    fused = [s['attrs']['fused'] for s in p.spans
             if s['name'] == 'vit.encoder' and 'fused' in s['attrs']]
    return sum(map(bool, fused)) / len(fused) if fused else None
