"""The share of the traced span's abinet.backbone spans in which csrc/bn_act.cu
ran: the span's attribute `bn_kernel` counts the kernel's launches in the
forward (the program reads its launch counter before and after ResNet45),
so a span counts where it is above 0. None where no such span carries the
attribute (a program from before the kernel)."""

from harness import spans


def read(outcome, ctx):
    p = spans.placed(outcome, ctx)
    if p is None:
        return None
    on = [s['attrs']['bn_kernel'] for s in p.spans
          if s['name'] == 'abinet.backbone' and 'bn_kernel' in s['attrs']]
    return sum(map(bool, on)) / len(on) if on else None
