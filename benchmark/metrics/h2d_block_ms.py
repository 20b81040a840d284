"""Host ms a read batch in the program's span eval.h2d: the input copy from
pageable memory, which waits behind the batch in flight (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'eval.h2d')
