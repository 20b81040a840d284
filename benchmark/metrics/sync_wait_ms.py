"""Host ms a read batch in the program's span eval.wait: blocked on the batch
in flight (its event's synchronize) before decoding it (harness/spans.py)."""

from harness import spans


def read(outcome, ctx):
    return spans.per_iteration(outcome, ctx, 'read', 'eval.wait')
