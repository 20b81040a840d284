"""Blocking CUDA calls a read batch that the host made inside the program's
eval.forward spans on the main thread: the trace's cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize calls (a synchronizing copy
makes one) whose start lies in such a span, over the count of eval.h2d
spans (harness/spans.py). Each one holds the host until the card has run
everything queued before it, so the host cannot queue ahead of the card."""

from bisect import bisect_right

from harness import spans

SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize', 'cudaEventSynchronize')


def read(outcome, ctx):
    p = spans.placed(outcome, ctx)
    if p is None:
        return None
    n = p.count(spans.ITERATION['read'])
    if not n:
        return None
    forward = sorted((p.spans[i]['ts'], p.spans[i]['te']) for i in p.main
                     if p.spans[i]['name'] == 'eval.forward')
    starts = [ts for ts, _ in forward]
    calls = 0
    for hs, _, name in p.trace.host:
        if name.startswith(SYNCS):
            i = bisect_right(starts, hs) - 1
            calls += i >= 0 and hs <= forward[i][1]
    return calls / n
