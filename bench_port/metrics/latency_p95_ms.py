"""95th percentile, over every request due in the window, of the time
from its due time to its completion on the host; a request that never
completed counts as the window plus the drain limit."""

from bench_port.loops import DRAIN_LIMIT_S
from bench_port.readers import percentile


def read(ctx):
    rec = ctx.rec
    due = [q for q in rec.reqs.values() if q.in_window]
    if rec.loop != "open" or not due:
        return None
    worst = rec.seconds + DRAIN_LIMIT_S
    return 1e3 * percentile([worst if q.latency_s is None else q.latency_s
                             for q in due], 95)
