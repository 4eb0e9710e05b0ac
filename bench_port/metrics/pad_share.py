"""Per cent of the positions the server computes (slots x seq_len a step,
over the `batcher.steps` of the window) that belong to no request's
tokens: empty slots and the padding past each request's length."""

from bench_port import counts


def read(ctx):
    rec = ctx.rec
    steps = rec.counters.get("batcher.steps", 0)
    if rec.loop not in ("backlog", "open") or not steps:
        return None
    used = sum(L for active in counts.occupancy(rec).values()
               for L, _, _ in active)
    return 100.0 * (1.0 - used / (steps * rec.slots * rec.seq_len))
