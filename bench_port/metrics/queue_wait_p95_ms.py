"""95th percentile of the wait from a request's due time to its
admission into a slot (admissions happen only at chunk boundaries), over
the requests due in the window."""

from bench_port.readers import percentile


def read(ctx):
    waits = [q.admitted_wall - q.due_wall for q in ctx.rec.reqs.values()
             if q.in_window and q.wave >= 0 and q.due_wall]
    return 1e3 * percentile(waits, 95) if waits else None
