"""The paged attention's share of its roofline: the least time of the
window's `paged_unpack` and batched paged attention launches, from the
live pages and the widths each step reads, over their device time."""

from bench_port import counts
from bench_port.readers import PAGED_KERNELS, roofline


def read(ctx):
    rec = ctx.rec
    if rec.loop == "sampler":
        return None
    launches = rec.launches.get("batched_paged_attention", 0)
    if not launches:
        return None
    least = counts.paged_window_s(ctx.d, rec, ctx.traffic["page_size"],
                                  launches)
    return roofline(ctx, PAGED_KERNELS, least)
