"""The dense attention kernel's share of its roofline: the least time of
its launches in the window (a layer a step), over their device time."""

from bench_port import counts
from bench_port.readers import DENSE_KERNELS, roofline


def read(ctx):
    rec = ctx.rec
    if rec.loop != "sampler":
        return None
    launches = rec.launches.get("dense_attention", 0)
    least = launches * counts.dense_attention_s(ctx.d, rec.slots,
                                                 rec.seq_len)
    return roofline(ctx, DENSE_KERNELS, least)
