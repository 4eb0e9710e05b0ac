"""What the metric readers (`metrics/<name>.py`) share.

A reader is a module with `read(ctx) -> float | None`; it returns None
where its cell gives it nothing to read, and the harness then leaves the
metric out. `ctx` carries the run: `rec` (the loop's `Record`), `d`
(`Dims`), `traffic`, `trace` (the device trace, None without `--trace
1`), `setup_s`, `peak_bytes` and `fused_mlp`.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Optional

from bench_port import counts

METRICS = Path(__file__).resolve().parent / "metrics"

# the kernels of each family, by the names they carry in the trace
W4A8_KERNELS = ("quant_rows_kernel", "int8_gemm_kernel", "int8_gemm_reduce",
                "int8_mlp_kernel")
PAGED_KERNELS = ("paged_unpack_kernel", "paged_flash_kernel")
DENSE_KERNELS = ("dense_attention_kernel",)


def load(name: str):
    """The reader of metric `name`."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def steps_of(rec, traffic: dict) -> int:
    """Denoise steps run in the window (every slot steps at once)."""
    return (rec.calls * traffic["num_steps"] if rec.loop == "sampler"
            else rec.steps)


def denoise_steps(ctx) -> int:
    return steps_of(ctx.rec, ctx.traffic)


def step_ms(ctx) -> Optional[float]:
    n = denoise_steps(ctx)
    return ctx.rec.window_s * 1e3 / n if n else None


def tokens_per_s(ctx) -> Optional[float]:
    """Generated tokens a second over the whole window. The server credits
    each slot-step of a request seq_len / num_steps tokens, so requests in
    flight at either edge count for the steps they ran in the window; the
    sampler credits batch x seq_len a call."""
    rec = ctx.rec
    if rec.window_s <= 0:
        return None
    if rec.loop == "sampler":
        return rec.calls * rec.slots * rec.seq_len / rec.window_s
    lo, hi = rec.step_draws
    tokens = 0.0
    for q in rec.reqs.values():
        if q.first_step < 0:
            continue
        ran = min(hi, q.first_step + q.num_steps) - max(lo, q.first_step)
        if ran > 0:
            tokens += ran * q.seq_len / q.num_steps
    return tokens / rec.window_s


def mfu(ctx) -> Optional[float]:
    """Per cent of the window the chip would need at its published peaks
    for the useful work done in it: each active request's step at its own
    length, and the readout of each request completed."""
    rec, d = ctx.rec, ctx.d
    if rec.loop == "sampler":
        B, S, n = rec.slots, rec.seq_len, ctx.traffic["num_steps"]
        need = rec.calls * (n * B * counts.useful_s(d, S)
                            + B * counts.readout_s(d, S))
    else:
        need = sum(counts.useful_s(d, L)
                   for active in counts.occupancy(rec).values()
                   for L, _, _ in active)
        lo, hi = rec.step_draws
        need += sum(counts.readout_s(d, q.seq_len) for q in rec.reqs.values()
                    if q.first_step >= 0
                    and lo < q.first_step + q.num_steps <= hi)
    return 100.0 * need / rec.window_s if rec.window_s > 0 else None


def roofline(ctx, names, least_s: float) -> Optional[float]:
    """Per cent: the family's least seconds over its device seconds."""
    if ctx.trace is None:
        return None
    busy = ctx.trace.family_s(ctx.rec.t0_ns, ctx.rec.t1_ns, names)
    if not busy or least_s <= 0:
        return None
    return 100.0 * least_s / busy


def w4a8_roofline(ctx) -> Optional[float]:
    rec = ctx.rec
    least = denoise_steps(ctx) * counts.linears_step_s(
        ctx.d, rec.slots, rec.seq_len, ctx.fused_mlp)
    return roofline(ctx, W4A8_KERNELS, least)


def idle_share(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    t0, t1 = ctx.rec.t0_ns, ctx.rec.t1_ns
    busy = sum(b - a for a, b in ctx.trace.busy(t0, t1))
    return 100.0 * (1.0 - busy / (t1 - t0))
