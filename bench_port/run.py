"""Run one cell of the port's benchmark once and print its result.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`: `workloads`)
names a configuration (`bench_port/configs/<config>.json`) and a traffic
mix (`bench_port/traffic/<traffic>.json`); the metrics it prints are the
readers `bench_port/metrics/<name>.py` of the metrics `BENCHMARK.json`
gives the cell: its end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`, when the device trace is recorded over the
window. The last line of standard output is the result, one JSON object;
an earlier line (`info`) gives the card, its power limit and SM clock, the
graph captures and kernel launches in the window, and in an open loop how
late the arrivals were submitted. The numbers compared with the reference
are the last lines of standard error, each beside its limit.

It measures the PyTorch and CUDA port, on the card only: without CUDA, or
with fewer cards than the cell asks for, it prints no result and exits
with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_llm_rs_tpu")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` prints: its end-to-end metrics, or with
    `trace` its per-layer ones (without a `workloads` key, a per-layer
    metric belongs to every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def card() -> dict:
    """The card's name, power limit and SM clock, as `nvidia-smi` reads
    them now."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,"
             "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"failed: {e}"}
    fields = [f.strip() for f in out.stdout.strip().split(",")]
    if out.returncode != 0 or len(fields) != 4:
        return {"nvidia_smi": out.stderr.strip() or out.stdout.strip()}
    return dict(zip(("name", "power_limit", "sm_clock", "sm_clock_max"),
                    fields))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _outcome(rec, vocab: int):
    """(attempted, failed): requests due in the window (open loop),
    requests that stepped in it (backlog), or calls (sampler); a request
    fails when it should have completed and did not, or served a token
    id outside the vocabulary."""
    if rec.loop == "sampler":
        bad = sum(int(t.min() < 0 or t.max() >= vocab)
                  for _, _, t in rec.outputs)
        return rec.calls, bad
    lo, hi = rec.step_draws
    if rec.loop == "open":
        seen = [q for q in rec.reqs.values() if q.in_window]
        due = seen
    else:
        seen = [q for q in rec.reqs.values() if q.first_step >= 0
                and q.first_step < hi and q.first_step + q.num_steps > lo]
        due = [q for q in seen if q.first_step + q.num_steps <= hi]
    failed = sum(1 for q in due if q.tokens is None
                 or q.tokens.min() < 0 or q.tokens.max() >= vocab)
    return len(seen), failed


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result object, with the `info` and
    the compared numbers beside it."""
    from bench_port import model
    d = model.Dims.from_json(model.load_config(cell["config"]))
    traffic = model.load_traffic(cell["traffic"])
    return run(d, traffic, cell["name"],
               cell_metrics(bench, cell["name"], trace), seed, seconds,
               trace, device, t_start)


def run(d, traffic: dict, name: str, wanted: list, seed: int,
        seconds: float, trace: bool, device="cuda",
        t_start: float = T_START, limits=None, control=None,
        keep=None) -> dict:
    """One run of model `d` under `traffic`, reading the metrics `wanted`
    and comparing with `limits` (default: the cell `name`'s). With
    `control` a precision, `info` also gives the control's readings on the
    same requests (`check.readings`) against the same limits, and
    `control_correct`, the control's verdict by the program's test. A
    dict `keep` gets the loop's record under "rec"."""
    from bench_port import check, loops, model, readers, system
    from bench_port.trace import Recorder

    cuda = torch.device(device).type == "cuda"
    cfg = system.config(d)
    marks = [time.perf_counter()]
    w = model.make_weights(d, seed, device)
    params = system.served_params(d, w)
    del w
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    # the batcher's own rule for "auto" (`PagedContinuousBatcher`), read
    # here to build only the kernels the cell launches
    mode = traffic.get("attend_mode", "")
    if mode == "auto":
        mode = "paged" if traffic["seq_len"] >= 2048 else "dense"
    if cuda:
        system.build(system.kernels(d, traffic, mode))
        torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    rec = loops.LOOPS[traffic["loop"]](cfg, params, traffic, seed, seconds,
                                      device, Recorder(trace))
    setup_s = rec.t0 - t_start
    if keep is not None:
        keep["rec"] = rec
    peak = rec.peak_bytes
    info = {"card": card() if cuda else {"device": str(device)},
            "graphs_in_window": {k.split(".")[1]: v
                                 for k, v in rec.counters.items()
                                 if k.startswith("graphs.")},
            "launches_in_window": {k: v for k, v in rec.launches.items()
                                   if v},
            "window_s": rec.window_s, "steps": readers.steps_of(rec, traffic),
            "host_calls": _host_calls(rec),
            "warm_up_calls": rec.warm_calls,
            "setup_parts_s": {"start": marks[0] - t_start,
                              "weights": marks[1] - marks[0],
                              "build": marks[2] - marks[1],
                              "warm_up": rec.t0 - marks[2]}}
    if rec.lateness_s:
        info["arrivals_late_ms"] = {
            "p50": 1e3 * readers.percentile(rec.lateness_s, 50),
            "p95": 1e3 * readers.percentile(rec.lateness_s, 95),
            "max": 1e3 * max(rec.lateness_s)}
    attempted, failed = _outcome(rec, d.vocab)
    ctx = SimpleNamespace(rec=rec, d=d, traffic=traffic,
                          trace=rec.recorder.trace, setup_s=setup_s,
                          peak_bytes=peak,
                          fused_mlp="int8_mlp" in system.kernels(
                              d, traffic, mode))
    metrics = {}
    for m in wanted:
        value = readers.load(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = _breakdown(rec) if trace else None
    # the program's state goes before the reference runs
    del params, ctx
    rec.recorder = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    read = check.readings(rec, d, traffic, seed, device, control=control)
    info["reference_s"] = time.perf_counter() - t_ref
    info["compared_tokens"] = read.pop("compared_tokens")
    limits = check.limits(name) if limits is None else limits
    if control:
        # the control in the program's place, judged as the program is
        info["control"] = {k: {"value": v, "limit": limits.get(k)}
                           for k, v in read.pop("control").items()}
        info["control_correct"] = _within(info["control"])
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in read.items()}
    result = {"correct": bool(_within(checks) and failed == 0
                              and attempted > 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else str(device),
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else str(device)),
                         "count": 1, "memory_peak_bytes": peak}}
    if breakdown is not None:
        result["device"].update(busy_s=breakdown.pop("busy_s"),
                                window_s=rec.window_s)
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "info": info}


def _within(checks: dict) -> bool:
    """Every compared number is read and at or under its limit."""
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def _host_calls(rec) -> dict:
    """The harness's calls into the program in the window: how many, and
    their host seconds in all and at most."""
    inside = [(b - a) / 1e9 for _, a, b in rec.spans
              if a >= rec.t0_ns and b <= rec.t1_ns]
    return {"n": len(inside), "s": sum(inside),
            "max_s": max(inside, default=0.0)}


def _breakdown(rec) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps by what the host was doing (the harness's span
    around the gap's start)."""
    tr = rec.recorder.trace
    t0, t1 = rec.t0_ns, rec.t1_ns
    by_name: dict = {}
    for n, a, b in tr.within(t0, t1):
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a) / 1e9
    busy = tr.busy(t0, t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted(rec.spans, key=lambda s: s[1])

    def doing(at):
        for name, a, b in spans:
            if a <= at < b:
                return name
        return "harness"
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[f"{doing(a)} at +{(a - t0) / 1e6:.1f} ms",
                           (b - a) / 1e9] for a, b in gaps[:10]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
