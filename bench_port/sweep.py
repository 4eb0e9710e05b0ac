"""The sweep that fixes an open-loop cell's rate: the cell's traffic at
each of a list of rates, one run each in one process.

    python3 -m bench_port.sweep --workload <cell> --rates 8,10,12 \
        --seconds 30 --seed <n>

For each rate it prints one JSON line: requests due and completed, the
latency's median and 95th percentile, and the queue wait's 95th percentile
over the first and the second half of the arrivals, and the requests
still waiting for a slot when the window closes. Where the queue grows,
the second half waits far longer than the first and the waiting count
rises with the rate. The last line gives the capacity: the tokens a
second completed at the highest rate, which should be one where the queue
grows, over the mix's mean request length, in requests a second, and four
fifths of it, the rate the cell runs at, written into its traffic file as
a number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bench_port import model
from bench_port.readers import percentile
from bench_port.run import benchmark, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = {c["name"]: c for c in benchmark()["workloads"]}[args.workload]
    d = model.Dims.from_json(model.load_config(cell["config"]))
    base = model.load_traffic(cell["traffic"])
    wanted = [{"name": n, "unit": u} for n, u in (
        ("latency_p95_ms", "ms"), ("queue_wait_p95_ms", "ms"),
        ("denoise_step_ms", "ms"), ("gen_tokens_per_s", "tokens/s"))]
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(base, rate_per_s=rate)
        holder = {}
        out = run(d, traffic, cell["name"], wanted, args.seed, args.seconds,
                  False, "cuda", time.perf_counter(), limits={},
                  keep=holder)
        rec = holder["rec"]
        due = sorted((q for q in rec.reqs.values() if q.in_window),
                     key=lambda q: q.due_wall)
        done = [q for q in due if q.latency_s is not None]
        half = len(due) // 2
        close = rec.t1_ns / 1e9
        waiting = sum(1 for q in due if q.due_wall <= close and
                      not (0 < q.admitted_wall <= close))

        def wait95(qs):
            w = [q.admitted_wall - q.due_wall for q in qs if q.wave >= 0]
            return 1e3 * percentile(w, 95) if w else None
        print(json.dumps({
            "rate_per_s": rate, "due": len(due), "completed": len(done),
            "latency_p50_ms": 1e3 * percentile(
                [q.latency_s for q in done], 50) if done else None,
            "metrics": {k: v["value"]
                        for k, v in out["result"]["metrics"].items()},
            "queue_wait_p95_ms_first_half": wait95(due[:half]),
            "queue_wait_p95_ms_second_half": wait95(due[half:]),
            "waiting_at_close": waiting,
            "arrivals_late_ms": out["info"].get("arrivals_late_ms")}),
            flush=True)
    lo, hi, mult = base["request_len"]
    lengths = range(lo, hi + 1, mult)
    cap = out["result"]["metrics"]["gen_tokens_per_s"]["value"] / (
        sum(lengths) / len(lengths))
    print(json.dumps({"capacity_req_s": cap, "at_rate_per_s": rate,
                      "rate_per_s": round(0.8 * cap, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
