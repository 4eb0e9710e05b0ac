"""Readings for the limits of `correct`: one cell run on many seeds in one
process, each run's compared numbers beside the control's on the same
requests and noise, both judged against the cell's limits.

    python3 -m bench_port.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control fp8] [--fault state_unchanged]

The control is the reference put in the program's place at the precision
one step below the configuration's bfloat16 activations (`fp8`: float8
e4m3 with a per-row scale). With `--fault`, the program runs with that
fault planted under its timed path (`faults.py`). Each seed prints one
JSON line, with `correct` (the program's verdict) and `control_correct`
(the control's, by the same test); the benchmark's own runs never run
this. A limit is set between the largest reading of the sound program and
the smallest of the control (`limits/<cell>.json`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bench_port import faults, model
from bench_port.run import benchmark, forbidden_modules, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", default="fp8")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = {c["name"]: c for c in benchmark()["workloads"]}[args.workload]
    d = model.Dims.from_json(model.load_config(cell["config"]))
    traffic = model.load_traffic(cell["traffic"])
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run(d, traffic, cell["name"], [], seed, args.seconds, False,
                  "cuda", t0, control=args.control)
        info = out["info"]
        print(json.dumps({
            "seed": seed, "fault": args.fault,
            "program": out["result"]["checks"],
            "correct": out["result"]["correct"],
            "control": info["control"],
            "control_correct": info["control_correct"],
            "attempted": out["result"]["attempted"],
            "failed": out["result"]["failed"],
            "compared_tokens": info["compared_tokens"],
            "reference_s": info["reference_s"],
            "graphs_in_window": info["graphs_in_window"]}), flush=True)
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
