"""The comparison that decides `correct` has to fail: its control (the
reference one precision step below the configuration's bfloat16, put in
the program's place) and the program with its timed path broken.

At a tiny size on the CPU, with the harness's look for a card skipped.
On the card, at each cell's own size, the control's readings and the
fault's come from `python3 -m bench_port.calibrate` (the `cuda` test
below).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import faults, run as bench_run

ROOT = Path(__file__).resolve().parents[2]


def _run(d, traffic, limits, control=None):
    return bench_run.run(d, traffic, "tiny", [], 2 ** 31 + 101, 2.0, False,
                         "cpu", limits=limits, control=control)


def _values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.mark.parametrize("loop", ["backlog", "open", "sampler"])
def test_the_control_reads_at_or_above_the_program(tiny, loop):
    """At this size the logit gap reads only where a served token flips,
    which the control rarely makes here (at the cells' sizes it reads 8-14
    times the program's, `bench_port/limits/`); the sampler's drift error
    separates the two."""
    d, mixes = tiny
    out = _run(d, mixes[loop], {}, control="fp8")
    program = _values(out["result"])
    control = {k: c["value"] for k, c in out["info"]["control"].items()}
    assert control.keys() == program.keys()
    assert control["served_logit_gap"] >= program["served_logit_gap"]
    if loop == "sampler":
        assert control["drift_err"] > 3 * program["drift_err"], (program,
                                                                 control)


def test_the_control_is_judged_by_the_programs_test(tiny):
    """With limits between the program's readings and the control's, the
    program is correct and the control, put through the same test, is
    not."""
    d, mixes = tiny
    sound = _values(_run(d, mixes["sampler"], {})["result"])
    limits = {"served_logit_gap": 1e9, "drift_err": 2 * sound["drift_err"]}
    out = _run(d, mixes["sampler"], limits, control="fp8")
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["info"]["control_correct"] is False, out["info"]["control"]
    assert out["info"]["control"]["drift_err"]["limit"] == limits[
        "drift_err"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("loop", ["backlog", "open", "sampler"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, loop, fault):
    d, mixes = tiny
    sound = _values(_run(d, mixes[loop], {})["result"])
    limits = {k: 3 * max(v, 1e-6) for k, v in sound.items()}
    faults.FAULTS[fault](monkeypatch.setattr)
    res = _run(d, mixes[loop], limits)["result"]
    assert not res["correct"], res["checks"]
    assert any(v > 10 * max(sound[k], 1e-6)
               for k, v in _values(res).items()), (sound, res["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_the_control_and_a_state_left_unchanged_fail_at_the_cells_size(
        cell):
    """On the card, three seeds of the cell at its own size with every
    denoise step returning its input: neither that program nor the control
    (both judged against the cell's limits) comes out correct. Each
    reading is printed (`-s`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.calibrate", "--workload", cell,
         "--seeds", "901,902,903", "--seconds", "8",
         "--fault", "state_unchanged"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(lines) == 3
    for r in lines:
        print(cell, json.dumps(r))
        assert r["correct"] is False, (cell, r)
        assert r["control_correct"] is False, (cell, r)
