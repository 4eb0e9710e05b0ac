"""The benchmark's harness on the CPU: traffic, the metrics' arithmetic,
the operation counts, the reference against the port's plain path, and
the refusals (no card, no JAX).

    python -m pytest bench_port/tests -q
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import counts, loops, model, readers, reference, system
from bench_port import run as bench_run
from bench_port import traffic as tr
from bench_port.loops import Record, Req

ROOT = Path(__file__).resolve().parents[2]


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_traffic_repeats_and_draws_the_mix():
    """One realization a stream, whatever the run's seed: lengths uniform
    over the multiples of the range, steps in their weights' proportions."""
    t = model.load_traffic("backlog-4x4096")
    a = _take(tr.requests(t, "measured"), 4000)
    assert a == _take(tr.requests(t, "measured"), 4000)
    assert a[:50] != _take(tr.requests(t, "warm"), 50)
    lens = [s.seq_len for s in a]
    assert all(L % 64 == 0 and 2048 <= L <= 4096 for L in lens)
    assert min(lens) == 2048 and max(lens) == 4096
    assert math.isclose(np.mean(lens), 3072, rel_tol=0.02)
    share = {n: sum(s.num_steps == n for s in a) / len(a)
             for n in (16, 32, 64)}
    for n, p in ((16, 0.25), (32, 0.5), (64, 0.25)):
        assert abs(share[n] - p) < 0.03, share


def test_arrivals_are_poisson_at_the_mix_rate():
    """Independent exponential gaps: the mean gap is 1 / rate, and the
    arrivals a second vary as a Poisson count does (variance = mean)."""
    t = model.load_traffic("open-16x256")
    a = tr.arrivals(t, "measured", 0.0, 600.0)
    assert a == tr.arrivals(t, "measured", 0.0, 600.0)
    assert a[:20] != tr.arrivals(t, "warm", 0.0, 600.0)[:20]
    assert all(0.0 < due < 600.0 for due, _ in a)
    gaps = np.diff([0.0] + [due for due, _ in a])
    rate = t["rate_per_s"]
    assert math.isclose(np.mean(gaps), 1.0 / rate, rel_tol=0.05)
    assert math.isclose(np.std(gaps), 1.0 / rate, rel_tol=0.1)
    counts = np.bincount([int(due) for due, _ in a], minlength=600)
    assert math.isclose(counts.var() / counts.mean(), 1.0, rel_tol=0.2)


def _window(loop="backlog", lo=10, hi=20, seconds=2.0):
    rec = Record(loop, seconds, slots=2, seq_len=64)
    rec.t0, rec.t1, rec.step_draws = 0.0, seconds, (lo, hi)
    rec.counters = {"batcher.steps": hi - lo}
    return rec


def _ctx(rec, **kw):
    from types import SimpleNamespace
    return SimpleNamespace(rec=rec, d=model.Dims.from_json(
        model.load_config("gpt2-small-w4a8")), traffic={}, trace=None,
        setup_s=1.0, peak_bytes=0, fused_mlp=True, **kw)


def test_rate_credits_in_flight_requests_by_their_steps_in_the_window():
    rec = _window()
    # steps 5..14 (5 in the window), 12..15 (all 4), 18..25 (2), 25.. (0)
    for rid, first, n, L in (("a", 5, 10, 64), ("b", 12, 4, 32),
                             ("c", 18, 8, 16), ("d", 25, 4, 64)):
        rec.reqs[rid] = Req(rid, L, n, first_step=first, wave=0)
    want = (5 * 64 / 10 + 4 * 32 / 4 + 2 * 16 / 8) / 2.0
    got = readers.load("gen_tokens_per_s").read(_ctx(rec))
    assert got == pytest.approx(want)
    # pad share: 20 slot positions a step of 64 over the window's 10 steps
    used = 5 * 64 + 4 * 32 + 2 * 16
    assert readers.load("pad_share").read(_ctx(rec)) == pytest.approx(
        100 * (1 - used / (10 * 2 * 64)))
    assert readers.load("denoise_step_ms").read(_ctx(rec)) == \
        pytest.approx(200.0)


def test_sampler_rate_credits_each_call():
    rec = Record("sampler", 2.0, slots=8, seq_len=1024)
    rec.t0, rec.t1, rec.calls = 0.0, 2.5, 3
    assert readers.load("gen_tokens_per_s").read(_ctx(rec)) == \
        pytest.approx(3 * 8 * 1024 / 2.5)


def test_p95_is_taken_over_every_request_due_in_the_window():
    rec = _window("open")
    for i in range(40):
        rec.reqs[f"m{i}"] = Req(f"m{i}", 64, 16, in_window=True,
                                latency_s=0.01 * (i + 1))
    # a warm-up request is not due in the window, however slow
    rec.reqs["w0"] = Req("w0", 64, 16, in_window=False, latency_s=99.0)
    got = readers.load("latency_p95_ms").read(_ctx(rec))
    assert got == pytest.approx(1e3 * 0.38)           # rank ceil(0.95 * 40)
    # one that never completed counts as missing the tail
    rec.reqs["m0"].latency_s = None
    rec.reqs["m1"].latency_s = None
    got = readers.load("latency_p95_ms").read(_ctx(rec))
    assert got == pytest.approx(1e3 * 0.40)
    rec.reqs["m2"].latency_s = None
    assert readers.load("latency_p95_ms").read(_ctx(rec)) == \
        pytest.approx(1e3 * (rec.seconds + loops.DRAIN_LIMIT_S))


def test_counts_match_hand_counts_at_gpt2_small_shapes():
    d = model.Dims.from_json(model.load_config("gpt2-small-w4a8"))
    M = 4 * 4096
    # qkv: int8 x [M, 768] @ [768, 2304], bf16 out
    ops = 2 * M * 768 * 2304
    nbytes = M * 768 + 768 * 2304 + 4 * M + 4 * 2304 + 2 * M * 2304
    assert counts.gemm_s(M, 768, 2304) == max(ops / 1979e12,
                                              nbytes / 3.35e12)
    assert ops / 1979e12 > nbytes / 3.35e12          # compute-bound
    # the fused MLP block with its residual
    ops = 2 * M * (768 * 3072 * 2)
    nbytes = M * 768 * 2 * 3 + 2 * 768 * 3072 + 4 * (2 * 3072 + 3 * 768)
    assert counts.mlp_s(M, 768, 3072, True) == max(ops / 1979e12,
                                                   nbytes / 3.35e12)
    # one layer of paged attention over one 4-bit bucket: two slots of
    # 4096 and 2050 keys (64 and 33 pages of 64), S = 4096 queries each
    pages = 64 + 33
    nbytes = (pages * (2 * 12 * 32 * 64 + 4 * 12 * 64 * 4)
              + 2 * 12 * 4096 * 64 * 2 + 4 * 12 * 4096 * (64 * 4 + 4))
    ops = 4 * 12 * 4096 * 64 * (4096 + 2050)
    assert counts.paged_s(d, 4096, 64, 4, [4096, 2050], 4) == \
        max(nbytes / 3.35e12, ops / 989e12)
    # a request's useful step: linears of 85M weights, attention over L keys
    L = 3072
    lin = 2 * L * (12 * (4 * 768 * 768 + 2 * 768 * 3072) + 768 * 768) \
        + 2 * 2 * 768 * 3072
    assert counts.useful_s(d, L) == pytest.approx(
        lin / 1979e12 + 4 * L * L * 768 * 12 / 989e12)
    assert counts.readout_s(d, L) == 2 * L * 768 * 50257 / 67e12
    # dense attention, B = 8 of 12 heads of 64, S = 1024
    assert counts.dense_attention_s(d, 8, 1024) == max(
        4 * 96 * 1024 * 64 * 2 / 3.35e12, 4 * 96 * 1024 ** 2 * 64 / 989e12)


def test_reference_quantizes_the_weights_as_the_port_does(tiny):
    d, _ = tiny
    w = model.make_weights(d, 5, "cpu")
    served = system.served_params(d, w)
    for path in (("blocks", 0, "attn", "wqkv"), ("blocks", 1, "mlp", "w2"),
                 ("time_mlp", "w1"), ("head", "w")):
        leaf, s = w, served
        for k in path:
            leaf, s = leaf[k], s[k]
        w8, cs = reference.w4a8_weight(leaf, d.weight_group)
        assert torch.equal(w8, s.data.to(torch.float32)), path
        assert torch.equal(cs, s.col_scale.reshape(-1)), path
    assert torch.equal(reference.token_table(w["tok_embed"]),
                       served["tok_embed"].dequantize())


def test_reference_eps_matches_the_port_plain_path(tiny):
    """The port's denoiser on the CPU runs its plain twins in bf16; the f32
    reference differs by the bf16 roundings and the int8 levels they flip
    (about 1%)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    d, _ = tiny
    w = model.make_weights(d, 5, "cpu")
    served = system.served_params(d, w)
    ref = reference.Reference(d, w, "cpu")
    x = torch.randn((2, 48, d.hidden), generator=torch.Generator()
                    .manual_seed(1))
    t = torch.tensor([3, 700])
    port = dn.denoiser_forward(served, system.config(d),
                               x.to(torch.bfloat16), t).float()
    mine = ref.eps(x, t)
    err = (port - mine).norm() / mine.norm()
    assert err < 2e-2, err


def test_phase_bits_follow_the_port_router():
    from diffusion_llm_rs_tpu_torch.serving import slot_phase_bits_np
    d = model.Dims.from_json(model.load_config("gpt2-small-w4a8"))
    cfg = system.config(d)
    for n in (16, 32, 64, 7):
        t = np.arange(n)
        want, _ = slot_phase_bits_np(cfg, t, np.full(n, n))
        assert [reference.phase_bits(d, int(i), n) for i in t] == \
            want.tolist()


def test_respaced_timesteps_follow_the_port():
    from diffusion_llm_rs_tpu_torch.models.diffusion import respaced_timesteps
    for n in (32, 7, 16, 1000):
        assert reference.respaced(1000, n) == respaced_timesteps(1000, n)


@pytest.mark.parametrize("loop", ["backlog", "open", "sampler"])
def test_a_run_on_the_plain_path_is_correct(tiny, loop):
    d, mixes = tiny
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wanted = bench["end_to_end"] + bench["per_layer"]
    out = bench_run.run(d, mixes[loop], "tiny", wanted, 2 ** 31 + 17, 2.0,
                        False, "cpu", limits={"served_logit_gap": 0.01,
                                              "drift_err": 0.02})
    res = out["result"]
    assert res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["served_logit_gap"]["value"] < 0.01
    if loop == "sampler":
        assert res["checks"]["drift_err"]["value"] < 0.02
    assert set(res["metrics"]) >= {"setup_s", "gen_tokens_per_s"}
    assert list(res)[-1] == "checks"


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "gpt2s-paged-4k", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_the_harness_and_the_reference_load_no_jax():
    code = ("import sys; import bench_port.run, bench_port.reference, "
            "bench_port.check, bench_port.system, bench_port.loops, "
            "bench_port.calibrate, bench_port.readers; "
            "[bench_port.readers.load(p.stem) for p in "
            "bench_port.readers.METRICS.glob('*.py')]; "
            "print(bench_port.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
