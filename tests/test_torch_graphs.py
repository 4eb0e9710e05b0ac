"""The port's replayed CUDA graphs (`utils/graphs.py`), the counterpart of
JAX's compiled sampling and serving programs.

On the CPU nothing is captured, so the CPU tests drive the replay machinery
with stand-in graph objects: `CpuGraph` replays a captured step by running
it again (a functional stand-in: the batcher's keys, warm-ups, pointer
checks and recaptures run as on the card), `CountingGraph` runs the step at
capture and nothing at replay (the launch-count bookkeeping). The paged
batcher through that machinery still matches JAX's batcher from JAX's draws
(`JaxNoise`, from `test_torch_serving.py`; JAX is imported inside the
tests only).

The `cuda` tests hold each replayed path on the card against the same path
under `graphs.disabled()`, bit for bit, with equal launch counts. They
import no JAX, so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_graphs.py -m cuda
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch import serving as tsv
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.models import diffusion as td
from diffusion_llm_rs_tpu_torch.models import sampler as tsp
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.utils import graphs
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics


class CpuGraph:
    """Stands in for a CUDA graph on the CPU: the replay runs the captured
    step eagerly, so results are the eager ones."""

    pool = staticmethod(lambda: None)

    def capture(self, fn, pool):
        self.fn = fn

    def replay(self):
        self.fn()


class CountingGraph:
    """Runs the step at capture (its launches are taken out again) and
    launches nothing at replay."""

    pool = staticmethod(lambda: None)

    def capture(self, fn, pool):
        fn()

    def replay(self):
        pass


@pytest.fixture
def cpu_replay(monkeypatch):
    """Every GraphCache made inside captures on the CPU with `CpuGraph`."""
    monkeypatch.setattr(graphs.GraphCache, "graph_type", CpuGraph)
    monkeypatch.setattr(graphs.GraphCache, "capturing",
                        lambda self: self.capture and not graphs.is_disabled())
    yield
    graphs._owned.clear()


def _counters():
    return {k: metrics.get(f"graphs.{k}")
            for k in ("captures", "recaptures", "replays")}


def _delta(before):
    return {k: v - before[k] for k, v in _counters().items()}


def _tiny(**kw):
    cfg = tcfg_mod.DiffusionConfig.tiny(**kw)
    params = tdn.init_denoiser_params(torch.Generator().manual_seed(0), cfg)
    return cfg, params


# ------------------------------------------------------------ CPU tests ---


def test_disabled_nests_and_the_cpu_never_captures():
    """`disabled()` nests; a CPU cache runs every step eagerly and captures
    nothing, with or without it; a card cache captures unless disabled."""
    cpu, card = graphs.GraphCache("t", "cpu"), graphs.GraphCache("t", "cuda")
    off = graphs.GraphCache("t", "cuda", capture=False)
    assert not cpu.capturing() and card.capturing() and not off.capturing()
    with graphs.disabled():
        assert graphs.is_disabled() and not card.capturing()
        with graphs.disabled():
            assert not card.capturing()
        assert graphs.is_disabled() and not card.capturing()
    assert not graphs.is_disabled() and card.capturing()
    calls, before = [], _counters()
    for _ in range(4):
        cpu.run("k", lambda: calls.append(1))
    with graphs.disabled():
        card.run("k", lambda: calls.append(1))   # eager: no CUDA call made
    assert len(calls) == 5 and not cpu._entries and not card._entries
    assert _delta(before) == {"captures": 0, "recaptures": 0, "replays": 0}


def test_launch_counts_count_replays_not_captures(monkeypatch):
    """A capture adds nothing to `launch_counts`; each replay adds the
    counts recorded at capture; a warm-up step counts as it runs. Steps of
    two kernels: 1 warm-up, 1 capture + replay, 3 replays = 5 of each."""
    monkeypatch.setattr(graphs.GraphCache, "graph_type", CountingGraph)
    cache = graphs.GraphCache("t", "cuda")

    def step():
        _build.launch_counts["k1"] += 1
        _build.launch_counts["k2"] += 2

    _build.reset_launch_counts()
    _build.launch_counts["before"] = 7
    before = _counters()
    for _ in range(5):
        cache.run("step", step)
    assert dict(_build.launch_counts) == {"before": 7, "k1": 5, "k2": 10}
    assert _delta(before) == {"captures": 1, "recaptures": 0, "replays": 4}
    # a capture that raises leaves the counts as they were
    with pytest.raises(RuntimeError, match="disabled"):
        cache.run("other", step)   # warm-up
        cache.run("other", lambda: (step(), 1 / 0))
    assert dict(_build.launch_counts) == {"before": 7, "k1": 6, "k2": 12}
    with _build.recording_launches() as rec:
        step()
    assert rec == {"k1": 1, "k2": 2}
    assert dict(_build.launch_counts) == {"before": 7, "k1": 6, "k2": 12}
    _build.reset_launch_counts()


def test_moved_pointers_recapture_the_key(monkeypatch):
    """A replay whose held pointers differ from the recorded ones captures
    the key again (no warm-up) and never replays the stale graph."""
    monkeypatch.setattr(graphs.GraphCache, "graph_type", CpuGraph)
    monkeypatch.setattr(graphs.GraphCache, "capturing", lambda self: True)
    cache = graphs.GraphCache("t", "cpu")
    a, b = torch.zeros(3), torch.zeros(3)
    seen = []
    before = _counters()
    for target in (a, a, a, b, b, a):
        cache.run("k", lambda target=target: seen.append(target),
                  graphs.pointers(target))
    # warm-up (a), capture (a), replay (a), recapture (b), replay, recapture
    assert [t is a for t in seen] == [True] * 3 + [False] * 2 + [True]
    assert _delta(before) == {"captures": 3, "recaptures": 2, "replays": 5}


def test_tree_helpers():
    """`tensors`, `pointers`, `clone` and `copy_into` over dicts, lists and
    dataclasses (a QuantKV pair, a schedule)."""
    from diffusion_llm_rs_tpu_torch.ops.attention import quantize_kv
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    pair = (quantize_kv(x, 4), quantize_kv(x * 2, 4))
    assert len(graphs.tensors(pair)) == 6
    twin = graphs.clone(pair)
    assert {p.data_ptr() for p in graphs.tensors(twin)}.isdisjoint(
        p.data_ptr() for p in graphs.tensors(pair))
    graphs.copy_into(twin, (quantize_kv(x * 3, 4), quantize_kv(x, 4)))
    assert torch.equal(twin[1].data, pair[0].data)
    assert twin[0].bits == 4 and twin[0].D == 64
    sched = td.DiffusionSchedule.create(50, device="cpu")
    assert len(graphs.pointers({"s": sched, "l": [x, None]})) == 8
    # a tensor of another shape, or a field of another value, at the same
    # address is not the recorded one
    assert graphs.pointers(x) != graphs.pointers(x.view(16, 64))
    assert graphs.pointers(pair) != graphs.pointers(
        tuple(dataclasses.replace(q, bits=2) for q in pair))
    with pytest.raises(ValueError):
        graphs.copy_into(twin, pair[0])


def test_paged_batcher_replayed_matches_jax(cpu_replay):
    """The paged batcher through the replay machinery (steps of 8-step
    chunks replayed, the noise drawn in the eager order before each
    replay) against JAX's batcher stepping one at a time from the same
    draws: salience routing over 4-bit pages, three requests over two
    slots (the third admitted mid-run), a chunk of 8 among them. The same
    bound as the drained-run parity test (1e-4; both near 1e-6)."""
    from test_torch_serving import _batchers, _drain
    jkw = dict(num_slots=2, seq_len=8, page_size=4, attend_mode="paged",
               salience_routing=True)
    jb, tb = _batchers(11, dict(jkw, max_chunk=1), dict(jkw, max_chunk=8))
    chunks = []
    pick = tb._chunk_steps
    tb._chunk_steps = lambda m: chunks.append(pick(m)) or chunks[-1]
    before = _counters()
    jdone, tdone = _drain(jb, tsv), _drain(tb, tsv)
    moved = _delta(before)
    assert 8 in chunks and moved["replays"] > 0 and moved["captures"] > 0
    assert sorted(jdone) == sorted(tdone) == ["a", "b", "c"]
    worst = max(np.abs(tdone[r].embeddings - jdone[r].embeddings).max()
                for r in jdone)
    print(f"replayed paged batcher vs JAX (chunks {chunks}, {moved}): "
          f"embeddings max abs {worst:.3g}")
    for rid in jdone:
        np.testing.assert_allclose(tdone[rid].embeddings,
                                   jdone[rid].embeddings, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tdone[rid].tokens, jdone[rid].tokens)
    np.testing.assert_allclose(tb.page_scores, np.asarray(jb.page_scores),
                               rtol=1e-4, atol=1e-6)


def _paged_run(cfg, params, budget=None, **kw):
    b = tsv.PagedContinuousBatcher(
        params, cfg, num_slots=2, seq_len=8, page_size=4, seed=3,
        attend_mode="paged", hbm_budget_bytes=budget, max_chunk=4,
        device="cpu", sanitize=True, **kw)
    b.submit(tsv.Request("a", seq_len=8, num_steps=30))
    b.submit(tsv.Request("b", seq_len=4, num_steps=9))
    return b, {c.request_id: c for c in b.run_until_drained()}


def test_spill_and_restore_move_pointers_and_recapture(cpu_replay,
                                                       monkeypatch):
    """Under a budget of about one pool a restored bucket has new storage:
    its pointers differ from those at its spill, so the keys that read it
    are captured again (never replayed stale), and the run stays bit-equal
    to the unbudgeted one and to the eager one."""
    cfg, params = _tiny()
    b_free, free = _paged_run(cfg, params)
    one_pool = b_free.cache_memory_bytes() // len(b_free.buckets)
    spilled, moves = {}, []
    spill = tsv.PagedContinuousBatcher._spill_bucket
    restore = tsv.PagedContinuousBatcher._restore_bucket

    def tracked_spill(self, bits):
        spilled[bits] = graphs.pointers(self.pools[bits])
        spill(self, bits)

    def tracked_restore(self, bits):
        restore(self, bits)
        if bits in spilled:
            moves.append(spilled.pop(bits) != graphs.pointers(
                self.pools[bits]))
    monkeypatch.setattr(tsv.PagedContinuousBatcher, "_spill_bucket",
                        tracked_spill)
    monkeypatch.setattr(tsv.PagedContinuousBatcher, "_restore_bucket",
                        tracked_restore)
    before = _counters()
    _, tight = _paged_run(cfg, params, one_pool + 1)
    moved = _delta(before)
    with graphs.disabled():
        _, eager = _paged_run(cfg, params, one_pool + 1)
    assert moves and all(moves)
    assert moved["recaptures"] > 0 and moved["replays"] > 0
    for rid in ("a", "b"):
        np.testing.assert_array_equal(tight[rid].embeddings,
                                      free[rid].embeddings)
        np.testing.assert_array_equal(tight[rid].embeddings,
                                      eager[rid].embeddings)


def test_static_state_is_never_handed_out(cpu_replay):
    """Results, callback arguments and kept embeddings are copies: a later
    replay writing the static buffers in place changes none of them."""
    cfg, params = _tiny()
    sched = td.DiffusionSchedule.create(cfg.num_timesteps, device="cpu")

    def model_fn(x, t):
        return tdn.denoiser_forward(params, cfg, x, t)

    seen = []
    shape = (2, 8, cfg.hidden_size)
    gen = torch.Generator().manual_seed(5)
    x1 = td.sample(model_fn, sched, shape, gen, num_steps=4,
                   callback=lambda t, x: seen.append(x))
    keep = (x1.clone(), [s.clone() for s in seen])
    td.sample(model_fn, sched, shape, gen, num_steps=4)
    assert torch.equal(x1, keep[0]) and len(seen) == 4
    assert all(torch.equal(a, b) for a, b in zip(seen, keep[1]))
    assert torch.equal(seen[-1], x1)
    b = tsv.PagedContinuousBatcher(params, cfg, num_slots=2, seq_len=8,
                                   page_size=4, seed=3, max_chunk=4,
                                   device="cpu")
    at_retire = _retire_snapshots(b)
    for rid, n, steps in (("a", 8, 9), ("b", 8, 4), ("c", 8, 6)):
        b.submit(tsv.Request(rid, n, steps))
    done = {c.request_id: c for c in b.run_until_drained()}
    assert sorted(at_retire) == ["a", "b", "c"]
    for rid, x in at_retire.items():   # "c" reused "b"'s slot
        np.testing.assert_array_equal(done[rid].embeddings, x)


def _retire_snapshots(b):
    """Record each retiring request's rows of x as `_retire` sees them."""
    at_retire = {}
    retire = b._retire

    def snap(finished):
        for slot in np.nonzero(finished)[0]:
            req = b.slot_request[slot]
            at_retire[req.request_id] = b.x[slot, :req.seq_len].cpu(
            ).numpy().copy()
        retire(finished)
    b._retire = snap
    return at_retire


@pytest.mark.parametrize("branch", ["no_cache", "packed", "dequantized"])
def test_phase_aware_sample_replayed_equals_eager(cpu_replay, branch):
    """Each branch of `phase_aware_sample` through the replay machinery (a
    graph a branch and bit-width, the carry a static buffer written in
    place) equals the eager run bit for bit, on a second call too."""
    cfg, params = _tiny(hidden_size=128, num_attention_heads=2,
                        max_sequence_length=16)
    sched = td.DiffusionSchedule.create(cfg.num_timesteps, device="cpu")
    kw = dict(use_cache=branch != "no_cache",
              kernel_cache=branch == "packed")

    def run(seed):
        return tsp.phase_aware_sample(
            params, cfg, sched, (2, 16), torch.Generator().manual_seed(seed),
            8, **kw)

    before = _counters()
    got = [run(1), run(2)]
    moved = _delta(before)
    with graphs.disabled():
        want = [run(1), run(2)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert moved["replays"] > 0 and moved["captures"] > 0


def test_continuous_batcher_replayed_equals_eager(cpu_replay):
    """The dense batcher's step through the replay machinery (t, the active
    mask and the noise copied into static buffers) equals its eager run."""
    cfg, params = _tiny()

    def run():
        b = tsv.ContinuousBatcher(params, cfg, num_slots=2, seq_len=8,
                                  seed=4, device="cpu")
        for rid, n, steps in (("a", 8, 6), ("b", 4, 3), ("c", 8, 4)):
            b.submit(tsv.Request(rid, n, steps))
        return {c.request_id: c for c in b.run_until_drained()}

    before = _counters()
    got = run()
    assert _delta(before)["replays"] > 0
    with graphs.disabled():
        want = run()
    for rid in ("a", "b", "c"):
        np.testing.assert_array_equal(got[rid].embeddings,
                                      want[rid].embeddings)
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)


def test_engine_lru_frees_an_evicted_batchers_graphs(cpu_replay, tmp_path):
    """`Engine.sample` reaches the replayed chunk through its LRU of
    batchers; a batcher it evicts takes its graphs and static buffers with
    it (nothing else holds the cache)."""
    import gc
    import weakref
    from diffusion_llm_rs_tpu_torch.config import SystemConfig
    from diffusion_llm_rs_tpu_torch.engine import Engine
    eng = Engine(config=tcfg_mod.DiffusionConfig.tiny(vocab_size=512),
                 system_config=SystemConfig(ssd_path=str(tmp_path / "s.bin")),
                 device="cpu")
    before = _counters()
    eng.sample(batch_size=2, seq_len=8, num_steps=6, return_text=False)
    first = next(iter(eng._samplers.values()))
    cache = weakref.ref(first._graphs)
    assert first._graphs._entries and _delta(before)["replays"] > 0
    del first
    for batch in (1, 3, 4, 5):
        eng.sample(batch_size=batch, seq_len=8, num_steps=2,
                   return_text=False)
    gc.collect()
    assert len(eng._samplers) == eng._samplers_cap and cache() is None


class _StubDeviceMesh:
    """A `DeviceMesh` of one process whose groups are stand-ins (no
    collective is run)."""

    def get_group(self, axis):
        return f"{axis} group"

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("backend,captures", [("gloo", False),
                                              ("nccl", True)])
def test_sharded_batcher_keeps_its_chunk_eager(cpu_replay, monkeypatch,
                                               backend, captures):
    """The sharded batcher captures its chunk's step only when the 'model'
    group its collectives run over is NCCL's: a gloo mesh keeps it eager.
    Decided once, in `__init__`, from `dist.get_backend`. With no process
    group there is no collective, and the step is captured. (On the CPU
    `cpu_replay` stands in for the card.)"""
    import torch.distributed as dist
    from diffusion_llm_rs_tpu_torch.parallel import serving as psv
    from diffusion_llm_rs_tpu_torch.parallel.mesh import Mesh
    asked = []
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: asked.append(group) or backend)
    cfg, params = _tiny(vocab_size=64)
    mesh = Mesh(("data", "model"), (1, 1), torch.device("cpu"),
                _StubDeviceMesh())
    b = psv.ShardedPagedBatcher(params, cfg, mesh, num_slots=2, seq_len=8,
                                page_size=8, attend_mode="paged")
    assert asked == ["model group"]
    assert b.capture_steps is captures and b._graphs.capture is captures
    assert b._graphs.capturing() is captures
    assert tsv.PagedContinuousBatcher.capture_steps
    assert psv.nccl_only([None]) and psv.nccl_only([])


# ----------------------------------------------------------- card tests ---


@pytest.fixture(scope="module")
def card():
    """A W4A8-decoded model of 2 layers, width 256, 4 heads of 64, vocab
    512, bf16 activations (the full-width model's recipe in
    `chip_smoke.py`, narrowed), random weights from a seed; every kernel
    built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
    from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                       quantize_tree)
    _build.build()
    cfg = tcfg_mod.DiffusionConfig(
        num_timesteps=1000, hidden_size=256, num_layers=2,
        num_attention_heads=4, vocab_size=512, max_sequence_length=1024,
        dtype="bfloat16")
    params = quantize_tree(tdn.init_denoiser_params(
        torch.Generator(device="cuda").manual_seed(0), cfg), 4,
        symmetric=True, granularity="group", group_size=128, axis=0)

    def prep(t):
        if isinstance(t, dict):
            return {k: prep(v) for k, v in t.items()}
        if isinstance(t, list):
            return [prep(v) for v in t]
        if isinstance(t, QuantizedTensor) and t.ndim == 2:
            try:
                return decode_to_int8(prepare(t, act_bits=8))
            except ValueError:
                return t
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t
    return cfg, prep(params)


def _both(run):
    """`run()` under `graphs.disabled()`, then replayed: [(result, launch
    counts, replays)] for each, launch counts from 0."""
    out = []
    for ctx in (graphs.disabled, contextlib.nullcontext):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        r0 = metrics.get("graphs.replays")
        with ctx():
            res = run()
        torch.cuda.synchronize()
        out.append((res, dict(_build.launch_counts),
                    metrics.get("graphs.replays") - r0))
    (_, c_eager, r_eager), (_, c_replayed, r_replayed) = out
    assert r_eager == 0 and r_replayed > 0
    assert c_eager == c_replayed and sum(c_eager.values()) > 0
    return out[0][0], out[1][0]


def _bf16_model_fn(cfg, params, log=None):
    def model_fn(x, t):
        eps = tdn.denoiser_forward(params, cfg, x.to(torch.bfloat16), t)
        if log is not None:
            log.append(eps.float().cpu())
        return eps.to(torch.float32)
    return model_fn


@pytest.mark.cuda
@pytest.mark.parametrize("with_callback", [False, True])
def test_card_sample_replays_bit_for_bit(card, with_callback):
    cfg, params = card
    sched = td.DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    model_fn = _bf16_model_fn(cfg, params)

    def run():
        seen = []
        x = td.sample(model_fn, sched, (4, 256, cfg.hidden_size),
                      torch.Generator(device="cuda").manual_seed(3),
                      num_steps=6,
                      callback=((lambda t, x: seen.append((t, x)))
                                if with_callback else None))
        return x, seen

    (x_e, seen_e), (x_r, seen_r) = _both(run)
    assert torch.equal(x_e, x_r) and len(seen_r) == 6 * with_callback
    for (ta, a), (tb, b) in zip(seen_e, seen_r):
        assert ta == tb and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["no_cache", "packed", "dequantized"])
def test_card_phase_aware_sample_replays_bit_for_bit(card, branch):
    """Every branch of the scan sampler over the 8 -> 4 -> 2 schedule (10
    steps cross both boundaries), replayed against eager."""
    cfg, params = card
    sched = td.DiffusionSchedule.create(cfg.num_timesteps, device="cuda")

    def fwd(params, cfg, x, t, **kw):
        out = tdn.denoiser_forward(params, cfg, x.to(torch.bfloat16), t, **kw)
        eps, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        return (eps.float(),) + tuple(rest) if rest else eps.float()

    def run():
        return tsp.phase_aware_sample(
            params, cfg, sched, (4, 256), tsv.GeneratorNoise(9, "cuda"), 10,
            use_cache=branch != "no_cache", kernel_cache=branch == "packed",
            forward_fn=fwd)

    eager, replayed = _both(run)
    assert torch.equal(eager, replayed)


def _serve_both(make, requests):
    """Drain `requests` [(id, seq_len, steps)] through `make()` eagerly,
    then replayed: completions, scores and resident pools bit for bit."""
    runs = []

    def run():
        b = make()
        for rid, n, steps in requests:
            b.submit(tsv.Request(rid, n, steps))
        b.done = {c.request_id: c for c in b.run_until_drained()}
        runs.append(b)
        done = b.done
        return done, b.page_scores.copy() if hasattr(b, "page_scores") \
            else None

    (d_e, s_e), (d_r, s_r) = _both(run)
    assert sorted(d_e) == sorted(d_r) == sorted(r[0] for r in requests)
    for rid in d_e:
        np.testing.assert_array_equal(d_e[rid].tokens, d_r[rid].tokens)
        if d_e[rid].embeddings is not None:
            np.testing.assert_array_equal(d_e[rid].embeddings,
                                          d_r[rid].embeddings)
    if s_e is not None:
        np.testing.assert_array_equal(s_e, s_r)
    b_e, b_r = runs
    assert torch.equal(b_e.x, b_r.x)
    for bits, pool in getattr(b_e, "pools", {}).items():
        for name, arr in pool.items():
            assert torch.equal(arr, b_r.pools[bits][name]), (bits, name)
    return b_e, b_r


@pytest.mark.cuda
def test_card_continuous_batcher_replays_bit_for_bit(card):
    cfg, params = card
    _serve_both(lambda: tsv.ContinuousBatcher(
        params, cfg, num_slots=4, seq_len=256, seed=5),
        [("a", 256, 6), ("b", 100, 3), ("c", 256, 5), ("d", 64, 4),
         ("e", 256, 4)])


PAGED_MODES = {
    "paged": dict(attend_mode="paged"),
    "dense": dict(attend_mode="dense"),
    "a8": dict(attend_mode="paged", attn_act_bits=8),
    "salience": dict(attend_mode="paged", salience_routing=True),
    "phase": dict(attend_mode="paged", max_chunk=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(PAGED_MODES))
def test_card_paged_batcher_replays_bit_for_bit(card, mode):
    """Mixed lengths and step counts over 2 slots (admissions mid-run,
    chunks of 8 down to 1, the phase schedule's three buckets)."""
    cfg, params = card
    _serve_both(lambda: tsv.PagedContinuousBatcher(
        params, cfg, num_slots=2, seq_len=512, page_size=64, seed=7,
        **PAGED_MODES[mode]),
        [("a", 512, 20), ("b", 300, 9), ("c", 512, 12)])


@pytest.mark.cuda
@pytest.mark.parametrize("salience", [False, True])
def test_card_sharded_batcher_replays_over_nccl(card, tmp_path, salience):
    """`ShardedPagedBatcher` on a (1, 1) mesh over an NCCL group of one
    captures its chunk's step (the TP forward's all-reduces and, with
    salience routing, the scores') and replays it bit for bit against its
    eager run, with equal launch counts; its tokens are the single
    `PagedContinuousBatcher`'s."""
    import torch.distributed as dist
    from diffusion_llm_rs_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh)
    from diffusion_llm_rs_tpu_torch.parallel.serving import (
        ShardedPagedBatcher)
    cfg, params = card
    kw = dict(num_slots=2, seq_len=512, page_size=64, seed=11,
              attend_mode="paged", salience_routing=salience)
    reqs = [("a", 512, 12), ("b", 300, 5), ("c", 512, 9)]
    initialize_distributed("nccl", f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mesh = make_mesh((1, 1))
        assert dist.get_backend(mesh.group("model")) == "nccl"
        _, b_r = _serve_both(
            lambda: ShardedPagedBatcher(params, cfg, mesh, **kw), reqs)
        assert b_r._graphs.capture
    finally:
        dist.destroy_process_group()
    single = tsv.PagedContinuousBatcher(params, cfg, **kw)
    for rid, n, steps in reqs:
        single.submit(tsv.Request(rid, n, steps))
    want = {c.request_id: c.tokens for c in single.run_until_drained()}
    for rid, tokens in want.items():
        np.testing.assert_array_equal(b_r.done[rid].tokens, tokens)


@pytest.mark.cuda
def test_card_spill_and_restore_recapture(card, monkeypatch):
    """A budget of about one pool spills and restores buckets mid-run; each
    restore is made to land on new storage (the freed storage is held
    while a bucket is out), so the keys that read it are captured again.
    Replayed equals eager bit for bit."""
    cfg, params = card
    held = {}
    spill = tsv.PagedContinuousBatcher._spill_bucket
    restore = tsv.PagedContinuousBatcher._restore_bucket

    def spill_holding(self, bits):
        held[(id(self), bits)] = graphs.tensors(self.pools[bits])
        spill(self, bits)

    def restore_elsewhere(self, bits):
        restore(self, bits)
        held.pop((id(self), bits), None)

    monkeypatch.setattr(tsv.PagedContinuousBatcher, "_spill_bucket",
                        spill_holding)
    monkeypatch.setattr(tsv.PagedContinuousBatcher, "_restore_bucket",
                        restore_elsewhere)

    def make():
        b = tsv.PagedContinuousBatcher(params, cfg, num_slots=2, seq_len=512,
                                       page_size=64, seed=8,
                                       attend_mode="paged", max_chunk=4)
        b.hbm_budget = b.cache_memory_bytes() // len(b.buckets) + 1
        b.memory = tsv.MemoryManager(device=b.device)
        return b

    r0, s0 = metrics.get("graphs.recaptures"), metrics.get(
        "batcher.pool_restores")
    _serve_both(make, [("a", 512, 24), ("b", 512, 10)])
    assert metrics.get("batcher.pool_restores") > s0
    assert metrics.get("graphs.recaptures") > r0


@pytest.mark.cuda
def test_card_kept_embeddings_survive_the_next_chunk(card):
    """A request retired at the end of one chunk keeps its embeddings while
    the next chunk's replays overwrite x in place."""
    cfg, params = card
    snaps = []

    def make():
        b = tsv.PagedContinuousBatcher(
            params, cfg, num_slots=2, seq_len=512, page_size=64, seed=9,
            attend_mode="paged", keep_embeddings=True)
        snaps.append(_retire_snapshots(b))
        return b

    b_e, b_r = _serve_both(make, [("a", 512, 8), ("b", 512, 16),
                                  ("c", 512, 8)])
    assert sorted(snaps[1]) == ["a", "b", "c"]
    for rid in ("a", "b", "c"):
        np.testing.assert_array_equal(snaps[0][rid], snaps[1][rid])
        np.testing.assert_array_equal(b_r.done[rid].embeddings,
                                      snaps[1][rid])


@pytest.mark.cuda
def test_card_host_work_in_model_fn_raises(card):
    """A `model_fn` that copies to the host cannot be captured: the capture
    raises, naming `disabled()`, and the same call under it runs."""
    cfg, params = card
    sched = td.DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    log = []
    model_fn = _bf16_model_fn(cfg, params, log)
    shape = (2, 256, cfg.hidden_size)
    with pytest.raises(RuntimeError, match="disabled"):
        td.sample(model_fn, sched, shape,
                  torch.Generator(device="cuda").manual_seed(1), num_steps=3)
    with graphs.disabled():
        x = td.sample(model_fn, sched, shape,
                      torch.Generator(device="cuda").manual_seed(1),
                      num_steps=3)
    assert torch.isfinite(x).all() and len(log) == 1 + 3
