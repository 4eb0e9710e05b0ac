"""Port parity: the host-side stack against the JAX package's, on the CPU.

The suffix automaton, the router, the dedup store and its native runtime,
the salience engine, the ANN index and its row compression, the NaN guard
and the profiling helpers: the same numpy inputs, made from a seed, go
through both packages. Tolerances: compressed rows, router edges and
shards, store bytes, hashes and salience scores are equal; the ANN top-k ids
are equal, ties included (identical rows in row order, as `lax.top_k` orders
exact ties), and their similarities within 1e-6 (the f32 products sum in
another order).
"""

import time

import jax
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import quant as jquant
from diffusion_llm_rs_tpu.cache import salience as jsal
from diffusion_llm_rs_tpu.cache.suffix_tree import SuffixTree as JSuffixTree
from diffusion_llm_rs_tpu.index import anns as janns
from diffusion_llm_rs_tpu.router import router as jrouter
from diffusion_llm_rs_tpu.storage import dedup as jdedup
from diffusion_llm_rs_tpu.storage import native as jnative
from diffusion_llm_rs_tpu_torch import quant as tquant
from diffusion_llm_rs_tpu_torch.cache import salience as tsal
from diffusion_llm_rs_tpu_torch.cache.suffix_tree import SuffixTree
from diffusion_llm_rs_tpu_torch.index import anns as tanns
from diffusion_llm_rs_tpu_torch.router import router as trouter
from diffusion_llm_rs_tpu_torch.storage import dedup as tdedup
from diffusion_llm_rs_tpu_torch.storage import native as tnative
from diffusion_llm_rs_tpu_torch.utils import profiling
from diffusion_llm_rs_tpu_torch.utils.sanitize import nan_guard

CPU = "cpu"


def _rows(seed=0, n=40, d=32, distinct=6):
    """n rows drawn from `distinct` base rows: repeated rows, as a repeated
    word gives, so the index sees exact ties."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(distinct, d)).astype(np.float32)
    return base[rng.integers(0, distinct, size=n)]


def _same_vectors(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert (u.id, u.bits, tuple(u.original_shape)) == \
            (v.id, v.bits, tuple(v.original_shape))
        assert np.array_equal(np.asarray(u.data), v.data)
        assert u.quant_scale == v.quant_scale
        assert u.quant_zero_point == v.quant_zero_point


# --- compress_rows -----------------------------------------------------------

@pytest.mark.parametrize("cycle", [(1, 2, 4, 8), (4, 8), (8,), (2,)])
def test_compress_rows_bit_equal_to_jax_per_row(cycle):
    rows = _rows(1, n=23, d=40)
    rows[3] = 0.0   # a constant row: scale 1
    ids = [f"t:{i}" for i in range(len(rows))]
    want = janns.compress_rows(rows, cycle, ids)
    got = tanns.compress_rows(rows, cycle, ids, device=CPU)
    _same_vectors(want, got)
    for u, v in zip(want, got):
        assert np.array_equal(u.dequantize(), v.dequantize())


def test_compress_rows_default_ids_and_tensor_input():
    rows = _rows(2, n=5, d=16)
    want = janns.compress_rows(rows, [4, 8])
    _same_vectors(want, tanns.compress_rows(rows, [4, 8], device=CPU))
    _same_vectors(want, tanns.compress_rows(torch.from_numpy(rows), [4, 8],
                                            device=CPU))
    assert tanns.compress_rows(np.zeros((0, 16), np.float32), [8],
                               device=CPU) == []


# --- FusionANNS --------------------------------------------------------------

def _both_indexes(rows, **kw):
    j = janns.FusionANNS(embedding_dim=rows.shape[1], **kw)
    t = tanns.FusionANNS(embedding_dim=rows.shape[1], device=CPU, **kw)
    ids = [f"v{i}" for i in range(len(rows))]
    j.index_compressed(janns.compress_rows(rows, [8, 4], ids))
    t.index_compressed(tanns.compress_rows(rows, [8, 4], ids, device=CPU))
    return j, t


def _in_row_order_within_ties(result, index):
    """`result` with each run of identical stored rows put in row order.
    JAX's XLA matrix-vector product on the CPU can score identical rows up
    to an ulp apart, by their position in its tiling, and `lax.top_k` then
    orders them by that; the port scores them identically and orders them
    by row, as `lax.top_k` orders exact ties (ROADMAP.md queue C, 33)."""
    mat = np.asarray(tquant.dequantize(index._matrix))
    ids = [i for i, _ in result]
    out, start = [], 0
    while start < len(ids):
        row = mat[index._id_to_row[ids[start]]]
        end = start + 1
        while end < len(ids) and np.array_equal(
                mat[index._id_to_row[ids[end]]], row):
            end += 1
        out += sorted(ids[start:end], key=index._id_to_row.get)
        start = end
    return out


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
@pytest.mark.parametrize("nprobe", [1, 4])
def test_anns_top_k_equals_jax_with_tied_rows(metric, nprobe):
    """Every candidate ranked (k = 40), then the top 12: the port's ids are
    JAX's, identical rows in row order; its similarities within 1e-6
    (absolute for cosine, relative for l2 and dot, |sim| up to ~60)."""
    rows = _rows(3)
    j, t = _both_indexes(rows, num_centroids=4, nprobe=nprobe)
    assert np.array_equal(j.centroids, t.centroids)
    assert j.inverted_lists == t.inverted_lists
    rng = np.random.default_rng(4)
    worst, reordered = 0.0, 0
    for qi in range(8):
        q = rows[qi] + 0.05 * rng.normal(size=rows.shape[1]).astype(np.float32)
        want, got = j.query(q, 40, metric), t.query(q, 40, metric)
        ids = [i for i, _ in got]
        assert ids == _in_row_order_within_ties(got, t)   # ties by row
        assert ids == _in_row_order_within_ties(want, t)
        reordered += ids != [i for i, _ in want]
        assert [i for i, _ in t.query(q, 12, metric)] == ids[:12]
        assert len({s for _, s in got}) < len(got)        # exact ties seen
        worst = max([worst] + [abs(a[1] - b[1]) / max(1.0, abs(a[1]))
                               for a, b in zip(want, got)])
    print(f"{metric} nprobe={nprobe}: worst sim difference {worst:.3g}; "
          f"{reordered} of 8 answers had identical rows JAX scored apart")
    assert worst <= 1e-6


def test_anns_ties_follow_lax_top_k():
    """The port's ordering is `lax.top_k`'s on the port's own similarities,
    which score identical rows identically."""
    rows = _rows(11, n=50, d=24)
    t = tanns.FusionANNS(embedding_dim=24, num_centroids=1, device=CPU)
    t.index_vectors([f"u{i}" for i in range(50)], rows)
    for qi in range(5):
        got = t.query(rows[qi], 50)
        sims = np.array([s for _, s in got], np.float32)
        by_row = np.zeros(50, np.float32)
        for (vid, s) in got:
            by_row[t._id_to_row[vid]] = s
        _, idx = jax.lax.top_k(by_row, 50)
        assert [f"u{i}" for i in np.asarray(idx)] == [i for i, _ in got]
        assert np.array_equal(np.sort(sims)[::-1], sims)


def test_anns_reindex_empty_and_duplicates_as_jax():
    rows = _rows(5, n=30)
    j, t = _both_indexes(rows[:20], num_centroids=4)
    more = rows[20:]
    ids = [f"w{i}" for i in range(len(more))]
    j.index_vectors(ids, more)
    t.index_vectors(ids, more)
    assert len(j) == len(t) == 30
    assert np.array_equal(np.asarray(jquant.dequantize(j._matrix)),
                          tquant.dequantize(t._matrix).numpy())
    assert [i for i, _ in j.search(rows[25], 5)] == \
        [i for i, _ in t.search(rows[25], 5)]
    with pytest.raises(ValueError):
        t.index_vectors(["w0"], more[:1])
    with pytest.raises(ValueError):
        t.index_vectors(["z"], np.ones((1, 5), np.float32))
    assert tanns.FusionANNS(embedding_dim=8, device=CPU).search(
        np.ones(8), 3) == []
    p = t.predict_next_token(rows[:3], 7)
    assert np.array_equal(p, j.predict_next_token(rows[:3], 7))


def test_cosine_similarity_equals_jax():
    rng = np.random.default_rng(6)
    for a, b in [(rng.normal(size=9), rng.normal(size=9)), ([0, 0], [1, 1]),
                 ([1, 0], [0, 1])]:
        assert tanns.cosine_similarity(a, b) == janns.cosine_similarity(a, b)


# --- NSRouter ----------------------------------------------------------------

def _router_state(r):
    return (sorted((k, n.shard_id) for k, n in r.nodes.items()),
            {k: list(v) for k, v in r.edges.items()}, r.shard_sizes(),
            dict(r.shard_map),
            {k: (m.ssd_location.length, m.compression_info.ratio,
                 m.compression_info.bits)
             for k, m in r.vector_metadata.items()})


@pytest.mark.parametrize("shards,imbalance", [(4, 1.5), (2, 1.2), (3, 1.0)])
def test_router_edges_shards_and_rebalance_equal_jax(shards, imbalance):
    rows = _rows(7, n=30, d=16)
    ids = [f"m:{i}" for i in range(len(rows))]
    jr = jrouter.NSRouter(num_shards=shards, max_imbalance=imbalance)
    tr = trouter.NSRouter(num_shards=shards, max_imbalance=imbalance)
    jr.update_routing(janns.compress_rows(rows[:18], [1, 2, 4, 8], ids[:18]))
    tr.update_routing(tanns.compress_rows(rows[:18], [1, 2, 4, 8], ids[:18],
                                          device=CPU))
    jr.update_routing(janns.compress_rows(rows[18:], [8], ids[18:]))
    tr.update_routing(tanns.compress_rows(rows[18:], [8], ids[18:],
                                          device=CPU))
    assert _router_state(jr) == _router_state(tr)
    for n in list(jr.nodes.values())[:10]:
        n.shard_id = 0
    for n in list(tr.nodes.values())[:10]:
        n.shard_id = 0
    assert jr.rebalance_shards() == tr.rebalance_shards()
    assert _router_state(jr) == _router_state(tr)
    q = rows[4]
    assert jr.route_query(q, 3) == tr.route_query(q, 3)
    assert jr.find_shard(q) == tr.find_shard(q)
    assert tr.route_query(np.zeros(5), 2) is not None
    assert trouter.NSRouter().route_query(np.ones(3), 3) == []


# --- dedup store and the native runtime -------------------------------------

@pytest.fixture(params=["native", "python"])
def store_path(request, monkeypatch):
    """The port's store through its C++ runtime, or through the Python
    fallback (the runtime reported missing)."""
    if request.param == "native":
        if tnative._load() is None:
            pytest.fail("the C++ runtime did not build")
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return request.param


def _jax_reads(path, locations, ids):
    """Read the port's store file with the JAX package's engine, at the
    locations the port recorded."""
    eng = jdedup.IODedupEngine(path=path)
    eng.locations = {k: jrouter.SSDLocation(loc.page_id, loc.offset,
                                            loc.length)
                     for k, loc in locations.items()}
    out = eng.read_vectors(ids)
    eng.close()
    return out


def test_dedup_store_reads_back_in_jax_with_equal_hits(tmp_path, store_path):
    rows = np.concatenate([_rows(8, n=24, d=48), _rows(8, n=24, d=48)[:6]])
    ids = [f"d:{i}" for i in range(len(rows))]
    tvec = tanns.compress_rows(rows, [1, 2, 4, 8], ids, device=CPU)
    jvec = janns.compress_rows(rows, [1, 2, 4, 8], ids)
    te = tdedup.IODedupEngine(path=str(tmp_path / "t.bin"), batch_size=5)
    je = jdedup.IODedupEngine(path=str(tmp_path / "j.bin"), batch_size=5)
    assert te.store_vectors(tvec[:30]) == je.store_vectors(jvec[:30])
    assert te.store_vectors(tvec[30:]) == je.store_vectors(jvec[30:])
    assert te.dedup_hits == je.dedup_hits > 0
    assert te.stats() == je.stats()
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    got = te.read_vectors(ids)
    assert got == je.read_vectors(ids)
    assert te.stats() == je.stats()
    assert got == [np.asarray(v.data, np.uint8).tobytes() for v in tvec]
    te.close()
    je.close()
    assert _jax_reads(str(tmp_path / "t.bin"), te.locations, ids) == got
    assert te.read_vector("missing") is None


def test_io_merger_and_monitor_equal_jax():
    chunks = [(f"c{i}", bytes([i]) * (i + 1)) for i in range(7)]
    want = jdedup.IOMerger(3).merge_requests(chunks)
    got = tdedup.IOMerger(3).merge_requests(chunks)
    assert [(r.id, r.offset, r.length, r.data) for r in want] == \
        [(r.id, r.offset, r.length, r.data) for r in got]
    assert tdedup.ReadAmplificationMonitor().amplification_ratio == 1.0


@pytest.mark.parametrize("data", [b"", b"a", b"diffusion", bytes(range(256)),
                                  np.arange(1000, dtype=np.float32).tobytes()])
def test_fnv1a64_equal_on_native_and_python_paths(data):
    want = jnative.fnv1a64(data)
    assert tnative._load() is not None, "the C++ runtime did not build"
    assert tnative.fnv1a64(data) == want
    assert tnative.fnv1a64_py(data) == want
    assert tdedup.content_hash(data) == jdedup.content_hash(data)


def test_native_builds_into_the_port_build_dir():
    assert tnative._load() is not None and tnative.NATIVE_AVAILABLE
    target = tnative._target()
    assert target.exists() and target.parent == tnative.BUILD_DIR
    assert target.parent.parent.name == "build"


def test_native_block_pool_exhaustion():
    pool = tnative.BlockPool(2, 256)
    a = pool.allocate_block()
    pool.allocate_block()
    with pytest.raises(MemoryError):
        pool.allocate_block()
    pool.free_block(a)
    assert pool.num_free() == 1
    pool.destroy()


def test_store_opened_on_a_non_empty_file_records_wrong_locations(tmp_path):
    """Carried over from the JAX package (ROADMAP.md queue C): the write
    offset starts at 0 while the file is appended at its end, so a second
    store opened on the same file reads the first store's bytes back."""
    rows = _rows(9, n=2, d=8)
    outs = []
    for anns_mod, dedup_mod in ((tanns, tdedup), (janns, jdedup)):
        kw = {"device": CPU} if anns_mod is tanns else {}
        a = anns_mod.compress_rows(rows[:1], [8], ["a"], **kw)
        b = anns_mod.compress_rows(-rows[:1] - 1, [8], ["b"], **kw)
        path = str(tmp_path / f"{dedup_mod.__name__}.bin")
        for vec in (a, b):
            e = dedup_mod.IODedupEngine(path=path)
            e.store_vectors(vec)
            got = e.read_vector(vec[0].id)
            e.close()
        outs.append((got, np.asarray(a[0].data, np.uint8).tobytes(),
                     np.asarray(b[0].data, np.uint8).tobytes()))
    assert outs[0] == outs[1]
    got, a_bytes, b_bytes = outs[0]
    assert got == a_bytes != b_bytes


# --- suffix automaton --------------------------------------------------------

@pytest.mark.parametrize("text", ["banana", "the quick brown fox", "",
                                  "aaaaabaaaab"])
def test_suffix_tree_equals_jax(text):
    j, t = JSuffixTree(text), SuffixTree(text)
    pats = ["", "a", "ana", "nan", "apple", "quick brown cat", "zebra",
            "aab", "baaaab", text, text + "x", text[1:]]
    assert [j.search(p) for p in pats] == [t.search(p) for p in pats]
    assert [j.longest_match(p) for p in pats] == \
        [t.longest_match(p) for p in pats]
    assert [(s.len, s.link, s.next) for s in j._states] == \
        [(s.len, s.link, s.next) for s in t._states]


# --- salience engine ---------------------------------------------------------

def test_salience_engine_equals_jax_at_a_fixed_clock(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    j, t = jsal.SalienceEngine(cache_size=3), tsal.SalienceEngine(cache_size=3)
    for step, vid in enumerate(["hot", "hot", "cold", "hot", "warm", "cold"]):
        clock[0] = 1000.0 + 37.5 * step
        j.update(vid)
        t.update(vid)
    clock[0] = 1500.0
    ids = ["hot", "cold", "warm", "absent"]
    assert [j.score(i) for i in ids] == [t.score(i) for i in ids]
    assert [t.score(i, now=1500.0) for i in ids] == [t.score(i) for i in ids]
    assert j.optimize(ids) == t.optimize(ids) == t.optimize(ids, now=1500.0)
    assert [j.predict(i) for i in ids] == [t.predict(i) for i in ids]
    text = "The quick brown fox jumps over the lazy dog the end"
    assert j.calculate(text) == t.calculate(text)
    for w in ("the", "THE", "dog", "end", "missing"):
        assert j.get_cached_score(w) == t.get_cached_score(w)
    assert list(j._word_cache.items()) == list(t._word_cache.items())
    s = np.random.default_rng(10).random(17).astype(np.float32)
    assert np.array_equal(j.allocate_bits(s, 3.0), t.allocate_bits(s, 3.0))


def test_importance_scorer_decay_with_explicit_now():
    j, t = jsal.ImportanceScorer(half_life_s=60.0), \
        tsal.ImportanceScorer(half_life_s=60.0)
    for now in (0.0, 30.0, 45.0):
        j.update("x", now=now)
        t.update("x", now=now)
    for now in (45.0, 105.0, 1e4, 10.0):
        assert j.score("x", now) == t.score("x", now)
    assert t.score("x", 105.0) == pytest.approx(1.5)
    pat = tsal.AccessPattern(frequency=3, importance_score=2.0)
    pred = tsal.PrefillPredictor()
    pred.weights[:] = [0.5, 0.25]
    jpred = jsal.PrefillPredictor()
    jpred.weights[:] = [0.5, 0.25]
    assert pred.predict(pat) == jpred.predict(
        jsal.AccessPattern(frequency=3, importance_score=2.0)) == 2.0
    assert tsal.CacheOptimizer(1).optimize(["x", "y"], t, now=45.0) == ["x"]


# --- quant helpers -----------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_packed_last_dim_and_compression_ratio_equal_jax(bits):
    x = np.random.default_rng(bits).normal(size=(6, 20)).astype(np.float32)
    for last in (1, 7, 8, 20):
        assert tquant.packed_last_dim(last, bits) == \
            jquant.packed_last_dim(last, bits)
    for kw in ({}, dict(granularity="channel", axis=0)):
        jq = jquant.quantize(x, bits, **kw)
        tq = tquant.quantize(torch.from_numpy(x), bits, **kw)
        for side in (False, True):
            assert tq.compression_ratio(side) == jq.compression_ratio(side)


# --- NaN guard and profiling -------------------------------------------------

def test_nan_guard_raises_and_is_restored():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    x = torch.ones(3)
    with pytest.raises(FloatingPointError):
        with nan_guard():
            x / 0.0 * 0.0
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(x / 0.0 * 0.0).all()   # unguarded again
    with nan_guard():                          # finite work passes
        y = (x * 2).sum()
    assert float(y) == 6.0


def test_profiling_stage_and_trace(tmp_path):
    profiling.setup_logging()
    with profiling.profile_trace(str(tmp_path)) as prof:
        with profiling.stage("ingest", tokens=3):
            torch.ones(4).add_(1)
    names = {e.key for e in prof.key_averages()}
    assert "ingest" in names
    assert len(list(tmp_path.glob("trace-*.json"))) == 1
