"""Port parity: the sharded paged batcher (`parallel/serving.py`) against the
port's single-process `PagedContinuousBatcher` and JAX's
`ShardedPagedBatcher`, on the CPU.

The single-process batcher runs here on the JAX batcher's key chain
(`JaxNoise`) and records every draw; the ranks, 4 and 2 processes joined by
gloo (`_torch_dist.spawn`, once per world size for the file), replay the
draws (`Replay`, which also fails if a rank asks for another draw than the
recorded run made). JAX's sharded batcher runs on its virtual CPU devices
from the same seed. The children import no JAX. `pytest -rP` prints each
measured difference.
"""

import numpy as np
import pytest
import torch

from _torch_dist import Recorded, Replay, export, spawn
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.parallel import serving as psv
from diffusion_llm_rs_tpu_torch.parallel.mesh import Mesh, make_mesh
from diffusion_llm_rs_tpu_torch.parallel.serving import ShardedPagedBatcher
from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher, Request
from diffusion_llm_rs_tpu_torch.utils import graphs
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics
from diffusion_llm_rs_tpu_torch.weights import from_jax_params
from test_torch_graphs import CpuGraph

REQS = [("a", 8, 6), ("b", 4, 3), ("c", 8, 9)]
KW = dict(num_slots=4, seq_len=8, page_size=4, seed=5, attend_mode="paged")
MESHES = {4: [(2, 2), (4, 1)], 2: [(1, 2)]}
# the other cases: (name, model, batcher keywords, requests, mesh)
CASES = [
    ("grouped", "wide", dict(num_slots=2, seq_len=8, page_size=8, seed=3,
                             attend_mode="paged"), [("g", 8, 5)], (2, 2)),
    ("admission", "base", dict(num_slots=2, seq_len=8, page_size=4, seed=1),
     [(f"q{i}", 8, s) for i, s in enumerate([6, 3, 5, 2])], (2, 2)),
    ("salience", "base", dict(num_slots=2, seq_len=16, page_size=4, seed=2,
                              salience_routing=True),
     [("s", 16, 8)], (2, 2)),
    ("salience_dp", "base", dict(num_slots=4, seq_len=16, page_size=4, seed=2,
                                 salience_routing=True),
     [("s", 16, 8), ("u", 12, 5)], (4, 1)),
    ("quantized", "int4", dict(num_slots=2, seq_len=8, page_size=4, seed=4),
     [("q", 8, 4)], (2, 2)),
    ("phases", "base", dict(num_slots=4, seq_len=8, page_size=4, seed=6,
                            attend_mode="paged"),
     [("p", 8, 30), ("r", 8, 7)], (2, 2)),
]


class JaxNoise:
    """Replays the JAX batcher's key chain: same draws, same order."""

    def __init__(self, seed):
        import jax
        self.key = jax.random.PRNGKey(seed)

    def admission(self, shape):
        import jax
        import jax.numpy as jnp
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))

    def step(self, shape):
        import jax
        import jax.numpy as jnp
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, shape[0])
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.normal(k, shape[1:], jnp.float32))(keys)))


def _drive(b, reqs, first_step=None):
    for rid, n, steps in reqs:
        b.submit(Request(rid, n, steps))
    if first_step is not None:
        first_step.append((b.step(), b.stats()["queued"]))
    return {c.request_id: (c.tokens, c.embeddings, c.steps)
            for c in b.run_until_drained()}


def _replayed(fn):
    """(`fn()`, graph replays) with the sharded batchers made inside
    replaying their chunk's step as on an NCCL group: every `GraphCache`
    captures on the CPU with `CpuGraph` (a replay runs the captured step
    again, gloo collectives included) and the 'model' group counts as
    NCCL's. The card's warm-up, capture, static buffers, pointer checks
    and per-rank rows run as they do there."""
    saved = (graphs.GraphCache.graph_type, graphs.GraphCache.capturing,
             psv.nccl_only)
    graphs.GraphCache.graph_type = CpuGraph
    graphs.GraphCache.capturing = (
        lambda self: self.capture and not graphs.is_disabled())
    psv.nccl_only = lambda groups: True
    r0 = metrics.get("graphs.replays")
    try:
        return fn(), metrics.get("graphs.replays") - r0
    finally:
        (graphs.GraphCache.graph_type, graphs.GraphCache.capturing,
         psv.nccl_only) = saved


def _serving_worker(rank, world, payload):
    cfg = tcfg_mod.diffusion_config_from_json(payload["cfg"]["base"])
    params = from_jax_params(payload["params"]["base"], device="cpu")
    out = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, device="cpu")
        b = ShardedPagedBatcher(params, cfg, mesh,
                                noise=Replay(payload["draws"]), **KW)
        out[("main", shape)] = _drive(b, REQS)
        pool = b.pools[b.buckets[0]]
        out[("state", shape)] = dict(
            x=tuple(b.x.shape), pool=tuple(pool["k_data"].shape),
            scale=tuple(pool["k_scale"].shape), group=b.head_group)
        out[("replayed", shape)] = _replayed(lambda: _drive(
            ShardedPagedBatcher(params, cfg, mesh,
                                noise=Replay(payload["draws"]), **KW), REQS))
    if world != 4:
        return out
    for name, model, kw, reqs, shape in CASES:
        mesh = make_mesh(shape, device="cpu")
        b = ShardedPagedBatcher(
            from_jax_params(payload["params"][model], device="cpu"),
            tcfg_mod.diffusion_config_from_json(payload["cfg"][model]), mesh,
            noise=Replay(payload["case_draws"][name]), **kw)
        first = []
        out[name] = _drive(b, reqs, first)
        out[(name, "first")] = first[0]
        out[(name, "group")] = b.head_group
        out[(name, "scores")] = b.page_scores
        if name == "salience":   # the scores' all-reduce inside the step
            out[("replayed", name)] = _replayed(lambda: _drive(
                ShardedPagedBatcher(
                    from_jax_params(payload["params"][model], device="cpu"),
                    tcfg_mod.diffusion_config_from_json(
                        payload["cfg"][model]), mesh,
                    noise=Replay(payload["case_draws"][name]), **kw),
                reqs))
    # an HBM budget of one byte: every idle bucket spills to the host tier
    # and comes back through `_place_pool` when the router needs it
    mesh = make_mesh((2, 2), device="cpu")
    _, _, kw, reqs, _ = CASES[-1]
    b = ShardedPagedBatcher(params, cfg, mesh, hbm_budget_bytes=1,
                            noise=Replay(payload["case_draws"]["phases"]),
                            **kw)
    spills = metrics.get("batcher.pool_spills")
    restores = metrics.get("batcher.pool_restores")
    out["budget"] = _drive(b, reqs)
    out["spills"] = (metrics.get("batcher.pool_spills") - spills,
                     metrics.get("batcher.pool_restores") - restores)
    return out


@pytest.fixture(scope="module")
def case():
    """The models (JAX's tiny serving model: width 64, 4 heads, vocab 128;
    the same at width 128, heads of 32; its int4 packing), the
    single-process port runs with their recorded draws, and JAX's sharded
    batcher at the three meshes."""
    import jax
    from diffusion_llm_rs_tpu import config as jcfg_mod
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu.ops.pallas_matmul import prepare
    from diffusion_llm_rs_tpu.parallel.mesh import make_mesh as jmake_mesh
    from diffusion_llm_rs_tpu.parallel.serving import (ShardedPagedBatcher as
                                                       JSharded)
    from diffusion_llm_rs_tpu.quant.core import QuantizedTensor, quantize_tree
    from diffusion_llm_rs_tpu.serving import Request as JRequest

    jcfgs, jparams = {}, {}
    for model, hidden in (("base", 64), ("wide", 128)):
        jcfgs[model] = jcfg_mod.DiffusionConfig.tiny(
            vocab_size=128, hidden_size=hidden, num_attention_heads=4)
        jparams[model] = jdn.init_denoiser_params(jax.random.PRNGKey(0),
                                                  jcfgs[model])
    qp = quantize_tree(jparams["base"], 4, symmetric=True,
                       granularity="group", group_size=32, axis=0,
                       min_size=256)
    jcfgs["int4"] = jcfgs["base"]
    jparams["int4"] = jax.tree_util.tree_map(
        lambda l: prepare(l) if isinstance(l, QuantizedTensor) and l.ndim == 2
        else l, qp, is_leaf=lambda l: isinstance(l, QuantizedTensor))
    payload = dict(cfg={k: jcfg_mod.to_json(v) for k, v in jcfgs.items()},
                   params={k: export(v) for k, v in jparams.items()},
                   case_draws={})

    def single(model, kw, reqs):
        rec = Recorded(JaxNoise(kw["seed"]))
        b = PagedContinuousBatcher(
            from_jax_params(payload["params"][model], device="cpu"),
            tcfg_mod.diffusion_config_from_json(payload["cfg"][model]),
            device="cpu", noise=rec, **kw)
        first = []
        done = _drive(b, reqs, first)
        return dict(done=done, first=first[0], group=b.head_group,
                    scores=b.page_scores), rec.draws

    out = {}
    out["main"], payload["draws"] = single("base", KW, REQS)
    for name, model, kw, reqs, _ in CASES:
        out[name], payload["case_draws"][name] = single(model, kw, reqs)
    jax_done = {}
    for shape in MESHES[4] + MESHES[2]:
        mesh = jmake_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
        b = JSharded(jparams["base"], jcfgs["base"], mesh, **KW)
        for rid, n, steps in REQS:
            b.submit(JRequest(rid, n, steps))
        jax_done[shape] = {c.request_id: (c.tokens, c.embeddings)
                           for c in b.run_until_drained()}
    return dict(payload=payload, single=out, jax=jax_done)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    out = {}
    for world in (4, 2):
        results = spawn(_serving_worker, world, case["payload"],
                        tmp_path_factory.mktemp(f"serve{world}"))
        for r in results:
            assert not r.pop("jax_loaded"), "a rank imported JAX"
        # every rank's scheduler retires the same slots with the same readout
        runs = [k for k in results[0] if k in ("budget",) + tuple(
            c[0] for c in CASES) or (isinstance(k, tuple) and k[0] == "main")]
        for r in results[1:]:
            for key in runs:
                for rid, (tok, emb, _) in results[0][key].items():
                    np.testing.assert_array_equal(r[key][rid][0], tok)
                    np.testing.assert_array_equal(r[key][rid][1], emb)
        out[world] = results
    return out


def _worst(a, b):
    return max(float(np.abs(a[r][1] - b[r][1]).max()) for r in b)


@pytest.mark.parametrize("shape", MESHES[4] + MESHES[2], ids=str)
def test_sharded_matches_single_process(case, ranks, shape):
    """Same requests, same draws: the same completions. Embeddings within
    2e-4 (JAX's bound for its sharded batcher; TP reorders the sums); with
    'model' of size 1 the tokens are the single-process tokens, bit for
    bit."""
    got = ranks[4 if shape in MESHES[4] else 2][0][("main", shape)]
    want = case["single"]["main"]["done"]
    assert sorted(got) == sorted(want) == ["a", "b", "c"]
    print(f"sharded {shape} vs single-process: embeddings max abs "
          f"{_worst(got, want):.3g}")
    for rid in want:
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=2e-4,
                                   atol=2e-4)
        assert got[rid][2] == want[rid][2]
        if shape[1] == 1:
            np.testing.assert_array_equal(got[rid][0], want[rid][0])


@pytest.mark.parametrize("shape", MESHES[4] + MESHES[2], ids=str)
def test_sharded_matches_jax(case, ranks, shape):
    """Against JAX's `ShardedPagedBatcher` at the same mesh and seed: JAX's
    exact f32 paged fallback against the port's bf16 twin of the kernel
    (the single-process batchers differ so, test_torch_serving.py): the
    embeddings within 1e-4, the tokens equal."""
    got = ranks[4 if shape in MESHES[4] else 2][0][("main", shape)]
    want = case["jax"][shape]
    assert sorted(got) == sorted(want)
    print(f"sharded {shape} vs JAX's sharded batcher: embeddings max abs "
          f"{_worst(got, want):.3g}")
    for rid in want:
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got[rid][0], want[rid][0])


@pytest.mark.parametrize("shape", MESHES[4] + MESHES[2] + ["salience"],
                         ids=str)
def test_sharded_replayed_equals_eager(case, ranks, shape):
    """The chunk's step captured and replayed (`_replayed`: NCCL's path,
    with the CPU's stand-in graphs over gloo) gives its eager run's
    completions bit for bit on every rank, so the single batcher's and
    JAX's as above; salience routing at (2, 2) runs the scores' all-reduce
    inside the replayed step."""
    world = 2 if shape in MESHES[2] else 4
    key = "salience" if shape == "salience" else ("main", shape)
    for r in ranks[world]:
        got, replays = r[("replayed", shape)]
        want = r[key]
        assert replays > 0 and sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid][0], want[rid][0])
            np.testing.assert_array_equal(got[rid][1], want[rid][1])
            assert got[rid][2] == want[rid][2]
    if shape == "salience":
        return
    jax_done = case["jax"][shape]
    for rid in jax_done:
        np.testing.assert_allclose(got[rid][1], jax_done[rid][1], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got[rid][0], jax_done[rid][0])


def test_sharded_state_is_local(ranks):
    """Slot state holds the rank's B/dp slots; pools hold their pages
    (L * B/dp * pages) and the rank's head groups."""
    for shape, world in (((2, 2), 4), ((4, 1), 4), ((1, 2), 2)):
        dp, tp = shape
        st = ranks[world][0][("state", shape)]
        assert st["x"] == (4 // dp, 8, 64)
        # 2 layers x B/dp slots x 2 pages; 4 heads of 16 in groups of 1
        assert st["pool"][:2] == (2 * (4 // dp) * 2, 4 // tp)
        assert st["scale"] == (2 * (4 // dp) * 2, 4 // tp, 4)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_cases_match_single_process(case, ranks, name):
    """Heads of 32 at tp 2 (head groups of 2 where the single batcher packs
    4), a queue longer than the slots (2 admitted, 2 queued after the first
    step), int4-packed weights split over 'model', a 30-step request across
    the 8 -> 4 -> 2 bit phases, salience routing: the same completions as
    the single-process batcher. Embeddings within 2e-4, except salience at
    tp 2: the page-mass proxy is averaged over each rank's heads, as JAX
    does, which is not the single batcher's proxy over all heads, so the
    pages may route to other widths (finite; scores a distribution)."""
    got = ranks[4][0][name]
    want = case["single"][name]
    assert sorted(got) == sorted(want["done"])
    first = ranks[4][0][(name, "first")]
    if name == "admission":
        assert first == want["first"] == (2, 2)
    if name == "grouped":
        assert want["group"] == 4 and ranks[4][0][(name, "group")] == 2
    scores = ranks[4][0][(name, "scores")]
    if name == "salience":
        assert np.isfinite(scores).all() and (scores >= 0).all()
        assert abs(float(scores[0].sum()) - 1.0) < 1e-2
        for rid in want["done"]:
            assert np.isfinite(got[rid][1]).all()
        return
    print(f"{name}: embeddings max abs {_worst(got, want['done']):.3g}")
    for rid in want["done"]:
        np.testing.assert_allclose(got[rid][1], want["done"][rid][1],
                                   rtol=2e-4, atol=2e-4)
    if name == "salience_dp":   # tp 1: the single batcher's proxy exactly
        np.testing.assert_allclose(scores, want["scores"], rtol=1e-5,
                                   atol=1e-6)
        for rid in want["done"]:
            np.testing.assert_array_equal(got[rid][0], want["done"][rid][0])


def test_sharded_hbm_budget_spills_and_restores_exactly(ranks):
    """Under a one-byte budget the idle buckets spill to the host tier and
    come back (`_place_pool`): the completions equal the unbudgeted run's
    bit for bit (every page is rewritten each step)."""
    r = ranks[4][0]
    spills, restores = r["spills"]
    print(f"one-byte budget: {spills} spills, {restores} restores")
    assert spills > 0 and restores > 0
    for rid, (tok, emb, _) in r["phases"].items():
        np.testing.assert_array_equal(r["budget"][rid][0], tok)
        np.testing.assert_array_equal(r["budget"][rid][1], emb)


def test_sharded_validates_divisibility():
    """Checked before any collective: a stand-in mesh of (2, 2) with no
    process group is enough."""
    mesh = Mesh(("data", "model"), (2, 2), torch.device("cpu"))
    cfg3 = tcfg_mod.DiffusionConfig.tiny(vocab_size=128, num_attention_heads=3,
                                         hidden_size=48)
    with pytest.raises(ValueError, match="heads"):
        ShardedPagedBatcher({}, cfg3, mesh, num_slots=4, seq_len=8)
    cfg = tcfg_mod.DiffusionConfig.tiny(vocab_size=128)
    with pytest.raises(ValueError, match="num_slots"):
        ShardedPagedBatcher({}, cfg, mesh, num_slots=3, seq_len=8)


@pytest.mark.parametrize("tp,heads,group", [(1, 12, 2), (2, 6, 2), (4, 3, 1)])
def test_head_group_halves_until_local_heads_tile(tp, heads, group):
    """The full-width model's 12 heads of 64 share page rows of 128 in
    pairs; a rank's heads must still tile into whole rows, so at tp = 4 (3
    local heads) the group halves to 1. No process group needed."""
    b = object.__new__(ShardedPagedBatcher)
    b.cfg = tcfg_mod.DiffusionConfig(hidden_size=768, num_layers=12,
                                     num_attention_heads=12, vocab_size=50257)
    b.tp, b.dp = tp, 1
    assert (b._local_heads, b._choose_head_group()) == (heads, group)
