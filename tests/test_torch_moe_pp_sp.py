"""Port parity: expert parallelism (`models/moe.py`), ring attention and the
sequence-parallel forward (`parallel/sp.py`), and the GPipe ring
(`parallel/pp.py`) against the JAX package, on the CPU.

Each strategy runs in 4 processes (2 for the two-stage pipeline) joined by
gloo (`_torch_dist.spawn`, once per world size for the file) and is held
against the unsharded forward, the port's and JAX's, on the same numpy
inputs; the MoE model's dispatches and its load-balancing loss against
JAX's in one process. The children import no JAX. `pytest -rP` prints each
measured difference.
"""

import numpy as np
import pytest
import torch

from _torch_dist import export, spawn
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.models import moe as tmoe
from diffusion_llm_rs_tpu_torch.parallel import pp as tpp
from diffusion_llm_rs_tpu_torch.parallel import sp as tsp
from diffusion_llm_rs_tpu_torch.parallel.mesh import Mesh
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

CAPS = (1.25, 0.5)   # 0.5 drops tokens


def _t(a):
    return torch.from_numpy(a)


def _worker(rank, world, p):
    cfg = tcfg_mod.diffusion_config_from_json(p["cfg"])
    params = from_jax_params(p["params"], device="cpu")
    out = {}
    if world == 2:
        mesh = tpp.make_stage_mesh(2, device="cpu")
        stage = tpp.place_stage_params(tpp.stack_stage_params(params, 2), mesh)
        out["pp2"] = tpp.make_pp_forward(cfg, mesh, n_micro=1)(
            params, stage, _t(p["x2"]), _t(p["t2"])).numpy()
        return out
    mesh = tsp.make_seq_mesh(4, device="cpu")
    i = mesh.index("seq")
    q, k, v = (_t(a)[:, i * 8:(i + 1) * 8] for a in p["qkv"])
    out["ring"] = tsp.ring_attention(q, k, v, mesh.group("seq"), 4).numpy()
    out["sp"] = tsp.make_sp_forward(cfg, mesh)(params, _t(p["x"]),
                                               _t(p["t"])).numpy()

    mesh = tpp.make_stage_mesh(4, device="cpu")
    stage = tpp.place_stage_params(tpp.stack_stage_params(params, 4), mesh)
    out["pp4"] = tpp.make_pp_forward(cfg, mesh, n_micro=2)(
        params, stage, _t(p["x"]), _t(p["t"])).numpy()

    mesh = tmoe.make_expert_mesh(4, device="cpu")
    moe = tmoe.place_ep_params(from_jax_params(p["moe"], device="cpu"), mesh)
    out["bank_rows"] = moe["blocks"][0]["moe"]["w1"].shape[0]
    for cap in CAPS:
        for dispatch in ("dense", "sorted"):
            out[("ep", cap, dispatch)] = tmoe.make_ep_forward(
                cfg, mesh, capacity_factor=cap, dispatch=dispatch)(
                moe, _t(p["xm"]), _t(p["tm"])).numpy()
    return out


@pytest.fixture(scope="module")
def case():
    """JAX's tiny model (width 32, 4 layers, 4 heads, S <= 64), its MoE
    variant with 8 experts, the inputs, and JAX's unsharded forwards."""
    import jax
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu import config as jcfg_mod
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu.models import moe as jmoe

    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=32, num_layers=4,
                                         num_attention_heads=4,
                                         max_sequence_length=64)
    params = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    moe = jmoe.init_moe_denoiser_params(jax.random.PRNGKey(5), jcfg, 8)
    rng = np.random.default_rng(1)
    p = dict(cfg=jcfg_mod.to_json(jcfg), params=export(params),
             moe=export(moe),
             x=rng.normal(size=(4, 32, 32)).astype(np.float32),
             t=rng.integers(0, 50, size=(4,)).astype(np.int64),
             x2=rng.normal(size=(2, 32, 32)).astype(np.float32),
             t2=rng.integers(0, 50, size=(2,)).astype(np.int64),
             xm=rng.normal(size=(4, 16, 32)).astype(np.float32),
             tm=rng.integers(0, 50, size=(4,)).astype(np.int64),
             qkv=[rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
                  for _ in range(3)])
    j = lambda a: jnp.asarray(a)  # noqa: E731
    ref = dict(
        dense=np.asarray(jdn.denoiser_forward(params, jcfg, j(p["x"]),
                                              j(p["t"]))),
        dense2=np.asarray(jdn.denoiser_forward(params, jcfg, j(p["x2"]),
                                               j(p["t2"]))))
    for cap in CAPS:
        ref[("moe", cap)] = np.asarray(jmoe.moe_denoiser_forward(
            moe, jcfg, j(p["xm"]), j(p["tm"]), capacity_factor=cap))
    return dict(payload=p, jax=ref, jax_moe=moe)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    out = {}
    for world in (4, 2):
        results = spawn(_worker, world, case["payload"],
                        tmp_path_factory.mktemp(f"mps{world}"))
        for r in results:
            assert not r.pop("jax_loaded"), "a rank imported JAX"
        out[world] = results
    return out


def _port(case):
    p = case["payload"]
    return (tcfg_mod.diffusion_config_from_json(p["cfg"]),
            from_jax_params(p["params"], device="cpu"))


def test_ring_attention_matches_full(case, ranks):
    """Each rank's block of the ring's output equals full attention over
    the whole sequence (the port's einsum attention) within 1e-5."""
    q, k, v = (_t(a) for a in case["payload"]["qkv"])
    full = tdn.attention(q, k, v).numpy()
    for i, r in enumerate(ranks[4]):
        got = r["ring"]
        want = full[:, i * 8:(i + 1) * 8]
        print(f"ring block {i} vs full attention: max abs "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sp_forward_matches_dense(case, ranks):
    """The ring of 4 against JAX's and the port's unsharded forward: 2e-5,
    JAX's own bound for its ring."""
    cfg, params = _port(case)
    p = case["payload"]
    with torch.no_grad():
        mine = tdn.denoiser_forward(params, cfg, _t(p["x"]),
                                    _t(p["t"])).numpy()
    for r in ranks[4]:
        print(f"SP forward vs JAX: max abs "
              f"{np.abs(r['sp'] - case['jax']['dense']).max():.3g}")
        np.testing.assert_allclose(r["sp"], case["jax"]["dense"], atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(r["sp"], mine, atol=2e-5, rtol=2e-5)


def test_sp_forward_rejects_ragged_and_long_sequences(case):
    """Checked before any collective: a stand-in ring of 4 with no group."""
    cfg, params = _port(case)
    run = tsp.make_sp_forward(cfg, Mesh(("seq",), (4,), torch.device("cpu")))
    t = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(ValueError, match="not divisible"):
        run(params, torch.zeros((1, 30, 32)), t)
    with pytest.raises(ValueError, match="max_sequence_length"):
        run(params, torch.zeros((1, 68, 32)), t)


@pytest.mark.parametrize("stages,micro", [(4, 2), (2, 1)])
def test_pp_forward_matches_dense(case, ranks, stages, micro):
    """The GPipe ring (4 stages over 2 microbatches; 2 stages over 1)
    against JAX's unsharded forward: 2e-5, JAX's own bound; the outputs
    reach every stage."""
    key, ref, world = (("pp4", "dense", 4) if stages == 4
                       else ("pp2", "dense2", 2))
    for r in ranks[world]:
        got = r[key]
        print(f"PP {stages} stages, {micro} microbatches vs JAX: max abs "
              f"{np.abs(got - case['jax'][ref]).max():.3g}")
        np.testing.assert_allclose(got, case["jax"][ref], atol=2e-5, rtol=2e-5)


def test_stack_stage_params(case):
    cfg, params = _port(case)
    stacked = tpp.stack_stage_params(params, 4)
    assert len(stacked) == 4 and all(len(s) == 1 for s in stacked)
    assert stacked[2][0] is params["blocks"][2]
    with pytest.raises(ValueError, match="not divisible"):
        tpp.stack_stage_params(params, 3)
    with pytest.raises(ValueError, match="stages"):
        tpp.place_stage_params(stacked, Mesh(("stage",), (2,),
                                             torch.device("cpu")))


def test_moe_tree_carries_3d_banks(case):
    """`from_jax_params` carries a MoE tree: its [E, D, M] banks and [D, E]
    router equal JAX's bit for bit."""
    t = from_jax_params(case["payload"]["moe"], device="cpu")
    jb = case["jax_moe"]["blocks"][1]["moe"]
    tb = t["blocks"][1]["moe"]
    assert "mlp" not in t["blocks"][1] and tb["w1"].shape == (8, 32, 128)
    for k in ("router", "w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("cap", CAPS)
def test_moe_forward_matches_jax(case, cap):
    """The port's unsharded MoE forward against JAX's, same routing and
    drops: within 2e-5."""
    cfg = tcfg_mod.diffusion_config_from_json(case["payload"]["cfg"])
    moe = from_jax_params(case["payload"]["moe"], device="cpu")
    p = case["payload"]
    with torch.no_grad():
        got = tmoe.moe_denoiser_forward(moe, cfg, _t(p["xm"]), _t(p["tm"]),
                                        capacity_factor=cap).numpy()
    want = case["jax"][("moe", cap)]
    print(f"MoE forward (capacity {cap}) vs JAX: max abs "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
def test_ep_forward_matches_unsharded(case, ranks, cap, dispatch):
    """Four expert ranks, 2 of the 8 experts each and a quarter of the
    batch: against the unsharded forward (the port's, and JAX's) within
    2e-5, JAX's own bound, with and without dropped tokens: the capacity
    and the drop order are the whole batch's."""
    cfg = tcfg_mod.diffusion_config_from_json(case["payload"]["cfg"])
    moe = from_jax_params(case["payload"]["moe"], device="cpu")
    p = case["payload"]
    with torch.no_grad():
        mine = tmoe.moe_denoiser_forward(moe, cfg, _t(p["xm"]), _t(p["tm"]),
                                         capacity_factor=cap).numpy()
    for r in ranks[4]:
        assert r["bank_rows"] == 2
        got = r[("ep", cap, dispatch)]
        print(f"EP {dispatch} (capacity {cap}) vs unsharded: max abs "
              f"{np.abs(got - mine).max():.3g}")
        np.testing.assert_allclose(got, mine, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, case["jax"][("moe", cap)], atol=2e-5,
                                   rtol=2e-5)


def _bank(seed, D, E, M, bias=0.0):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn((D, E), generator=g) * 0.5,
            "w1": torch.randn((E, D, M), generator=g) * 0.1,
            "b1": torch.zeros((E, M)),
            "w2": torch.randn((E, M, D), generator=g) * 0.1,
            "b2": torch.full((E, D), bias)}


@pytest.mark.parametrize("cap", [0.5, 1.25, 4.0])
def test_moe_sorted_dispatch_matches_dense(cap):
    """The sorted dispatch gives the dense one's result (same drops, first
    come first kept), with and without drops; and JAX's moe_mlp's."""
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu.models import moe as jmoe
    p = _bank(0, 32, 4, 64)
    h = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(3))
    dense = tmoe.moe_mlp(p, h, capacity_factor=cap, dispatch="dense")
    ragged = tmoe.moe_mlp(p, h, capacity_factor=cap, dispatch="sorted")
    np.testing.assert_allclose(ragged.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jmoe.moe_mlp({k: jnp.asarray(v.numpy())
                                    for k, v in p.items()},
                                   jnp.asarray(h.numpy()),
                                   capacity_factor=cap, dispatch="dense"))
    print(f"moe_mlp (capacity {cap}) vs JAX: max abs "
          f"{np.abs(dense.numpy() - want).max():.3g}")
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_auto_dispatch_switches_at_scale(monkeypatch):
    """'auto' takes the sorted dispatch once E*C > 8*D (E*C = 64 *
    ceil(1.25*512/64) = 640 > 64 here), the dense one below; both give the
    dense result."""
    sorts = []
    real = torch.argsort
    monkeypatch.setattr(torch, "argsort",
                        lambda *a, **k: sorts.append(1) or real(*a, **k))
    p = _bank(1, 8, 64, 8)
    h = torch.randn((4, 128, 8), generator=torch.Generator().manual_seed(3))
    auto = tmoe.moe_mlp(p, h, dispatch="auto")
    assert sorts
    sorts.clear()
    dense = tmoe.moe_mlp(p, h, dispatch="dense")
    assert not sorts
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    small = _bank(2, 32, 2, 32)
    tmoe.moe_mlp(small, h[:1, :8].repeat(1, 1, 4), dispatch="auto")
    assert not sorts   # E*C = 2 * 5 <= 8*32: dense


def test_moe_keeps_all_tokens_at_full_capacity():
    """capacity_factor = E covers every token on one expert: zero weights
    and a unit bias give every token gate * 1, none zero."""
    p = _bank(0, 8, 2, 32, bias=1.0)
    for k in ("w1", "w2"):
        p[k] = torch.zeros_like(p[k])
    p["router"] = p["router"] * 0.04
    h = torch.randn((1, 16, 8), generator=torch.Generator().manual_seed(1))
    assert bool((tmoe.moe_mlp(p, h, capacity_factor=2.0).abs() > 0).all())


def test_load_balancing_loss_matches_jax():
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu.models import moe as jmoe
    g = torch.Generator().manual_seed(4)
    gates = torch.softmax(torch.randn((64, 8), generator=g), dim=-1)
    expert = gates.argmax(-1)
    got = float(tmoe.load_balancing_loss(gates, expert))
    want = float(jmoe.load_balancing_loss(jnp.asarray(gates.numpy()),
                                          jnp.asarray(expert.numpy())))
    print(f"load-balancing loss {got} (JAX {want})")
    assert abs(got - want) <= 1e-6 * abs(want)
    uniform = torch.full((8, 8), 1 / 8)
    assert abs(float(tmoe.load_balancing_loss(uniform, torch.arange(8))) - 1) \
        < 1e-6
    _, aux = tmoe.moe_mlp(_bank(5, 8, 8, 16), torch.randn((1, 8, 8),
                                                          generator=g),
                          return_aux=True)
    assert float(aux) >= 1.0 - 1e-6


def test_moe_denoiser_params_and_forward():
    cfg = tcfg_mod.DiffusionConfig.tiny(hidden_size=32, num_layers=2,
                                        num_attention_heads=4)
    params = tmoe.init_moe_denoiser_params(torch.Generator().manual_seed(0),
                                           cfg, 4)
    blk = params["blocks"][0]
    assert "mlp" not in blk and blk["moe"]["w1"].shape == (4, 32, 128)
    x = torch.randn((2, 16, 32))
    out = tmoe.moe_denoiser_forward(params, cfg, x, torch.tensor([1, 9]))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
