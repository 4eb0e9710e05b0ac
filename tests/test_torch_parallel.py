"""Port parity: process meshes, sharding rules and the sharded steps
(`parallel/mesh.py`) against the JAX package, on the CPU.

The ranks run in 4 processes joined by gloo (`_torch_dist.spawn`, once for
the file) on a (2, 2) ('data', 'model') mesh; JAX runs the same on a (2, 2)
mesh of its virtual CPU devices. Each rank's leaves are held against the
shard JAX places on the device at the same mesh coordinate, the sharded
infer step and the train step's losses against JAX's, the sample step
against the port's single-process sampler, and the train step against a
single-process SGD step. The children import no JAX. `pytest -rP` prints
each measured difference.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import export, rel, spawn
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         p_losses, sample)
from diffusion_llm_rs_tpu_torch.parallel import mesh as pm
from diffusion_llm_rs_tpu_torch.quant.core import map_leaves, quantize
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

STEPS = 6   # train steps on a fixed batch
LR = 1e-2


def _flat(tree):
    """{path: numpy} of a port tree (a quantized leaf by its fields)."""
    out = {}

    def put(path, leaf):
        key = "/".join(path)
        if isinstance(leaf, torch.Tensor):
            out[key] = leaf.detach().numpy()
        else:
            for f in ("data", "scale", "zero_point"):
                out[f"{key}/{f}"] = getattr(leaf, f).numpy()
        return leaf

    map_leaves(put, tree)
    return out


def _sgd_single(params, cfg, schedule, x0, t, noise):
    """One SGD step of the global batch mean in one process."""
    leaves = []

    def mark(_, l):
        l = l.detach().requires_grad_()
        leaves.append(l)
        return l

    live = map_leaves(mark, params)
    loss = p_losses(lambda x, tt: tdn.denoiser_forward(
        live, cfg, x, tt, flash_attn=False), schedule, x0, t, noise).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(zip(leaves, grads))

    def step(_, l):
        p, g = next(it)
        return p.detach() if g is None else (p - LR * g).detach()

    return map_leaves(step, live), float(loss)


def _mesh_worker(rank, world, payload):
    cfg = tcfg_mod.diffusion_config_from_json(payload["cfg"])
    params = from_jax_params(payload["params"], device="cpu")
    out = {"default_shape": pm.make_mesh(device="cpu").shape}
    try:
        pm.make_mesh((3, 2), device="cpu")
    except ValueError:
        out["bad_shape_raises"] = True
    mesh = pm.make_mesh((2, 2), device="cpu")
    out["coord"] = (mesh.index("data"), mesh.index("model"))

    out["leaves"] = _flat(pm.shard_params(params, mesh))
    qt = quantize(torch.ones((256, 64)), 4, granularity="group",
                  group_size=128, axis=0)
    sq = pm.shard_params({"blocks": [{"attn": {"wq": qt}}]},
                         mesh)["blocks"][0]["attn"]["wq"]
    out["qt"] = dict(data=tuple(sq.data.shape), scale=tuple(sq.scale.shape),
                     shape=sq.shape, deq=sq.dequantize().numpy())

    x, t = torch.from_numpy(payload["x"]), torch.from_numpy(payload["t"])
    local = pm.shard_params(params, mesh)
    eps = pm.make_sharded_infer_step(cfg, mesh)(
        local, pm.shard_batch(x, mesh), pm.shard_batch(t, mesh))
    out["eps_local_shape"] = tuple(eps.shape)
    out["eps"] = pm.gather_batch(eps, mesh).numpy()

    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cpu")
    for shape in ((4, 1), (2, 2)):
        m = pm.make_mesh(shape, device="cpu")
        run = pm.make_sharded_sample_step(cfg, m, schedule)
        xs = run(pm.shard_params(params, m), torch.Generator().manual_seed(3),
                 batch=4, seq_len=8, num_steps=3)
        out[("sample", shape)] = pm.gather_batch(xs, m).numpy()

    x0, tt = torch.from_numpy(payload["x0"]), torch.from_numpy(payload["tt"])
    noise = torch.from_numpy(payload["noise"])
    train = pm.make_sharded_train_step(cfg, mesh, schedule, lr=LR)
    p, losses = local, []
    for i in range(STEPS):
        p, loss = train(p, pm.shard_batch(x0, mesh), pm.shard_batch(tt, mesh),
                        pm.shard_batch(noise, mesh))
        losses.append(float(loss))
        if i == 0:
            ref, ref_loss = _sgd_single(params, cfg, schedule, x0, tt, noise)
            want = _flat(pm.shard_params(ref, mesh))
            got = _flat(p)
            out["step_vs_single"] = max(
                float(np.abs(got[k] - want[k]).max()) for k in want)
            out["loss_single"] = ref_loss
    out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def case():
    """JAX's tiny model (width 64, 4 heads, 20 timesteps), inputs, and JAX's
    shards, infer step and train losses on a (2, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu import config as jcfg_mod
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu.models.diffusion import DiffusionSchedule as JS
    from diffusion_llm_rs_tpu.parallel import mesh as jpm

    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=64, num_attention_heads=4,
                                         num_timesteps=20)
    params = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    mesh = jpm.make_mesh((2, 2), devices=jax.devices()[:4])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 64)).astype(np.float32)
    t = np.array([0, 3, 7, 19], np.int64)
    x0 = rng.normal(size=(8, 8, 64)).astype(np.float32)
    tt = rng.integers(0, 20, size=(8,)).astype(np.int64)
    noise = rng.normal(size=(8, 8, 64)).astype(np.float32)

    sharded = jpm.shard_params(params, mesh)
    # JAX's shard of every leaf on the device at each mesh coordinate
    shards = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(sharded):
        key = jpm._path_str(path)
        for s in leaf.addressable_shards:
            coord = tuple(int(c[0]) for c in np.nonzero(
                mesh.devices == s.device))
            shards[(coord, key)] = np.asarray(s.data)
    with mesh:
        eps = np.asarray(jpm.make_sharded_infer_step(jcfg, mesh)(
            sharded, jpm.shard_batch(jnp.asarray(x), mesh),
            jpm.shard_batch(jnp.asarray(t), mesh)))
        train = jpm.make_sharded_train_step(jcfg, mesh, JS.create(20), lr=LR)
        p, losses = sharded, []
        b = [jpm.shard_batch(jnp.asarray(a), mesh) for a in (x0, tt, noise)]
        for _ in range(STEPS):
            p, loss = train(p, *b)
            losses.append(float(loss))
    payload = dict(cfg=jcfg_mod.to_json(jcfg), params=export(params), x=x,
                   t=t, x0=x0, tt=tt, noise=noise)
    return dict(payload=payload, shards=shards, eps=eps, losses=losses,
                jax_params=params)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    results = spawn(_mesh_worker, 4, case["payload"],
                    tmp_path_factory.mktemp("mesh4"))
    for r in results:
        assert not r.pop("jax_loaded"), "a rank imported JAX"
    return results


def test_make_mesh_shape(ranks):
    """Four processes split (2, 2) by default, JAX's pow-2 rule; a shape
    that is not the world raises; every coordinate is taken once."""
    import jax
    from diffusion_llm_rs_tpu.parallel import mesh as jpm
    want = dict(jpm.make_mesh(devices=jax.devices()[:4]).shape)
    for r in ranks:
        assert r["default_shape"] == want == {"data": 2, "model": 2}
        assert r["bad_shape_raises"]
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    with pytest.raises(ValueError):
        pm.make_mesh((3, 2), device="cpu")


def test_spec_rules_equal_jax():
    from diffusion_llm_rs_tpu.parallel import mesh as jpm
    paths = ["tok_embed", "pos_embed", "blocks/0/attn/wqkv",
             "blocks/3/attn/wo", "blocks/1/attn/wq", "blocks/1/mlp/w1",
             "blocks/1/mlp/b1", "blocks/1/mlp/w2", "blocks/1/mlp/b2",
             "time_mlp/w1", "time_mlp/b1", "time_mlp/w2", "head/w",
             "blocks/0/ln1/scale", "ln_f/bias"]
    for p in paths:
        assert pm.spec_for_path(p) == tuple(jpm.spec_for_path(p)), p
    assert pm.spec_for_path("blocks/0/attn/wqkv") == (None, "model")
    assert pm.spec_for_path("blocks/0/ln1/scale") == ()


def test_shard_params_equal_jax_shards(case, ranks):
    """Each rank's leaves equal the shard JAX places on the device at the
    same coordinate, bit for bit; the fused QKV is the exception by design:
    a rank takes its columns of each of Q, K and V (whole heads, as
    `tp._split_wqkv`), GSPMD one block of columns."""
    from diffusion_llm_rs_tpu.parallel import tp as jtp
    n = 0
    for r in ranks:
        d, m = r["coord"]
        for key, got in r["leaves"].items():
            if key.endswith("attn/wqkv"):
                li = int(key.split("/")[1])
                want = np.asarray(jtp._split_wqkv(
                    case["jax_params"]["blocks"][li]["attn"]["wqkv"], 2, m))
            else:
                want = case["shards"][((d, m), key)]
            np.testing.assert_array_equal(got, want, err_msg=key)
            n += 1
    assert n == 4 * len(ranks[0]["leaves"])
    wqkv = ranks[0]["leaves"]["blocks/0/attn/wqkv"]
    assert wqkv.shape == (64, 192 // 2)
    assert ranks[0]["leaves"]["blocks/0/attn/wo"].shape == (32, 64)


def test_shard_quantized_weight(ranks):
    """Packed data split like the fp weight (columns over 'model'), the
    group sidecars [n_groups, N] with it; each shard dequantizes to its
    columns of the weight."""
    for r in ranks:
        q = r["qt"]
        assert q["data"] == (256, 64 // 2 // 2) and q["scale"] == (2, 32)
        assert q["shape"] == (256, 32)
        np.testing.assert_allclose(q["deq"], np.ones((256, 32)), atol=0.1)


def test_sharded_infer_step_matches_jax(case, ranks):
    """Batch over 'data' (2 rows a rank), TP over 'model', the einsum
    attention on both sides, f32: relative 1e-5 (measured near 1e-7)."""
    for r in ranks:
        assert r["eps_local_shape"] == (2, 8, 64)
        e = rel(r["eps"], case["eps"])
        print(f"sharded infer step vs JAX: rel {e:.3g}")
        assert e <= 1e-5


def test_sharded_sample_step(case, ranks):
    """Every rank draws the whole batch's noise and keeps its rows, so the
    gathered sample follows the single-process `sample` from the same
    generator: within 1e-5 relative at (4, 1) and (2, 2). Not bit for bit:
    a rank's GEMMs take 1 or 2 of the 4 rows, and the CPU's GEMM sums
    another row count in another order (measured near 1e-7)."""
    p = case["payload"]
    cfg = tcfg_mod.diffusion_config_from_json(p["cfg"])
    params = from_jax_params(p["params"], device="cpu")
    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cpu")
    with torch.no_grad():
        want = sample(lambda x, t: tdn.denoiser_forward(
            params, cfg, x, t, flash_attn=False), schedule, (4, 8, 64),
            torch.Generator().manual_seed(3), num_steps=3).numpy()
    for r in ranks:
        for shape in ((4, 1), (2, 2)):
            got = r[("sample", shape)]
            e = rel(got, want)
            print(f"sharded sample {shape} vs single-process: rel {e:.3g}")
            assert got.shape == want.shape and np.isfinite(got).all()
            assert e <= 1e-5


def test_sharded_train_step(case, ranks):
    """The first step's parameters equal a single-process SGD step on the
    whole batch within 1e-6 (absolute, on leaves near 0.02): the gradient
    is the global batch mean, counted once across 'model'. The losses
    equal JAX's step by step within 1e-5 relative and fall."""
    for r in ranks:
        print(f"train step: params vs single-process max abs "
              f"{r['step_vs_single']:.3g}; losses {r['losses']}; JAX "
              f"{case['losses']}")
        assert r["step_vs_single"] <= 1e-6
        assert abs(r["losses"][0] - r["loss_single"]) \
            <= 1e-5 * r["loss_single"]
        np.testing.assert_allclose(r["losses"], case["losses"], rtol=1e-5)
        assert r["losses"][-1] < r["losses"][0]


def test_parallel_modules_import_without_jax():
    """The parallel stack and the MoE model import in a process where
    neither JAX nor the JAX package can be imported at all."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'diffusion_llm_rs_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import diffusion_llm_rs_tpu_torch.parallel.mesh\n"
        "import diffusion_llm_rs_tpu_torch.parallel.tp\n"
        "import diffusion_llm_rs_tpu_torch.parallel.serving\n"
        "import diffusion_llm_rs_tpu_torch.parallel.sp\n"
        "import diffusion_llm_rs_tpu_torch.parallel.pp\n"
        "import diffusion_llm_rs_tpu_torch.models.moe\n"
        "print('ok')\n")
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_initialize_distributed_is_a_noop_on_one_process():
    pm.initialize_distributed()
    pm.initialize_distributed(world_size=1)
    assert not torch.distributed.is_initialized()
    mesh = pm.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("model") is None
