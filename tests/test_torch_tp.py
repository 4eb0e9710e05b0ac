"""Port parity: Megatron tensor parallelism (`parallel/tp.py`) against the
JAX package, on the CPU.

The shards `shard_tp_params` makes are held against JAX's bit for bit. The
TP forward runs in 2 and 4 processes joined by gloo (`_torch_dist.spawn`,
once per world size for the file) at meshes (1, 2), (2, 2) and (4, 1), over
f32, packed int4 (act 16 and act 8) and decoded int8 weights, and is held
against JAX's `make_tp_forward` on its virtual CPU devices and against the
port's single-process forward. The children import no JAX: this file
imports it inside its fixtures and tests. `pytest -rP` prints each measured
difference.
"""

import numpy as np
import pytest
import torch

from _torch_dist import export, rel, spawn
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.parallel import mesh as tpm_mesh
from diffusion_llm_rs_tpu_torch.parallel import tp as ttp
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare as prepare_t
from diffusion_llm_rs_tpu_torch.ops.matmul import (decode_to_int8 as
                                                   decode_to_int8_t)
from diffusion_llm_rs_tpu_torch.quant.core import QuantizedTensor as QT
from diffusion_llm_rs_tpu_torch.quant.core import map_leaves
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

MESHES = {4: [(2, 2), (4, 1)], 2: [(1, 2)]}
KINDS = ("fp", "int4", "int4_a8", "int8")


def _tp_worker(rank, world, payload):
    """Every kind's TP forward at each of this world's meshes."""
    cfg = tcfg_mod.diffusion_config_from_json(payload["cfg"])
    x, t = torch.from_numpy(payload["x"]), torch.from_numpy(payload["t"])
    out = {}
    for shape in MESHES[world]:
        mesh = tpm_mesh.make_mesh(shape, device="cpu")
        fwd = ttp.make_tp_forward(cfg, mesh)
        for kind in KINDS:
            local = ttp.place_tp_params(
                from_jax_params(payload[kind], device="cpu"), mesh)
            out[(shape, kind)] = fwd(local, x, t).numpy()
    return out


@pytest.fixture(scope="module")
def case():
    """JAX's tiny TP model (width 64, 4 heads) in four weight layouts, the
    inputs, and JAX's TP forward at every mesh for the fp and int4 trees."""
    import jax
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu import config as jcfg_mod
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu.ops.pallas_matmul import prepare
    from diffusion_llm_rs_tpu.parallel import mesh as jpm
    from diffusion_llm_rs_tpu.parallel import tp as jtp
    from diffusion_llm_rs_tpu.quant.core import QuantizedTensor, quantize_tree

    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=64, num_attention_heads=4,
                                         vocab_size=256)
    params = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    qp = quantize_tree(params, 4, symmetric=True, granularity="group",
                       group_size=32, axis=0, min_size=512)

    def prep(fn):
        return jax.tree_util.tree_map(
            lambda l: fn(l) if isinstance(l, QuantizedTensor) and l.ndim == 2
            else l, qp, is_leaf=lambda l: isinstance(l, QuantizedTensor))

    trees = {"fp": params, "int4": prep(prepare)}
    exported = {k: export(v) for k, v in trees.items()}
    # the act-8 and decoded layouts made by the port from JAX's quantized
    # tree (the port's `prepare` and `decode_to_int8` equal JAX's bit for
    # bit: test_torch_packed_matmul.py)
    tq = from_jax_params(export(qp), device="cpu")
    for kind, fn in (("int4_a8", lambda l: prepare_t(l, act_bits=8)),
                     ("int8", lambda l: decode_to_int8_t(
                         prepare_t(l, act_bits=8)))):
        exported[kind] = _export_port(map_leaves(
            lambda _, l: fn(l) if isinstance(l, QT) and l.ndim == 2 else l,
            tq))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    t = np.array([1, 5], np.int64)
    jax_out = {}
    for shape in MESHES[4] + MESHES[2]:
        devices = jax.devices()[:shape[0] * shape[1]]
        mesh = jpm.make_mesh(shape, devices=devices)
        fwd = jtp.make_tp_forward(jcfg, mesh)
        for kind in ("fp", "int4"):
            jax_out[(shape, kind)] = np.asarray(fwd(
                jtp.place_tp_params(trees[kind], mesh), jnp.asarray(x),
                jnp.asarray(t)))
    payload = dict(cfg=jcfg_mod.to_json(jcfg), x=x, t=t, **exported)
    return dict(payload=payload, jax_out=jax_out, jax_trees=trees)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Every rank's TP forward results, world 4 and world 2."""
    out = {}
    for world in (4, 2):
        results = spawn(_tp_worker, world, case["payload"],
                        tmp_path_factory.mktemp(f"tp{world}"))
        for r in results:
            assert not r.pop("jax_loaded"), "a rank imported JAX"
        for key in results[0]:
            # every rank of a TP group returns the replicated output
            for r in results[1:]:
                np.testing.assert_array_equal(r[key], results[0][key])
        out.update(results[0])
    return out


def _export_port(tree):
    """A port tree -> numpy leaves in `from_jax_params`' form."""
    if isinstance(tree, dict):
        return {k: _export_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_export_port(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return {f: (getattr(tree, f).numpy()
                if isinstance(getattr(tree, f), torch.Tensor)
                else getattr(tree, f)) for f in tree.__dataclass_fields__}


def _single(case, kind):
    p = case["payload"]
    cfg = tcfg_mod.diffusion_config_from_json(p["cfg"])
    with torch.no_grad():
        return tdn.denoiser_forward(from_jax_params(p[kind], device="cpu"),
                                    cfg, torch.from_numpy(p["x"]),
                                    torch.from_numpy(p["t"])).numpy()


ALL_MESHES = MESHES[4] + MESHES[2]


@pytest.mark.parametrize("shape", ALL_MESHES, ids=str)
@pytest.mark.parametrize("kind", ["fp", "int4"])
def test_tp_forward_matches_jax(case, ranks, shape, kind):
    """The port's TP forward against JAX's `make_tp_forward` at the same
    mesh, both f32 (measured 1.2e-7 relative over f32 weights, 3.8e-8 over
    int4, whose shards are JAX's bit for bit and whose products both sides
    take from bf16-rounded x and W): relative 1e-5."""
    got, want = ranks[(shape, kind)], case["jax_out"][(shape, kind)]
    r = rel(got, want)
    print(f"TP {shape} {kind} vs JAX: rel {r:.3g}")
    assert got.shape == want.shape
    assert r <= 1e-5


@pytest.mark.parametrize("shape", ALL_MESHES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_tp_forward_matches_single_process(case, ranks, shape, kind):
    """Against the port's `denoiser_forward` in one process on the unsplit
    tree. At tp = 1 the forward is the single one, bit for bit, over f32 and
    packed weights (decoded int8: the single forward fuses the MLP and the
    wo residual into the int8 kernels, TP runs them apart; relative 1e-2).
    At tp > 1: fp within 1e-5 (the all_reduce's order); int4 within 1e-5
    (measured 0: the groups align at tp = 2); int8 activations (act 8 and
    decoded int8) are quantized per rank's slice of each row, so within
    1e-2 (measured 2.5e-3; JAX's own TP test allows 5e-2)."""
    got, want = ranks[(shape, kind)], _single(case, kind)
    r = rel(got, want)
    print(f"TP {shape} {kind} vs the single-process forward: rel {r:.3g}")
    if shape[1] == 1 and kind != "int8":
        np.testing.assert_array_equal(got, want)
    elif kind in ("fp", "int4"):
        assert r <= 1e-5
    else:
        assert r <= 1e-2


def _np_leaves(tree):
    from diffusion_llm_rs_tpu_torch.quant.core import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.numpy())
        else:  # a quantized layout: its arrays in JAX's field order
            out.extend(getattr(leaf, f).numpy() for f in
                       ("data", "scale", "zero_point", "col_scale")
                       if getattr(leaf, f, None) is not None)
    return out


@pytest.mark.parametrize("kind", ["fp", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_tp_params_equal_jax_bit_for_bit(case, kind, tp):
    """Every leaf of every shard: levels (packed data), scales, zero points,
    column scales; at tp = 4 wo's K = 16 rows cut its groups of 32 and are
    requantized at group 16 on both sides."""
    import jax
    from diffusion_llm_rs_tpu.parallel import tp as jtp
    jshards = jtp.shard_tp_params(case["jax_trees"][kind], tp)
    tshards = ttp.shard_tp_params(
        from_jax_params(case["payload"][kind], device="cpu"), tp)
    for js, ts in zip(jshards, tshards):
        jl = [np.asarray(l) for l in jax.tree_util.tree_leaves(js)]
        tl = _np_leaves(ts)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b)
    wo = tshards[0]["blocks"][0]["attn"]["wo"]
    if kind != "fp":
        assert wo.group_size == (16 if tp == 4 else 32)


@pytest.mark.parametrize("K,N,group,tp", [(96, 32, 32, 2), (768, 64, 128, 4)])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_split_weight_straddling_groups_equals_jax(K, N, group, tp, act_bits):
    """A row split whose shards cut the groups requantizes at gcd(group,
    K/tp) (16; 64 at the full-width model's wo at tp = 4) exactly as JAX
    does, and keeps act_bits."""
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu.ops.pallas_matmul import prepare as jprepare
    from diffusion_llm_rs_tpu.parallel import tp as jtp
    from diffusion_llm_rs_tpu.quant.core import quantize as jquantize
    w = np.random.default_rng(K).normal(size=(K, N)).astype(np.float32)
    jw = jprepare(jquantize(jnp.asarray(w), 4, granularity="group",
                            group_size=group, axis=0), act_bits=act_bits)
    tw = from_jax_params(export(jw), device="cpu")
    for idx in range(tp):
        j = jtp._split_weight(jw, 0, tp, idx)
        t = ttp._split_weight(tw, 0, tp, idx)
        assert t.group_size == j.group_size == np.gcd(group, K // tp)
        assert t.act_bits == act_bits and t.K == K // tp
        assert (t.col_scale is None) == (act_bits == 16)
        fields = ("data", "scale", "zero_point", "col_scale")
        for f in fields[:4 - (act_bits == 16)]:
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy())


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("tp", [2, 4])
def test_column_and_qkv_shards_equal_jax(act_bits, tp):
    """Column shards and fused-QKV shards (each third split) of a packed
    weight, at act 16 and act 8: data and sidecars as JAX's, bit for bit."""
    import jax.numpy as jnp
    from diffusion_llm_rs_tpu.ops.pallas_matmul import prepare as jprepare
    from diffusion_llm_rs_tpu.parallel import tp as jtp
    from diffusion_llm_rs_tpu.quant.core import quantize as jquantize
    w = np.random.default_rng(7).normal(size=(64, 96)).astype(np.float32)
    jw = jprepare(jquantize(jnp.asarray(w), 4, granularity="group",
                            group_size=32, axis=0), act_bits=act_bits)
    tw = from_jax_params(export(jw), device="cpu")
    for idx in range(tp):
        for j, t in ((jtp._split_weight(jw, 1, tp, idx),
                      ttp._split_weight(tw, 1, tp, idx)),
                     (jtp._split_wqkv(jw, tp, idx),
                      ttp._split_wqkv(tw, tp, idx))):
            assert (t.K, t.N, t.act_bits) == (j.K, j.N, j.act_bits)
            for f in ("data", "scale", "zero_point", "col_scale"):
                if getattr(j, f) is None:
                    assert getattr(t, f) is None
                else:
                    np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                                  getattr(t, f).numpy())


def test_split_weight_preserves_a8_mode():
    """Column, row and fused-QKV shards keep act_bits = 8 and the right
    column scales."""
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.quant.core import quantize
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 96))
                         .astype(np.float32))
    mw = prepare(quantize(w, 4, granularity="group", group_size=32, axis=0),
                 act_bits=8)
    col = ttp._split_weight(mw, 1, 2, 1)
    assert col.act_bits == 8 and col.col_scale.shape == (1, 48)
    assert torch.equal(col.col_scale, mw.col_scale[:, 48:])
    row = ttp._split_weight(mw, 0, 2, 0)
    assert row.act_bits == 8 and torch.equal(row.col_scale, mw.col_scale)
    qkv = ttp._split_wqkv(mw, 2, 0)   # 96 = 3 x 32 -> thirds of 16
    assert qkv.act_bits == 8 and qkv.col_scale.shape == (1, 48)
    assert torch.equal(qkv.col_scale, torch.cat(
        [mw.col_scale[:, s:s + 16] for s in (0, 32, 64)], dim=1))


def test_int8_weight_shards_keep_their_column_grid():
    """A decoded Int8Weight splits its data; a column shard takes its
    columns' scales, a row shard keeps every column's (JAX slices the
    [1, N] scales along rows to [0, N] there: ROADMAP C35)."""
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
    from diffusion_llm_rs_tpu_torch.quant.core import quantize
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 48))
                         .astype(np.float32))
    iw = decode_to_int8(prepare(quantize(w, 4, granularity="group",
                                         group_size=32, axis=0), act_bits=8))
    rows = [ttp._split_weight(iw, 0, 2, i) for i in range(2)]
    cols = [ttp._split_weight(iw, 1, 2, i) for i in range(2)]
    assert torch.equal(torch.cat([r.data for r in rows]), iw.data)
    assert all(torch.equal(r.col_scale, iw.col_scale) for r in rows)
    assert torch.equal(torch.cat([c.data for c in cols], 1), iw.data)
    assert torch.equal(torch.cat([c.col_scale for c in cols], 1), iw.col_scale)


def test_shard_tp_params_rejects_raw_quantized_tensor():
    from diffusion_llm_rs_tpu_torch.quant.core import quantize_tree
    cfg = tcfg_mod.DiffusionConfig.tiny()
    params = tdn.init_denoiser_params(torch.Generator().manual_seed(0), cfg)
    qp = quantize_tree(params, 4, symmetric=True, granularity="group",
                       group_size=32, axis=0)
    with pytest.raises(TypeError, match="prepare"):
        ttp.shard_tp_params(qp, 2)


def test_tp_forward_rejects_nondividing_heads():
    cfg = tcfg_mod.DiffusionConfig.tiny(num_attention_heads=4)
    params = tdn.init_denoiser_params(torch.Generator().manual_seed(0), cfg)
    local = ttp.shard_tp_params(params, 2)[0]
    x = torch.zeros((1, 8, cfg.hidden_size))
    t = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(ValueError, match="divisible"):
        ttp.tp_denoiser_forward(local, cfg, x, t, tp=3)
