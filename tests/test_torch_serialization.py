"""Port parity: checkpoints cross between the two packages bit for bit.

A tree with every kind of leaf (f32, bf16, int, `QuantizedTensor`,
`MatmulWeight` with and without `col_scale`, `Fp8Tensor`), nested in dicts
and lists whose keys are not in sorted order, is saved by one package and
loaded by the other; leaf i of the manifest is the i-th leaf in JAX's
flatten order (dict keys sorted, lists in order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu.utils import serialization as jser
from diffusion_llm_rs_tpu_torch.ops import packed_matmul as tpm
from diffusion_llm_rs_tpu_torch.quant import core as tq
from diffusion_llm_rs_tpu_torch.utils import serialization as tser

SPECIAL_J = (jq.QuantizedTensor, jq.Fp8Tensor, jpm.MatmulWeight)


def _arrays():
    rng = np.random.default_rng(0)
    return dict(w=(rng.normal(size=(256, 128)) * 0.02).astype(np.float32),
                odd=(rng.normal(size=(100, 48))).astype(np.float32),
                b=rng.normal(size=(128,)).astype(np.float32),
                i=rng.integers(0, 9, size=(5,)).astype(np.int32))


def _jax_tree():
    a = _arrays()
    w = jnp.asarray(a["w"])
    qt = jq.quantize(w, 4, symmetric=True, granularity="group",
                     group_size=128, axis=0)
    return {
        "zeta": {"w": jpm.prepare(qt), "b": jnp.asarray(a["b"])},
        "alpha": [jq.quantize(jnp.asarray(a["odd"]), 2, granularity="channel",
                              axis=1),
                  jpm.prepare(qt, act_bits=8),
                  jnp.asarray(a["b"]).astype(jnp.bfloat16)],
        "mid": {"f8": jq.quantize_fp8(w), "ids": jnp.asarray(a["i"]),
                "tensor_q": jq.quantize(w, 8, granularity="tensor")},
    }


def _torch_tree():
    a = _arrays()
    w = torch.from_numpy(a["w"])
    qt = tq.quantize(w, 4, symmetric=True, granularity="group",
                     group_size=128, axis=0)
    return {
        "zeta": {"w": tpm.prepare(qt), "b": torch.from_numpy(a["b"])},
        "alpha": [tq.quantize(torch.from_numpy(a["odd"]), 2,
                              granularity="channel", axis=1),
                  tpm.prepare(qt, act_bits=8),
                  torch.from_numpy(a["b"]).to(torch.bfloat16)],
        "mid": {"f8": tq.quantize_fp8(w), "ids": torch.from_numpy(a["i"]),
                "tensor_q": tq.quantize(w, 8, granularity="tensor")},
    }


def _fields(leaf):
    """(static fields, arrays as numpy with fp8/bf16 viewed as integers)."""
    def arr(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.float8_e4m3fn:
                return x.view(torch.uint8).numpy()
            if x.dtype == torch.bfloat16:
                return x.view(torch.int16).numpy().view(np.uint16)
            return x.numpy()
        x = np.asarray(x)
        if x.dtype == jnp.float8_e4m3fn:
            return x.view(np.uint8)
        if x.dtype == jnp.bfloat16:
            return x.view(np.uint16)
        return x

    name = type(leaf).__name__
    if name == "QuantizedTensor":
        return (name, leaf.bits, tuple(leaf.shape), leaf.granularity,
                leaf.group_size, leaf.axis, leaf.symmetric), \
            [arr(leaf.data), arr(leaf.scale), arr(leaf.zero_point)]
    if name == "MatmulWeight":
        return (name, leaf.bits, leaf.K, leaf.N, leaf.group_size,
                leaf.act_bits), \
            [arr(leaf.data), arr(leaf.scale), arr(leaf.zero_point),
             arr(leaf.col_scale)]
    if name == "Fp8Tensor":
        return (name,), [arr(leaf.data), arr(leaf.scale)]
    return ("array",), [arr(leaf)]


def _assert_same(jleaves, tleaves):
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        (js, ja), (ts, ta) = _fields(jl), _fields(tl)
        assert js == ts
        for a, b in zip(ja, ta):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a, b)


def _jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda l: isinstance(l, SPECIAL_J))


def test_the_two_trees_are_the_same_before_any_file():
    _assert_same(_jleaves(_jax_tree()), tq.tree_leaves(_torch_tree()))


def test_checkpoint_saved_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "from_jax")
    jtree = _jax_tree()
    jser.save_checkpoint(path, jtree, metadata={"note": "jax", "n": 3})
    loaded = tser.load_checkpoint(path, like=_torch_tree(), device="cpu")
    _assert_same(_jleaves(jtree), tq.tree_leaves(loaded))
    assert list(loaded) == ["zeta", "alpha", "mid"]      # like's own order
    assert isinstance(loaded["alpha"], list)
    assert loaded["alpha"][1].col_scale is not None
    assert loaded["zeta"]["w"].col_scale is None
    assert tser.get_metadata(path) == {"note": "jax", "n": 3}


def test_checkpoint_saved_by_the_port_loads_in_jax(tmp_path):
    path = str(tmp_path / "from_port")
    ttree = _torch_tree()
    tser.save_checkpoint(path, ttree, metadata={"note": "port"})
    loaded = jser.load_checkpoint(path, like=_jax_tree())
    _assert_same(_jleaves(loaded), tq.tree_leaves(ttree))
    assert jser.get_metadata(path) == {"note": "port"}
    assert loaded["alpha"][2].dtype == jnp.bfloat16


def test_both_packages_write_the_same_files(tmp_path):
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jser.save_checkpoint(jp, _jax_tree(), metadata={"k": 1})
    tser.save_checkpoint(tp, _torch_tree(), metadata={"k": 1})
    jm, tm = (json.load(open(p + ".json")) for p in (jp, tp))
    assert jm["manifest"] == tm["manifest"]
    assert jm["num_leaves"] == tm["num_leaves"] == 8
    assert jm["metadata"] == tm["metadata"]
    jd, td = np.load(jp + ".npz"), np.load(tp + ".npz")
    assert sorted(jd.files) == sorted(td.files)
    for key in jd.files:
        assert jd[key].dtype == td[key].dtype, key
        assert np.array_equal(jd[key], td[key]), key


def test_port_round_trip_and_leaf_count_guard(tmp_path):
    path = str(tmp_path / "rt")
    ttree = _torch_tree()
    tser.save_checkpoint(path, ttree)
    back = tser.load_checkpoint(path, like=ttree, device="cpu")
    _assert_same(tq.tree_leaves(back), tq.tree_leaves(ttree))
    assert tser.get_metadata(path) == {}
    with pytest.raises(ValueError, match="leaves"):
        tser.load_checkpoint(path, like={"only": torch.zeros(1)},
                             device="cpu")


def test_card_layout_int8_weight_saves_and_dequantizes_as_jax(tmp_path):
    """An `Int8Weight` held K-major (its data the transposed view of an
    [N, K] tensor, as on the card) and brought back to the CPU saves, loads
    in JAX and dequantizes to JAX's [K, N] arrays bit for bit."""
    from diffusion_llm_rs_tpu.ops import matmul as jmm
    from diffusion_llm_rs_tpu_torch.ops import matmul as tmm
    rng = np.random.default_rng(5)
    data = rng.integers(-127, 128, size=(48, 20)).astype(np.int8)
    cs = (rng.random((1, 20)) * 1e-2).astype(np.float32)
    kmajor = torch.from_numpy(data).t().contiguous().t()   # the card layout
    assert not kmajor.is_contiguous() and kmajor.t().is_contiguous()
    assert tmm.held_layout(kmajor, "cpu").is_contiguous()
    w = tmm.Int8Weight(kmajor, torch.from_numpy(cs))
    assert w.data.is_contiguous() and torch.equal(w.data, kmajor)
    # a weight whose data came back from the card as the view, unchanged
    back = tmm.Int8Weight(torch.from_numpy(data), torch.from_numpy(cs))
    object.__setattr__(back, "data", kmajor)
    jw = jmm.Int8Weight(jnp.asarray(data), jnp.asarray(cs))
    assert np.array_equal(back.dequantize().numpy(),
                          np.asarray(jw.dequantize()))
    assert back.to("cpu").data.is_contiguous()
    tree_t = {"w": back, "b": torch.from_numpy(cs[0])}
    tree_j = {"w": jw, "b": jnp.asarray(cs[0])}
    tser.save_checkpoint(str(tmp_path / "t"), tree_t)
    # JAX cannot serialize the tree structure of an Int8Weight; it writes
    # the same arrays for its two leaves in flatten order
    jser.save_checkpoint(str(tmp_path / "j"), {
        "w": [jw.data, jw.col_scale], "b": jnp.asarray(cs[0])})
    zt, zj = np.load(str(tmp_path / "t.npz")), np.load(str(tmp_path / "j.npz"))
    assert sorted(zt.files) == sorted(zj.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k])
    loaded = jser.load_checkpoint(str(tmp_path / "t"), like=tree_j)
    assert np.array_equal(np.asarray(loaded["w"].data), data)
    mine = tser.load_checkpoint(str(tmp_path / "j"), like=tree_t,
                                device="cpu")
    assert isinstance(mine["w"], tmm.Int8Weight)
    assert torch.equal(mine["w"].data, torch.from_numpy(data))
    assert torch.equal(mine["w"].col_scale, torch.from_numpy(cs))
