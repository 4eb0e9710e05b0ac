"""Port parity: the transformer denoiser and the sampler slice end to end.

At DiffusionConfig.tiny(hidden_size=128, num_attention_heads=4), B=8, S=16,
the JAX parameters (exported as numpy) drive both packages in two weight
modes: fp32, and W4A8 decoded (int4 symmetric g128 -> prepare(act_bits=8)
-> decode_to_int8, quantized independently in each package). Width 128 and
not tiny's 64: at 64 the JAX Pallas wrappers refuse N=64 and N=192 and take
their XLA fallback.

In the W4A8 mode the JAX side runs its Pallas kernels in interpret mode
(`use_pallas` patched to True), which is the arithmetic the port follows: x
rounded to bf16 before the act-quant and the residual added in f32. Without
the patch JAX's CPU fallback quantizes from f32; the port stays within one
act-quant level of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu.models import diffusion as jd
from diffusion_llm_rs_tpu.ops import matmul as jmm
from diffusion_llm_rs_tpu.ops import pallas_attention as jpa
from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.models import diffusion as td
from diffusion_llm_rs_tpu_torch.ops import attention as tat
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as tim
from diffusion_llm_rs_tpu_torch.ops import matmul as tmm
from diffusion_llm_rs_tpu_torch.quant import core as tq
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

B, S, STEPS = 8, 16, 3


def _configs():
    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=128, num_attention_heads=4)
    tcfg = tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))
    return jcfg, tcfg


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: ({"data": np.array(l.data), "col_scale": np.array(l.col_scale)}
                   if isinstance(l, jmm.Int8Weight) else np.array(l)),
        tree, is_leaf=lambda l: isinstance(l, jmm.Int8Weight))


def _j_w4a8(params):
    q = jq.quantize_tree(params, 4, symmetric=True, granularity="group",
                         group_size=128, axis=0)
    return jax.tree_util.tree_map(
        lambda l: (jmm.decode_to_int8(jpm.prepare(l, act_bits=8))
                   if isinstance(l, jq.QuantizedTensor) and l.ndim == 2 else l),
        q, is_leaf=lambda l: isinstance(l, jq.QuantizedTensor))


def _t_w4a8(params):
    q = tq.quantize_tree(params, 4, symmetric=True, granularity="group",
                         group_size=128, axis=0)

    def prep(t):
        if isinstance(t, dict):
            return {k: prep(v) for k, v in t.items()}
        if isinstance(t, list):
            return [prep(v) for v in t]
        if isinstance(t, tq.QuantizedTensor) and t.ndim == 2:
            return tmm.decode_to_int8(tim.prepare(t, act_bits=8))
        return t
    return prep(q)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(_to_numpy(jparams), device="cpu")
    jq8 = _j_w4a8(jparams)
    tq8 = _t_w4a8(tparams)
    return dict(jcfg=jcfg, tcfg=tcfg, fp32=(jparams, tparams), w4a8=(jq8, tq8))


@pytest.fixture
def pallas_on(monkeypatch):
    """JAX runs its Pallas kernels (interpret mode on the CPU); records
    whether each int8w_matmul / int8w_mlp call took the kernel."""
    took = []
    mm, mlp = jpm.int8w_matmul, jpm.int8w_mlp

    def rec(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            took.append(out is not None)
            return out
        return call
    monkeypatch.setattr(jmm, "use_pallas", lambda: True)
    monkeypatch.setattr(jpm, "int8w_matmul", rec(mm))
    monkeypatch.setattr(jpm, "int8w_mlp", rec(mlp))
    return took


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    t = rng.integers(0, 50, size=(B,)).astype(np.int32)
    return x, t


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_w4a8_weights_quantized_in_the_port_match_jax(models):
    jq8, tq8 = models["w4a8"]
    jflat = jax.tree_util.tree_leaves_with_path(
        jq8, is_leaf=lambda l: isinstance(l, jmm.Int8Weight))
    n = 0
    for path, leaf in jflat:
        t = tq8
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        if isinstance(leaf, jmm.Int8Weight):
            assert isinstance(t, tmm.Int8Weight)
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(leaf.data))
            np.testing.assert_array_equal(t.col_scale.numpy(),
                                          np.asarray(leaf.col_scale))
            n += 1
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert n == 3 + 4 * 2 + 1  # time MLP x2, head, tok_embed; 4 per block


def test_forward_fp32_matches(models):
    jparams, tparams = models["fp32"]
    x, t = _inputs()
    jeps, (jk, jv), jh = jdn.denoiser_forward(
        jparams, models["jcfg"], jnp.asarray(x), jnp.asarray(t),
        return_kv=True, return_hidden=True)
    teps, (tk, tv), th = tdn.denoiser_forward(
        tparams, models["tcfg"], torch.from_numpy(x), torch.from_numpy(t),
        return_kv=True, return_hidden=True)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    assert tuple(tk.shape) == (2, B, S, 4, 32)
    # padding mask over the last positions of half the batch
    keep = np.ones((B, S), np.float32)
    keep[::2, S - 5:] = 0.0
    jm = jdn.denoiser_forward(jparams, models["jcfg"], jnp.asarray(x),
                              jnp.asarray(t), attn_mask=jnp.asarray(keep))
    tm = tdn.denoiser_forward(tparams, models["tcfg"], torch.from_numpy(x),
                              torch.from_numpy(t),
                              attn_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-5)
    # the cache replaces this step's K/V: its own K/V give the same eps
    tc = tdn.denoiser_forward(tparams, models["tcfg"], torch.from_numpy(x),
                              torch.from_numpy(t), cached_kv=(tk, tv))
    assert torch.equal(tc, teps)
    # a tap only watches: the same eps with one
    tt = tdn.denoiser_forward(tparams, models["tcfg"], torch.from_numpy(x),
                              torch.from_numpy(t), tap=lambda name, val: None)
    assert torch.equal(tt, teps)


def test_forward_w4a8_matches_pallas_kernels(models, pallas_on):
    jq8, tq8 = models["w4a8"]
    x, t = _inputs(1)
    jeps = jdn.denoiser_forward(jq8, models["jcfg"], jnp.asarray(x),
                                jnp.asarray(t))
    assert pallas_on and all(pallas_on), pallas_on  # 7 linears + 2 MLPs
    assert len(pallas_on) == 9
    teps = tdn.denoiser_forward(tq8, models["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(t))
    # same int8 products and epilogue; but the two frameworks' f32
    # layer-norm and attention sums differ by ~1e-4 relative (measured), and
    # each act-quant rounds such a difference to a whole level now and then,
    # which puts ~1e-3 on eps: bound 5e-3
    assert _rel(teps.numpy(), jeps) < 5e-3


def _tapped(forward, params, cfg, x, t):
    seen = []
    forward(params, cfg, x, t, tap=lambda name, v: seen.append(
        (name, np.array(v, dtype=np.float32))))
    return seen


@pytest.mark.parametrize("mode", ["fp32", "w4a8"])
def test_tap_sees_jax_names_and_inputs(models, pallas_on, mode, monkeypatch):
    """The calibration tap: the input of every linear, under JAX's name, in
    JAX's order (time MLP, then per block wqkv, wo, mlp/w1, mlp/w2, then the
    head), with JAX's values. With a tap the W4A8 MLP takes its two
    linears, as JAX's does, so the inner activation is seen: the fused MLP
    must not run. fp32 within 1e-4 relative; W4A8 within 5e-3 (the act-quant
    amplification of test_forward_w4a8_matches_pallas_kernels)."""
    jp, tp = models[mode]
    x, t = _inputs(3)
    want = _tapped(jdn.denoiser_forward, jp, models["jcfg"], jnp.asarray(x),
                   jnp.asarray(t))

    def no_fused_mlp(*a, **k):
        raise AssertionError("the fused MLP ran under a tap")
    monkeypatch.setattr(tdn, "int8_mlp", no_fused_mlp)
    got = _tapped(tdn.denoiser_forward, tp, models["tcfg"],
                  torch.from_numpy(x), torch.from_numpy(t))
    L = models["tcfg"].num_layers
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 2 + 4 * L + 1
    assert got[-1][0] == "head/w" and got[2][0] == "blocks/0/attn/wqkv"
    bound = 1e-4 if mode == "fp32" else 5e-3
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < bound, (name, _rel(a, b))


def test_forward_w4a8_near_jax_cpu_fallback(models):
    jq8, tq8 = models["w4a8"]
    x, t = _inputs(2)
    jeps = jdn.denoiser_forward(jq8, models["jcfg"], jnp.asarray(x),
                                jnp.asarray(t))
    teps = tdn.denoiser_forward(tq8, models["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(t))
    # the fallback quantizes activations from f32, the port from bf16: one
    # act-quant level (the bound of tests/test_pallas_matmul.py)
    assert _rel(teps.numpy(), jeps) < 2e-2


def _replayed_sample(jparams, tparams, jcfg, tcfg, shape=None, steps=STEPS):
    key = jax.random.PRNGKey(4)
    shape = shape or (B, S, jcfg.hidden_size)
    jsched = jd.DiffusionSchedule.create(jcfg.num_timesteps)
    jx = jd.sample(lambda x, t: jdn.denoiser_forward(jparams, jcfg, x, t),
                   jsched, shape, key, num_steps=steps)
    key, init_key = jax.random.split(key)
    x0 = np.array(jax.random.normal(init_key, shape, jnp.float32))
    noises = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    tsched = td.DiffusionSchedule.create(tcfg.num_timesteps, device="cpu")
    tx = td.sample(lambda x, t: tdn.denoiser_forward(tparams, tcfg, x, t),
                   tsched, shape, num_steps=steps, x=torch.from_numpy(x0),
                   noises=noises)
    jtok = np.asarray(jdn.decode_tokens(jparams, jx))
    ttok = tdn.decode_tokens(tparams, tx).numpy()
    return np.asarray(jx), tx.numpy(), jtok, ttok


def _check_sample(models, mode, bound):
    jparams, tparams = models[mode]
    jx, tx, jtok, ttok = _replayed_sample(jparams, tparams, models["jcfg"],
                                          models["tcfg"])
    assert np.isfinite(tx).all()
    assert _rel(tx, jx) < bound
    # nearest-token readout: equal wherever the top two logits are not tied
    # to within the trajectories' difference
    assert ttok.shape == (B, S)
    assert (ttok == jtok).mean() >= 0.99, (ttok != jtok).sum()


def test_sample_and_decode_match_fp32(models):
    _check_sample(models, "fp32", 1e-5)


def test_sample_and_decode_match_w4a8(models, pallas_on):
    # x is mostly the replayed noise; eps enters scaled by beta/sqrt(1-abar)
    _check_sample(models, "w4a8", 1e-3)
    assert pallas_on and all(pallas_on)


def _long_sample(monkeypatch, hidden, heads, seed):
    """B=1, S=1024, 2 steps, fp32 of `tiny(hidden_size=hidden,
    num_attention_heads=heads, max_sequence_length=1024)` in both packages,
    JAX's `use_pallas` patched to True (as on the TPU): (JAX x, port x, JAX
    tokens, port tokens, JAX's `dense_attention` results that were not None
    at this head width, the port's `dense_attention_plain` shapes)."""
    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=hidden,
                                         num_attention_heads=heads,
                                         max_sequence_length=1024)
    tcfg = tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(seed), jcfg)
    tparams = from_jax_params(_to_numpy(jparams), device="cpu")
    took, calls = [], []
    jdense, tdense = jpa.dense_attention, tat.dense_attention_plain
    hd = hidden // heads

    def jrec(*a, **k):
        out = jdense(*a, **k)
        took.append(out is not None and a[0].shape[-1] == hd)
        return out

    def trec(*a, **k):
        calls.append(a[0].shape)
        return tdense(*a, **k)
    monkeypatch.setattr(jmm, "use_pallas", lambda: True)
    monkeypatch.setattr(jpa, "dense_attention", jrec)
    monkeypatch.setattr(tat, "dense_attention_plain", trec)
    shape = (1, 1024, jcfg.hidden_size)
    jx, tx, jtok, ttok = _replayed_sample(jparams, tparams, jcfg, tcfg,
                                          shape, steps=2)
    # and one forward's eps at t = 500, where eps is the whole output
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jeps = np.asarray(jdn.denoiser_forward(jparams, jcfg, jnp.asarray(x),
                                           jnp.array([500])))
    teps = tdn.denoiser_forward(tparams, tcfg, torch.from_numpy(x),
                                torch.tensor([500])).numpy()
    return (jx, tx, jtok, ttok, took, calls, jcfg.num_layers,
            _rel(teps, jeps))


def test_long_sample_at_heads_of_16_matches_fp32(monkeypatch):
    """The slice at `DiffusionConfig.tiny(max_sequence_length=1024)` (width
    64, 4 heads of 16), B=1, S=1024, 2 steps, fp32: every layer's attention
    goes through `flash_fold` in both packages, JAX's interpreted
    `dense_attention` kernel (`use_pallas` patched to True, as on the TPU)
    and the port's plain version, both over bf16 operands in KV tiles of
    512. Within the fp32 sampler's 1e-5, tokens equal."""
    jx, tx, jtok, ttok, took, calls, L, _ = _long_sample(monkeypatch, 64, 4,
                                                         2)
    assert took and all(took)
    assert calls == [(4, 1024, 16)] * (3 * L)
    assert np.isfinite(tx).all()
    rel = _rel(tx, jx)
    print(f"S=1024 sampler at heads of 16, fp32: x rel {rel:.3g}")
    assert rel < 1e-5
    assert ttok.shape == (1, 1024) and (ttok == jtok).mean() >= 0.99


@pytest.mark.parametrize("heads,kernel", [(2, True), (8, False)])
def test_long_sample_at_heads_of_48_and_12_matches_fp32(monkeypatch, heads,
                                                        kernel):
    """`tiny(hidden_size=96, num_attention_heads=2,
    max_sequence_length=1024)`, heads of 48 (the CUDA kernel runs them
    padded to 64): both packages' `flash_fold` take their dense kernels (JAX
    interpreted, the port's plain version), as at heads of 16. With 8 heads
    of 12 no kernel runs: JAX's `dense_attention` returns None and both
    packages take `_flash_fold`'s einsum. B=1, S=1024, 2 steps, fp32:
    within the fp32 sampler's 1e-5, tokens equal; and one forward's eps at
    t = 500 within 1e-3 relative (the dense kernels round q, k, v and P to
    bf16 on both sides and sum in another order; the einsum is f32)."""
    jx, tx, jtok, ttok, took, calls, L, eps_rel = _long_sample(
        monkeypatch, 96, heads, 3)
    hd = 96 // heads
    assert took and all(t == kernel for t in took)  # JAX traces once
    assert calls == ([(heads, 1024, hd)] * (3 * L) if kernel else [])
    assert np.isfinite(tx).all()
    rel = _rel(tx, jx)
    print(f"S=1024 sampler at heads of {hd}, fp32: x rel {rel:.3g}, one "
          f"forward's eps rel {eps_rel:.3g}")
    assert rel < 1e-5 and eps_rel < 1e-3
    assert ttok.shape == (1, 1024) and (ttok == jtok).mean() >= 0.99


def test_long_sample_at_one_head_of_384_matches_fp32(monkeypatch):
    """`tiny(hidden_size=384, num_attention_heads=1,
    max_sequence_length=1024)`: 2 layers with one head of 384, wider than
    the CUDA kernels' fixed instances (the card runs `dense_attention`'s wide
    instance). Both packages' `flash_fold` take their dense kernels (JAX
    interpreted at D = 384, where its VMEM budget holds K and V; the port's
    plain version). B=1, S=1024, 2 steps, fp32: within the fp32 sampler's
    1e-5, tokens equal; one forward's eps at t = 500 within 1e-3 relative, as
    at heads of 48."""
    jx, tx, jtok, ttok, took, calls, L, eps_rel = _long_sample(
        monkeypatch, 384, 1, 4)
    assert took and all(took)
    assert calls == [(1, 1024, 384)] * (3 * L)
    assert np.isfinite(tx).all()
    rel = _rel(tx, jx)
    print(f"S=1024 sampler at one head of 384, fp32: x rel {rel:.3g}, one "
          f"forward's eps rel {eps_rel:.3g}")
    assert rel < 1e-5 and eps_rel < 1e-3
    assert ttok.shape == (1, 1024) and (ttok == jtok).mean() >= 0.99


# ------------------------------------------------- cached K/V branches
#
# Heads of 64 and S = 128, the shapes at which JAX's quantized-KV attention
# takes its Pallas kernel (interpret mode) and not its XLA fall-back.

S64 = 128


@pytest.fixture(scope="module")
def models64():
    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=128, num_attention_heads=2,
                                         max_sequence_length=S64)
    tcfg = tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(1), jcfg)
    for blk in jparams["blocks"]:  # logits of O(1): the cache must matter
        blk["attn"]["wqkv"] = blk["attn"]["wqkv"] * 10.0
    tparams = from_jax_params(_to_numpy(jparams), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, fp32=(jparams, tparams),
                w4a8=(_j_w4a8(jparams), _t_w4a8(tparams)))


def _cache_inputs(seed, cfg_layers=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S64, 128)).astype(np.float32)
    t = rng.integers(0, 50, size=(2,)).astype(np.int32)
    kv = tuple(rng.normal(size=(cfg_layers, 2, S64, 2, 64)).astype(np.float32)
               for _ in range(2))
    return x, t, kv


@pytest.mark.parametrize("mode", ["fp32", "w4a8"])
def test_forward_with_cached_kv_matches(models64, mode, pallas_on):
    """Attention over a given cache [L, B, Skv, H, Hd] in place of the step's
    K/V; the fresh K/V still come back. fp32 within 1e-4; W4A8 within 1e-2
    (the act-quant amplification of the uncached forward, 4e-3 measured
    with this model's sharpened attention)."""
    jparams, tparams = models64[mode]
    x, t, kv = _cache_inputs(3)
    jeps, (jk, _) = jdn.denoiser_forward(
        jparams, models64["jcfg"], jnp.asarray(x), jnp.asarray(t),
        cached_kv=tuple(jnp.asarray(a) for a in kv), return_kv=True)
    teps, (tk, _) = tdn.denoiser_forward(
        tparams, models64["tcfg"], torch.from_numpy(x), torch.from_numpy(t),
        cached_kv=tuple(torch.from_numpy(a) for a in kv), return_kv=True)
    plain = tdn.denoiser_forward(tparams, models64["tcfg"],
                                 torch.from_numpy(x), torch.from_numpy(t))
    print(f"cached_kv {mode}: eps rel {_rel(teps.numpy(), jeps):.3g}; the "
          f"cache moves eps by {_rel(teps.numpy(), plain.numpy()):.3g}")
    assert _rel(teps.numpy(), jeps) < (1e-4 if mode == "fp32" else 1e-2)
    assert _rel(tk.numpy(), jk) < (1e-5 if mode == "fp32" else 1e-2)
    assert _rel(teps.numpy(), plain.numpy()) > 0.05


@pytest.mark.parametrize("mode", ["fp32", "w4a8"])
@pytest.mark.parametrize("bits", [8, 2])
def test_forward_with_cached_qkv_matches(models64, mode, bits, pallas_on):
    """Attention over packed `QuantKV` pairs through the quantized-KV kernel
    (JAX: interpreted Pallas; the port: its plain version). fp32 within 2e-4
    (bf16 q and weights round at the same points; an `exp` bit can move one
    bf16 rounding); W4A8 within 1e-2 (4e-3 measured)."""
    jparams, tparams = models64[mode]
    x, t, kv = _cache_inputs(4 + bits)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(4, S64, 64)  # noqa: E731
    jq_, tq_ = [], []
    for li in range(2):
        pair = [jpa.quantize_kv(jnp.asarray(fold(a[li])), bits) for a in kv]
        jq_.append(tuple(pair))
        tq_.append(tuple(tat.QuantKV(
            torch.from_numpy(np.array(p.data)),
            torch.from_numpy(np.array(p.scale)),
            torch.from_numpy(np.array(p.zero_point)), bits, 64) for p in pair))
    jeps = jdn.denoiser_forward(jparams, models64["jcfg"], jnp.asarray(x),
                                jnp.asarray(t), cached_qkv=tuple(jq_))
    teps = tdn.denoiser_forward(tparams, models64["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(t), cached_qkv=tuple(tq_))
    deq = tuple(torch.stack([tq_[li][i].dequantize().reshape(2, 2, S64, 64)
                             .transpose(1, 2) for li in range(2)])
                for i in range(2))
    tdeq = tdn.denoiser_forward(tparams, models64["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(t), cached_kv=deq)
    print(f"cached_qkv {mode} {bits}-bit: eps rel {_rel(teps.numpy(), jeps):.3g}"
          f"; packed vs dequantized cache {_rel(teps.numpy(), tdeq.numpy()):.3g}")
    assert _rel(teps.numpy(), jeps) < (2e-4 if mode == "fp32" else 1e-2)
    # the same cache read both ways: only the attention's roundings differ
    assert _rel(teps.numpy(), tdeq.numpy()) < 2e-2
    if mode == "fp32":
        keep = torch.ones((2, S64))
        with pytest.raises(ValueError, match="attn_mask is not supported"):
            tdn.denoiser_forward(tparams, models64["tcfg"], torch.from_numpy(x),
                                 torch.from_numpy(t), cached_qkv=tuple(tq_),
                                 attn_mask=keep)


def test_simple_denoiser_matches():
    """y = x @ W + b from JAX's weights; the port's initialiser gives the
    same shapes and scale from its own generator."""
    jp = jdn.init_simple_denoiser(jax.random.PRNGKey(0), 24, 40)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(0).normal(size=(3, 5, 24)).astype(np.float32)
    t = np.zeros((3,), np.int32)
    jy = jdn.simple_denoiser_forward(jp, jnp.asarray(x), jnp.asarray(t))
    ty = tdn.simple_denoiser_forward(tp, torch.from_numpy(x),
                                     torch.from_numpy(t))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    own = tdn.init_simple_denoiser(torch.Generator().manual_seed(0), 24)
    assert tuple(own["w"].shape) == (24, 24) and tuple(own["b"].shape) == (24,)
    assert 0.015 < float(own["w"].std()) < 0.025 and not own["b"].any()
