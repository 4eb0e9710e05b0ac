"""Port parity: `plan_segments` and `phase_aware_sample` against the JAX
package, from JAX's own draws.

The model is tiny (2 layers, width 128, 2 heads of 64, vocab 256, 50
timesteps) and the sequence 128 tokens, so that JAX's quantized-KV attention
takes its Pallas kernel (interpret mode on the CPU; it needs Sq % 8 == 0 and
Skv % 128 == 0) and not its XLA fall-back. The port cannot reproduce JAX's
PRNG, so a noise source replays JAX's key chain: `key, init = split(key)` for
the initial x, then one `key, sub = split(key)` per step in execution order
(bootstrap first, then each segment's steps). Each test prints what it
measured (`pytest -rP`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu.models import diffusion as jd
from diffusion_llm_rs_tpu.models import sampler as jsp
from diffusion_llm_rs_tpu.ops import matmul as jmm
from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.models import diffusion as td
from diffusion_llm_rs_tpu_torch.models import sampler as tsp
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

B, S, STEPS = 2, 128, 8


class JaxKeyChain:
    """Replays `phase_aware_sample`'s draws from PRNGKey(seed)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def admission(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))

    step = admission


def _configs(**kw):
    jcfg = jcfg_mod.DiffusionConfig.tiny(hidden_size=128, num_attention_heads=2,
                                         max_sequence_length=S, **kw)
    return jcfg, tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: ({"data": np.array(l.data), "col_scale": np.array(l.col_scale)}
                   if isinstance(l, jmm.Int8Weight) else np.array(l)),
        tree, is_leaf=lambda l: isinstance(l, jmm.Int8Weight))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    # a random initialisation attends almost uniformly (q.k is about 1e-2),
    # and then no cache error could show: scaled up, the logits are O(1)
    for blk in jparams["blocks"]:
        blk["attn"]["wqkv"] = blk["attn"]["wqkv"] * 10.0
    tparams = from_jax_params(_to_numpy(jparams), device="cpu")
    q = jq.quantize_tree(jparams, 4, symmetric=True, granularity="group",
                         group_size=128, axis=0)
    jq8 = jax.tree_util.tree_map(
        lambda l: (jmm.decode_to_int8(jpm.prepare(l, act_bits=8))
                   if isinstance(l, jq.QuantizedTensor) and l.ndim == 2 else l),
        q, is_leaf=lambda l: isinstance(l, jq.QuantizedTensor))
    tq8 = from_jax_params(_to_numpy(jq8), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, fp32=(jparams, tparams),
                w4a8=(jq8, tq8),
                jsched=jd.DiffusionSchedule.create(jcfg.num_timesteps),
                tsched=td.DiffusionSchedule.create(tcfg.num_timesteps,
                                                   device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ segments


def _phase_cfgs():
    out = [dict(), dict(use_phase_aware_quant=False, kv_quant_bits=4),
           dict(use_phase_aware_quant=False, kv_quant_bits=3),
           dict(use_phase_aware_quant=False, kv_quant_bits=None)]
    for q in (dict(progressive_precision=False),
              dict(prefill_bits=4, decode_bits=8, min_decode_bits=1),
              dict(prefill_bits=8, decode_bits=4, min_decode_bits=3),
              dict(prefill_bits=2, decode_bits=2, min_decode_bits=2),
              dict(prefill_bits=6, decode_bits=5, min_decode_bits=1)):
        out.append(dict(quant_config=q))
    return out


@pytest.mark.parametrize("num_steps", [1, 2, 7, 8, 32, 50, 100])
def test_plan_segments_equal_jax(num_steps):
    """Every phase configuration above (the JAX package's own test cases, an
    unsupported width, a floor of 3, inverted and odd widths) at this step
    count: the same (bits, t_hi, t_lo) list, which tiles T-1 .. 0."""
    for kw in _phase_cfgs():
        qkw = kw.pop("quant_config", None)
        jcfg, tcfg = _configs(**kw)
        if qkw:
            jcfg.quant_config = jcfg_mod.PhaseQuantConfig(**qkw)
            tcfg.quant_config = tcfg_mod.PhaseQuantConfig(**qkw)
        want = jsp.plan_segments(num_steps, jcfg)
        got = tsp.plan_segments(num_steps, tcfg)
        assert got == want, (kw, qkw)
        assert sum(hi - lo + 1 for _, hi, lo in got) == num_steps
        assert got[0][1] == num_steps - 1 and got[-1][2] == 0


def test_plan_segments_default_schedule():
    _, tcfg = _configs()
    # 4 bits only at t = half: any progress past it buckets down to 2
    assert tsp.plan_segments(100, tcfg) == [(8, 99, 51), (4, 50, 50), (2, 49, 0)]
    assert tsp.plan_segments(STEPS, tcfg) == [(8, 7, 5), (4, 4, 4), (2, 3, 0)]
    assert [tsp.bucket_bits(v) for v in (8.0, 7.9, 3.0, 1.5, 0.2)] == \
        [8, 4, 2, 1, 1]
    assert [tsp.bucket_bits_up(v) for v in (3, 1, 5, 9)] == [4, 1, 8, 8]


# ------------------------------------------------------------ KV carry


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_kv_carry_quantizers_equal_jax(bits):
    """`_quantize_kv_stacked` (all layers in one call here, viewed per layer
    by `_split_layers`; a per-layer loop in JAX's `_quantize_kv_packed`) and
    `_quantize_kv_pair`: bytes, scales and zero-points bit for bit, and the
    dequantized pair equal."""
    rng = np.random.default_rng(bits)
    kv = tuple(rng.normal(size=(2, 2, 24, 2, 64)).astype(np.float32) * 3
               for _ in range(2))
    jkv = tuple(jnp.asarray(a) for a in kv)
    tkv = tuple(torch.from_numpy(a) for a in kv)
    jpacked = jsp._quantize_kv_packed(jkv, bits)
    tpacked = tuple(zip(*(tsp._split_layers(q, 2)
                          for q in tsp._quantize_kv_stacked(tkv, bits))))
    assert len(tpacked) == len(jpacked) == 2
    for jpair, tpair in zip(jpacked, tpacked):
        for j, t in zip(jpair, tpair):
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
            np.testing.assert_array_equal(t.zero_point.numpy(),
                                          np.asarray(j.zero_point))
            assert t.shape == j.shape == (4, 24, 64) and t.bits == bits
    jpair, tpair = jsp._quantize_kv_pair(jkv, bits), tsp._quantize_kv_pair(tkv, bits)
    for j, t in zip(jpair, tpair):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        assert tuple(t.scale.shape) == (2, 2, 24, 2, 1)
    for j, t in zip(jsp._dequantize_kv_pair(jpair),
                    tsp._dequantize_kv_pair(tpair)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the same grid on both carries: the packed carry dequantizes to the pair
    k_packed = torch.stack([p[0].dequantize() for p in tpacked])  # [L,BH,S,Hd]
    k_pair = tsp._dequantize_kv_pair(tpair)[0].permute(0, 1, 3, 2, 4).reshape(
        2, 4, 24, 64)
    np.testing.assert_array_equal(k_packed.numpy(), k_pair.numpy())


# ------------------------------------------------------------ sampler


AMP = 100.0


def _amplified(fwd):
    """The denoiser with eps times AMP. A randomly initialised model predicts
    a small eps, and the last steps' beta_t / sqrt(1 - abar_t) is about 1e-2,
    so x would be the replayed noise to five digits whatever the cache did;
    amplified, x depends on eps and through it on the carried K/V."""
    def call(*a, **k):
        out = fwd(*a, **k)
        if isinstance(out, tuple):
            return (out[0] * AMP,) + tuple(out[1:])
        return out * AMP
    return call


def _sample_both(models, mode, seed, **kw):
    jparams, tparams = models[mode]
    jx = jsp.phase_aware_sample(jparams, models["jcfg"], models["jsched"],
                                (B, S), jax.random.PRNGKey(seed),
                                num_steps=STEPS,
                                forward_fn=_amplified(jdn.denoiser_forward),
                                **kw)
    tx = tsp.phase_aware_sample(tparams, models["tcfg"], models["tsched"],
                                (B, S), JaxKeyChain(seed), num_steps=STEPS,
                                forward_fn=_amplified(tdn.denoiser_forward),
                                **kw)
    return np.asarray(jx), tx.numpy()


@pytest.mark.parametrize("branch", ["kernel_cache", "dequantized_cache",
                                    "no_cache"])
def test_phase_aware_sample_matches_jax_fp32(models, branch):
    """8 steps crossing 8 -> 4 -> 2 bits at B=2, S=128, fp32 weights, from
    JAX's draws. Without a cache only f32 sums separate the packages: 1e-5
    relative. With a cache, a last-bit difference in a fresh K or V can move
    a level of the carry, most often at a segment boundary, where the carry
    sits on the old grid and many values are exact ties of the new one; the
    amplified eps carries each moved level into x: 3.3e-4 to 8.7e-4 measured,
    bound 3e-3. (At one uniform width the packages agree to 2.6e-7 - 2.2e-4;
    dropping the cache altogether moves x by 7.8e-2.)"""
    kw = {"kernel_cache": dict(kernel_cache=True),
          "dequantized_cache": dict(kernel_cache=False),
          "no_cache": dict(use_cache=False)}[branch]
    jx, tx = _sample_both(models, "fp32", 5, **kw)
    rel = _rel(tx, jx)
    print(f"phase_aware_sample fp32 {branch}: x rel {rel:.3g}, max abs "
          f"{np.abs(tx - jx).max():.3g}")
    assert tx.shape == (B, S, 128) and np.isfinite(tx).all()
    assert rel < (1e-5 if branch == "no_cache" else 3e-3)
    jtok = np.asarray(jdn.decode_tokens(models["fp32"][0], jnp.asarray(jx)))
    ttok = tdn.decode_tokens(models["fp32"][1], torch.from_numpy(tx)).numpy()
    assert (ttok == jtok).mean() >= 0.99


def test_kernel_and_dequantized_cache_agree(models):
    """kernel_cache=True and False carry the same quantization grid; only
    the attention's arithmetic differs (bf16 q and weights against f32):
    within the JAX package's own 5e-3 absolute."""
    tparams = models["fp32"][1]
    args = (tparams, models["tcfg"], models["tsched"], (B, S))
    xk = tsp.phase_aware_sample(*args, JaxKeyChain(2), num_steps=STEPS,
                                kernel_cache=True)
    xf = tsp.phase_aware_sample(*args, JaxKeyChain(2), num_steps=STEPS,
                                kernel_cache=False)
    xn = tsp.phase_aware_sample(*args, JaxKeyChain(2), num_steps=STEPS,
                                use_cache=False)
    err = float((xk - xf).abs().max())
    print(f"kernel_cache True vs False: max abs {err:.3g}; against no cache "
          f"at all {float((xk - xn).abs().max()):.3g}")
    assert err < 5e-3


def test_phase_aware_sample_matches_jax_w4a8(models, monkeypatch):
    """The W4A8 decoded model through the packed carry, JAX on its Pallas
    kernels in interpret mode (linears, MLPs and the quantized-KV attention).
    Each act-quant can turn an f32 sum-order difference into a whole int8
    level (ROADMAP C7), and eps is amplified a hundredfold here: 1.1e-2
    relative on x measured, bound 3e-2 (dropping the cache moves x by
    7.9e-2)."""
    monkeypatch.setattr(jmm, "use_pallas", lambda: True)
    jx, tx = _sample_both(models, "w4a8", 6, kernel_cache=True)
    rel = _rel(tx, jx)
    print(f"phase_aware_sample W4A8 kernel_cache: x rel {rel:.3g}")
    assert np.isfinite(tx).all() and rel < 3e-2


def test_phase_aware_sample_takes_a_generator_and_a_forward_fn(models):
    """A `torch.Generator` stands for a noise source; `forward_fn` replaces
    the denoiser (here the one-matrix model, which returns no K/V, so only
    the cache-free branch can run it)."""
    tparams = models["fp32"][1]
    args = (tparams, models["tcfg"], models["tsched"], (1, 8))
    a = tsp.phase_aware_sample(*args, torch.Generator().manual_seed(3),
                               num_steps=4)
    b = tsp.phase_aware_sample(*args, torch.Generator().manual_seed(3),
                               num_steps=4)
    assert torch.equal(a, b) and tuple(a.shape) == (1, 8, 128)
    simple = tdn.init_simple_denoiser(torch.Generator().manual_seed(0), 128)
    calls = []

    def fwd(params, cfg, x, t):
        calls.append(int(t[0]))
        return tdn.simple_denoiser_forward(simple, x, t)
    x = tsp.phase_aware_sample(*args, torch.Generator().manual_seed(3),
                               num_steps=4, use_cache=False, forward_fn=fwd)
    assert calls == [3, 2, 1, 0] and bool(torch.isfinite(x).all())
