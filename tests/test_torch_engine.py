"""Port parity: the `Engine` facade against the JAX package's, on the CPU.

Both engines load the shipped pretrained anchor (6 layers, width 256, vocab
463, f32 activations); the port then has to give the JAX package's answers:
next-token probabilities, greedy continuations token for token, denoising
perplexity from the noise JAX draws with its key, and samples through the
paged batcher with JAX's key chain replayed through a noise source. The
contract tests (memo invalidation, LRU bounds, guards, the methods ported
since the first slice) run
on a tiny random model. Each parity test prints what it measured
(`pytest -rP`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu.engine import Engine as JEngine
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.engine import Engine as TEngine
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight, MatmulWeight
from diffusion_llm_rs_tpu_torch.ops.packed_matmul import prepare
from diffusion_llm_rs_tpu_torch.quant.core import (Fp8Tensor, QuantizedTensor,
                                                   quantize_tree, tree_leaves)
from diffusion_llm_rs_tpu_torch.tokenizer.bpe import BPETokenizer

PROMPT = "the quick"
TEXT = "the forest maybe river the stone quick"


class JaxNoise:
    """Replays the JAX batcher's key chain: same draws, same order."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def admission(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))

    def step(self, shape):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, shape[0])
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.normal(k, shape[1:], jnp.float32))(keys)))


def _pair(bits=None, act_bits=16, **qkw):
    """Both engines on the anchor, quantized the same way."""
    je, te = JEngine.from_pretrained(), TEngine.from_pretrained(device="cpu")
    je.config.weight_quant.act_bits = act_bits
    te.config.weight_quant.act_bits = act_bits
    if bits is not None:
        je.quantize_weights(bits, **qkw)
        te.quantize_weights(bits, **qkw)
    return je, te


def test_from_pretrained_leaves_equal_jax_bit_for_bit():
    je, te = _pair()
    jl, tl = jax.tree_util.tree_leaves(je.params), tree_leaves(te.params)
    assert len(jl) == len(tl) == 69
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert dataclasses.asdict(te.config) == {
        **dataclasses.asdict(je.config),
        "beta_schedule": tcfg_mod.BetaSchedule(je.config.beta_schedule.value)}
    assert te.tokenizer.merges == je.tokenizer.merges
    assert te.stats()["weight_bits"] == je.stats()["weight_bits"] == 16


# fp32: the same f32 operations, sums in another order. Quantized: the
# packed matmul rounds its f32 activations to bf16 (act16) or to int8 levels
# (a8); a last-bit difference between the two frameworks' layer norms can
# move one such rounding, so probabilities agree to 2e-3 (measured: 3e-4 at
# int4, act16) and the greedy tokens must still be the same.
CASES = {
    "fp32": (dict(), 1e-5),
    "int4": (dict(bits=4), 2e-3),
    "int2": (dict(bits=2), 2e-3),
    "int4-a8": (dict(bits=4, act_bits=8), 2e-3),
    "int2-a8": (dict(bits=2, act_bits=8), 2e-3),
    "int8-unpacked": (dict(bits=8, kernel_layout=False), 2e-3),
    "fp8": (dict(bits=8, method="fp8"), 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_and_next_token_match_jax(case):
    kw, bound = CASES[case]
    je, te = _pair(**kw)
    mw = [l for l in tree_leaves(te.params) if isinstance(l, MatmulWeight)]
    if kw.get("method") == "fp8":
        assert isinstance(te.params["tok_embed"], Fp8Tensor) and not mw
        assert isinstance(te.params["pos_embed"], torch.Tensor)
    elif kw.get("kernel_layout") is False:
        assert isinstance(te.params["head"]["w"], QuantizedTensor) and not mw
    elif kw:
        # 463 rows do not pack: the embedding stays a QuantizedTensor
        assert isinstance(te.params["tok_embed"], QuantizedTensor)
        assert len(mw) == 2 + 4 * 6 + 1
        assert all(w.act_bits == kw.get("act_bits", 16) and
                   w.bits == kw["bits"] for w in mw)
    ids = te.tokenizer.encode("the quick brown")
    assert ids == je.tokenizer.encode("the quick brown")
    pj = np.asarray(je.predict_next_token(ids))
    pt = te.predict_next_token(ids).numpy()
    err = float(np.abs(pj - pt).max())
    out_j = je.generate(PROMPT, max_length=6)
    out_t = te.generate(PROMPT, max_length=6)
    print(f"{case}: next-token probs max |d| {err:.3g} (top {pj.max():.3g}); "
          f"generate {out_t!r}")
    assert pt.shape == (te.config.vocab_size,) and err <= bound
    assert out_t == out_j and len(out_t) > 0
    assert te.sample_token(pt) == je.sample_token(pj)
    assert te.stats()["weight_bits"] == je.stats()["weight_bits"]


@pytest.mark.parametrize("case", ["fp32", "int4", "int4-a8"])
def test_denoising_perplexity_matches_jax(case):
    """Same noise (JAX's draw from PRNGKey(seed)) on both sides; bound 1e-4
    relative in f32, 2e-2 quantized (activation roundings, as above)."""
    kw, _ = CASES[case]
    je, te = _pair(**kw)
    n = len(te.tokenizer.encode(TEXT))
    for t, seed in ((10, 0), (40, 3)):
        noise = np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (1, n, te.config.hidden_size),
            jnp.float32))
        pj = je.denoising_perplexity(TEXT, t=t, seed=seed)
        pt = te.denoising_perplexity(TEXT, t=t, noise=torch.from_numpy(noise))
        print(f"{case} t={t}: perplexity jax {pj:.6g} port {pt:.6g}")
        assert abs(pt - pj) <= (1e-4 if case == "fp32" else 2e-2) * pj
        if t == 10:   # the trained anchor, far below a random model's ~vocab
            assert pt < te.tokenizer.vocab_size / 10
    # the port's own draw: deterministic per seed, finite
    a = te.denoising_perplexity(TEXT, t=10, seed=1)
    assert a == te.denoising_perplexity(TEXT, t=10, seed=1) and np.isfinite(a)
    with pytest.raises(ValueError, match="at least 2 tokens"):
        te.denoising_perplexity("a")


@pytest.mark.parametrize("case", ["fp32", "int4", "int4-a8"])
def test_sample_through_paged_batcher_matches_jax(case):
    """Engine.sample with JAX's key chain replayed: B=2, S=16 (one page of
    16), 6 steps, the dense fake-quant mode `auto` picks at this length.
    The port runs fused chunks, JAX single steps. Tokens are an argmax over
    463 logits: they must agree on at least 95% of positions (measured:
    all)."""
    kw, _ = CASES[case]
    je, te = _pair(**kw)
    tj = np.asarray(je.sample(batch_size=2, seq_len=16, num_steps=6, seed=5,
                              return_text=False))
    tt = te.sample(batch_size=2, seq_len=16, num_steps=6, seed=5,
                   return_text=False, noise=JaxNoise(5))
    agree = float((tj == tt.numpy()).mean())
    print(f"{case}: sample token agreement {agree:.3f}")
    assert tt.shape == (2, 16) and tt.dtype == torch.int64
    assert agree >= 0.95
    b = te._samplers[(2, 16, False, "auto")]
    assert b.attend_mode == "dense" and b.page_size == 16
    assert b.params is te.params and b.readout_params is te.params
    texts = te.sample(batch_size=2, seq_len=16, num_steps=6, seed=5,
                      noise=JaxNoise(5))
    assert texts == [te.tokenizer.decode(r.tolist()) for r in tt]
    # the port's own generator: same seed, same tokens
    a = te.sample(batch_size=1, seq_len=8, num_steps=3, seed=2,
                  return_text=False)
    assert torch.equal(a, te.sample(batch_size=1, seq_len=8, num_steps=3,
                                    seed=2, return_text=False))


class JaxKeyChain:
    """Replays the scan sampler's draws from PRNGKey(seed): one split for
    the initial x, then one per step."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def admission(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))

    step = admission


@pytest.mark.parametrize("case", ["fp32", "int4"])
@pytest.mark.parametrize("seq_len,use_paged", [(16, False), (10, True)],
                         ids=["use_paged=False", "seq_len=10"])
def test_sample_through_the_scan_sampler_matches_jax(case, seq_len, use_paged):
    """Engine.sample on the phase-aware sampler over the packed KV carry:
    asked for (use_paged=False), and taken because no page divides
    seq_len=10. B=2, 6 steps (8 -> 4 -> 2 bits), JAX's draws replayed. At
    these lengths JAX's attention takes its XLA fall-back (dequantized K/V
    rounded to bf16) and the port the kernel's arithmetic, which moves each
    attention output by about 5e-3; the tokens, an argmax over 463 logits,
    must still be the same at every position."""
    kw, _ = CASES[case]
    je, te = _pair(**kw)
    args = dict(batch_size=2, seq_len=seq_len, num_steps=6, seed=5,
                return_text=False, use_paged=use_paged)
    tj = np.asarray(je.sample(**args))
    tt = te.sample(**args, noise=JaxKeyChain(5))
    agree = float((tj == tt.numpy()).mean())
    print(f"{case} seq_len={seq_len} use_paged={use_paged}: token agreement "
          f"{agree:.3f}")
    assert tt.shape == (2, seq_len) and tt.dtype == torch.int64
    assert not te._samplers          # no batcher was built
    np.testing.assert_array_equal(tt.numpy(), tj)
    texts = te.sample(**{**args, "return_text": True}, noise=JaxKeyChain(5))
    assert texts == [te.tokenizer.decode(r.tolist()) for r in tt]
    # the port's own generator: same seed, same tokens
    args.pop("seed")
    assert torch.equal(te.sample(**args, seed=2), te.sample(**args, seed=2))


def test_sample_paged_mode_runs_with_packed_params():
    """attend_mode="paged" at a short length: pools, the paged attention's
    plain version and packed weights in one step."""
    _, te = _pair(bits=4)
    ids = te.sample(batch_size=2, seq_len=16, num_steps=4, seed=0,
                    return_text=False, attend_mode="paged",
                    salience_routing=True)
    b = te._samplers[(2, 16, True, "paged")]
    assert b.pools and np.all(np.isfinite(b.page_scores))
    assert ids.shape == (2, 16) and int(ids.min()) >= 0
    assert int(ids.max()) < te.config.vocab_size


# ---------------------------------------------------------------- contract --

def _tiny(**kw):
    return TEngine(config=tcfg_mod.DiffusionConfig.tiny(vocab_size=512),
                   device="cpu", **kw)


def test_quantize_weights_invalidates_memos():
    e = _tiny()
    assert isinstance(e.generate(PROMPT, max_length=4), str)
    e.sample(batch_size=1, seq_len=16, num_steps=2, seed=0)
    k = torch.randn(2, 1, 4, 4, 16)
    e.kv_cache.update("c", k, k)
    assert e._ntp_cache and e._samplers and e.kv_cache_memory_usage() > 0
    assert e.stats()["kv_cache_entries"] == 1
    e.quantize_weights(2)
    assert not e._ntp_cache and not e._samplers
    assert e.kv_cache_memory_usage() == 0 and len(e.kv_cache) == 0
    assert isinstance(e.generate(PROMPT, max_length=4), str)
    e.kv_cache.update("c", k, k)
    e.clear_kv_cache()
    assert e.stats()["kv_cache_bytes"] == 0


def test_generate_memo_hits_and_is_lru_bounded():
    e = _tiny()
    out = e.generate(PROMPT, max_length=4)
    assert e.generate_cache_hits == 0
    assert e.generate(PROMPT, max_length=4) == out
    assert e.generate_cache_hits >= 1
    e._ntp_cache_cap = 8
    for i in range(6):
        e.generate(f"prompt variant {i}", max_length=3)
    assert len(e._ntp_cache) <= 8
    assert isinstance(e.generate("", max_length=2), str)   # empty -> [EOS]


def test_samplers_are_lru_bounded_and_follow_new_params():
    e = _tiny()
    e._samplers_cap = 2
    for seq in (8, 16, 24):
        e.sample(batch_size=1, seq_len=seq, num_steps=2, seed=0)
    assert len(e._samplers) <= 2 and (1, 8, False, "auto") not in e._samplers
    e.sample(batch_size=1, seq_len=16, num_steps=2, seed=0)   # refreshes 16
    e.sample(batch_size=1, seq_len=32, num_steps=2, seed=0)
    assert set(e._samplers) == {(1, 16, False, "auto"), (1, 32, False, "auto")}
    b = e._samplers[(1, 16, False, "auto")]
    e.params = dict(e.params)      # new parameters set from outside
    e.sample(batch_size=1, seq_len=16, num_steps=2, seed=0)
    assert e._samplers[(1, 16, False, "auto")] is b
    assert b.params is e.params and b.readout_params is e.params


def test_vocab_guard_and_default_tokenizer():
    tok = BPETokenizer.train(["aa bb aa bb cc aa"] * 3, 300)
    with pytest.raises(ValueError, match="exceeds model vocab"):
        TEngine(config=tcfg_mod.DiffusionConfig.tiny(vocab_size=256),
                tokenizer=tok, device="cpu")
    e = _tiny()
    j = JEngine(config=jcfg_mod.DiffusionConfig.tiny(vocab_size=512))
    assert e.tokenizer.merges == j.tokenizer.merges
    assert e.tokenizer.vocab_size <= 320


def test_infer_weight_bits_over_given_params():
    e = _tiny()
    assert e.stats()["weight_bits"] == 16
    q = quantize_tree(e.params, 4, group_size=64)
    assert TEngine(config=e.config, params=q, device="cpu"
                   ).stats()["weight_bits"] == 4
    q["head"]["w"] = prepare(quantize_tree(
        {"w": e.params["head"]["w"]}, 2, group_size=64)["w"])
    assert TEngine(config=e.config, params=q, device="cpu"
                   )._infer_weight_bits() == 2
    i8 = dict(e.params, head={"w": Int8Weight(
        torch.zeros(64, 64, dtype=torch.int8), torch.ones(1, 64))})
    assert TEngine(config=e.config, params=i8, device="cpu"
                   )._infer_weight_bits() == 8


@pytest.mark.parametrize("call,item", [
    (lambda e: e.quantize_weights(4, method="gptq"), "quantized"),
    (lambda e: e.sample(batch_size=1, seq_len=16, num_steps=2,
                        use_paged=False, return_text=False), None),
    (lambda e: e.sample(batch_size=1, seq_len=10, num_steps=2,
                        return_text=False), None),
    (lambda e: e.prefill("the quick"), "ported"),
    (lambda e: e.process_model("the quick"), "ported"),
    (lambda e: e.tokenize_model("the quick"), "ported"),
    (lambda e: e.get_cached_vectors(["default:0"]), "ported"),
    (lambda e: e.set_attention_mask("v", np.ones(4)), "ported"),
    (lambda e: e.apply_attention_masks([], []), "ported"),
    (lambda e: TEngine(config=e.config, system_config=e.system_config,
                       device="cpu"), "ported"),
], ids=["gptq", "scan-sampler", "odd-seq-len", "prefill", "process_model",
        "tokenize_model", "get_cached_vectors", "set_attention_mask",
        "apply_attention_masks", "system_config"])
def test_deferred_parts_raise_and_name_their_roadmap_item(call, item,
                                                          tmp_path):
    e = _tiny(system_config=tcfg_mod.SystemConfig(
        ssd_path=str(tmp_path / "store.bin")))
    if item == "quantized":  # ported since: GPTQ packs the matmul weights
        call(e)
        assert isinstance(e.params["head"]["w"], MatmulWeight)
        assert e.stats()["weight_bits"] == 4
        return
    if item is None:  # ported since: the scan sampler answers with token ids
        ids = call(e)
        assert ids.shape[0] == 1 and ids.dtype == torch.int64
        assert 0 <= int(ids.min()) and int(ids.max()) < e.config.vocab_size
        return
    # ported since: the host-side stack answers, and leaves the parameters
    # alone
    out = call(e)
    assert out is None or bool(out)
    assert isinstance(e.params["head"]["w"], torch.Tensor)
