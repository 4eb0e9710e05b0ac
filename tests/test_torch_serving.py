"""Port parity: the paged serving path (`serving.py`) against the JAX
package, on the CPU.

JAX draws its noise from a key chain that torch cannot reproduce, so the
port's batchers take `JaxNoise`, a noise source that replays the JAX
batcher's draws in its order: at each admission wave one split and a full
[B, S, D] normal; at each denoise step one split, then one key per slot and
a normal each. Parameters are JAX's, exported as numpy. Each parity test
prints the difference it measured (`pytest -rP` shows them).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu import serving as jsv
from diffusion_llm_rs_tpu.cache.salience import allocate_bits as jallocate
from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch import serving as tsv
from diffusion_llm_rs_tpu_torch.cache.salience import (allocate_bits,
                                                       allocate_bits_torch)
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics
from diffusion_llm_rs_tpu_torch.weights import from_jax_params, from_jax_pools


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


def _models(sharpen=1.0, **cfg_kw):
    """`sharpen` scales the QKV projections: a random initialisation attends
    almost uniformly, which hides any error of the attention."""
    jcfg = jcfg_mod.DiffusionConfig.tiny(vocab_size=128, **cfg_kw)
    tcfg = tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    if sharpen != 1.0:
        for blk in jparams["blocks"]:
            blk["attn"]["wqkv"] = blk["attn"]["wqkv"] * sharpen
    tparams = from_jax_params(jax.tree_util.tree_map(np.array, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batchers(seed, jkw, tkw=None, **cfg_kw):
    jcfg, tcfg, jparams, tparams = _models(**cfg_kw)
    jb = jsv.PagedContinuousBatcher(jparams, jcfg, seed=seed, **jkw)
    tb = tsv.PagedContinuousBatcher(tparams, tcfg, seed=seed, device="cpu",
                                    noise=JaxNoise(seed), **(tkw or jkw))
    return jb, tb


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _adversarial_cfgs():
    """Configs whose progressive targets land on bucket boundaries."""
    out = []
    for progressive, db, mn in ((True, 4, 2), (False, 4, 2), (True, 8, 1)):
        jcfg = jcfg_mod.DiffusionConfig.tiny()
        jcfg.quant_config.progressive_precision = progressive
        jcfg.quant_config.decode_bits = db
        jcfg.quant_config.min_decode_bits = mn
        out.append((jcfg, tcfg_mod.diffusion_config_from_json(
            jcfg_mod.to_json(jcfg))))
    return out


def test_bit_routers_match_jax_and_each_other():
    """The port's numpy router equals JAX's; its device routers (bits and
    budget) equal its numpy router at every t, bucket boundaries included
    (the dense sweep of JAX's boundary test, decode 8 -> min 1); its bucket
    widths equal JAX's."""
    for jcfg, tcfg in _adversarial_cfgs():
        widths, fn = tsv.make_slot_bits_router(tcfg)
        assert widths == jsv.make_slot_bits_router(jcfg)[0]
        budget_fn = tsv.make_slot_budget_router(tcfg)
        for total in range(2, 80):
            ts = np.arange(total)
            tot = np.full((total,), total)
            bits, budget = tsv.slot_phase_bits_np(tcfg, ts, tot)
            jbits, jbudget = jsv.slot_phase_bits_np(jcfg, ts, tot)
            np.testing.assert_array_equal(bits, jbits)
            np.testing.assert_array_equal(budget, jbudget)
            tt, tot_t = torch.from_numpy(ts), torch.from_numpy(tot)
            np.testing.assert_array_equal(fn(tt, tot_t).numpy(), bits,
                                          err_msg=f"total={total}")
            np.testing.assert_array_equal(budget_fn(tt, tot_t).numpy(),
                                          budget)


def test_chunk_bucket_union_is_superset_of_device_router():
    """A bucket the host prunes but the device router picks would make the
    chunk skip every page of that step: the chunk's union must cover the
    device pick at every step offset, across the adversarial config."""
    _, tcfg = _adversarial_cfgs()[2]
    tparams = {"blocks": []}
    b = tsv.PagedContinuousBatcher(tparams, tcfg, num_slots=1, seq_len=16,
                                   page_size=8, max_chunk=32, device="cpu")
    _, dev_fn = tsv.make_slot_bits_router(tcfg)
    for total in (7, 14, 28, 55):
        b.t[0] = total - 1
        b.slot_request[0] = tsv.Request(f"r{total}", seq_len=16,
                                        num_steps=total)
        totals = np.array([total], np.int64)
        while b.t[0] >= 0:
            c = b._chunk_steps(b.t >= 0)
            used = b._used_buckets_chunk(b.t >= 0, totals, c)
            for s in range(c):
                t_s = int(b.t[0]) - s
                if t_s < 0:
                    break
                dev = int(dev_fn(torch.tensor([t_s]),
                                 torch.from_numpy(totals))[0])
                assert dev in used, (total, t_s, dev, used)
            b.t[0] -= c
        b.slot_request[0] = None


def test_allocate_bits_twins_are_identical():
    """Host greedy == JAX's; the torch twin, batched over rows with a
    validity mask per row, == the host greedy on each row's valid prefix."""
    rng = np.random.RandomState(0)
    for trial in range(10):
        B, n = 4, int(rng.randint(2, 17))
        scores = rng.rand(B, n).astype(np.float32)
        scores[0, : n // 2] = scores[0, 0]          # ties sort stably
        budget = rng.uniform(1.0, 8.0, size=B).astype(np.float32)
        n_valid = rng.randint(1, n + 1, size=B)
        valid = np.arange(n)[None, :] < n_valid[:, None]
        opts = (2, 4, 8)
        dev = allocate_bits_torch(torch.from_numpy(scores),
                                  torch.from_numpy(budget),
                                  torch.from_numpy(valid), opts).numpy()
        for b in range(B):
            k = n_valid[b]
            host = allocate_bits(scores[b, :k], float(budget[b]), opts)
            np.testing.assert_array_equal(
                host, jallocate(scores[b, :k], float(budget[b]), opts))
            np.testing.assert_array_equal(dev[b, :k], host,
                                          err_msg=f"trial {trial} row {b}")
            assert np.all(dev[b, k:] == min(opts))


def _pools_np(n, HG, Pg, GD, buckets):
    out = {}
    for bits in buckets:
        d = (n, HG, Pg // (8 // bits), GD)
        s = (n, HG, GD // 64 * Pg)
        out[bits] = {"k_data": np.zeros(d, np.uint8),
                     "v_data": np.zeros(d, np.uint8),
                     "k_scale": np.ones(s, np.float32),
                     "k_zp": np.zeros(s, np.float32),
                     "v_scale": np.ones(s, np.float32),
                     "v_zp": np.zeros(s, np.float32)}
    return out


def test_paged_attend_factory_matches_jax():
    """Layer 1 of a 2-layer step at head_dim 64 (G = 2) with pages of 128:
    JAX's Pallas kernel (interpret mode) against the port's twin. Slot 0
    reads its two pages from the 8- and 4-bit buckets, slot 1 two 2-bit
    pages, the last partial. The pools written by both are equal bit for
    bit; the attention output agrees within 1e-3 relative and the
    attention-mass proxy within 1e-5."""
    jcfg, tcfg, _, _ = _models(hidden_size=128, num_attention_heads=2,
                               max_sequence_length=256)
    B, S, Pg, nps, L, H, G, Hd = 2, 256, 128, 2, 2, 2, 2, 64
    buckets = (2, 4, 8)
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, S, H, Hd)).astype(np.float32)
               for _ in range(3))
    page_bits = np.array([[8, 4], [2, 2]], np.int32)
    active = np.array([True, True])
    seq_lens = np.array([256, 200], np.int32)
    pt = ((np.arange(B)[None, :, None] * L + np.arange(L)[:, None, None]) * nps
          + np.arange(nps)[None, None, :]).astype(np.int32)
    npools = _pools_np(B * L * nps, H // G, Pg, G * Hd, buckets)
    jpools = {b: {n: jnp.asarray(a) for n, a in p.items()}
              for b, p in npools.items()}
    tpools = from_jax_pools(npools, device="cpu")
    jscores, tscores = [], []
    jfn = jsv._paged_attend_factory(
        cfg=jcfg, B=B, S=S, Pg=Pg, nps=nps, L=L, H=H, G=G, buckets=buckets,
        pt=jnp.asarray(pt), pools=jpools, page_bits=jnp.asarray(page_bits),
        active=jnp.asarray(active), seq_lens=jnp.asarray(seq_lens),
        scores_acc=jscores)
    tfn = tsv._paged_attend_factory(
        cfg=tcfg, B=B, S=S, Pg=Pg, nps=nps, L=L, H=H, G=G, buckets=buckets,
        pt=torch.from_numpy(pt), pools=tpools,
        page_bits=torch.from_numpy(page_bits),
        active=torch.from_numpy(active), seq_lens=torch.from_numpy(seq_lens),
        scores_acc=tscores)
    jout = jfn(1, *(jnp.asarray(a) for a in (q, k, v)), None)
    tout = tfn(1, *(torch.from_numpy(a) for a in (q, k, v)), None)
    for bits in buckets:
        for name, arr in tpools[bits].items():
            np.testing.assert_array_equal(arr.numpy(),
                                          np.asarray(jpools[bits][name]),
                                          err_msg=f"{bits}-bit {name}")
    proxy = np.abs(tscores[0].numpy() - np.asarray(jscores[0])).max()
    print(f"paged attend factory vs JAX: rel {_rel(tout.numpy(), jout):.3g}, "
          f"proxy max abs {proxy:.3g}")
    assert _rel(tout.numpy(), jout) < 1e-3
    np.testing.assert_allclose(tscores[0].numpy(), np.asarray(jscores[0]),
                               rtol=1e-5, atol=1e-6)


def test_one_paged_step_matches_jax():
    """One batcher step at tiny(hidden_size=128, num_attention_heads=2,
    max_sequence_length=128), pages of 128 (JAX's grouped-head kernel path)
    with the key chain replayed: x within 2e-3 (the bound of JAX's own
    grouped-head step test); the unadmitted slot stays 0 on both sides."""
    jb, tb = _batchers(11, dict(num_slots=2, seq_len=128, page_size=128,
                                max_chunk=1, attend_mode="paged"),
                       hidden_size=128, num_attention_heads=2,
                       max_sequence_length=128)
    assert jb.head_group == tb.head_group == 2
    for b in (jb, tb):
        b.submit(jsv.Request("r", seq_len=128, num_steps=2)
                 if b is jb else tsv.Request("r", seq_len=128, num_steps=2))
        b.step()
    print(f"one step vs JAX: x max abs "
          f"{np.abs(tb.x.numpy() - np.asarray(jb.x)).max():.3g}, rel "
          f"{_rel(tb.x.numpy(), jb.x):.3g}")
    np.testing.assert_allclose(tb.x.numpy(), np.asarray(jb.x), rtol=2e-3,
                               atol=2e-3)
    assert np.all(tb.x[1].numpy() == 0)
    for bits in tb.buckets:
        for name, arr in tb.pools[bits].items():
            assert arr.shape == jb.pools[bits][name].shape


def test_one_paged_step_a8_matches_jax():
    """The same step with attn_act_bits=8 (JAX's `test_paged_step_a8_close_
    to_exact` shape; its interpreted int8 kernel at pages of 128), on a model
    with sharpened attention: x within 2e-3 of JAX's a8 step. x is mostly
    the replayed noise, so the int8 path's own effect, x(a8) - x(bf16), is
    compared too: the port's within 20% of JAX's (6% measured: JAX's compiled
    kernel divides by 127 through a reciprocal, which moves a few int8
    levels), and both within JAX's 5e-2 of the bf16 step."""
    kw = dict(num_slots=2, seq_len=128, page_size=128, max_chunk=1,
              attend_mode="paged")
    cfg = dict(hidden_size=128, num_attention_heads=2,
               max_sequence_length=128, sharpen=10.0)
    j8, t8 = _batchers(11, dict(kw, attn_act_bits=8), **cfg)
    j16, t16 = _batchers(11, kw, **cfg)
    for b, mod in ((j8, jsv), (t8, tsv), (j16, jsv), (t16, tsv)):
        b.submit(mod.Request("r", seq_len=128, num_steps=2))
        b.step()
    tx8, tx16 = t8.x[0].numpy(), t16.x[0].numpy()
    jx8, jx16 = np.asarray(j8.x[0]), np.asarray(j16.x[0])
    effect = _rel(tx8 - tx16, jx8 - jx16)
    print(f"one a8 step vs JAX's: x rel {_rel(tx8, jx8):.3g}; a8 vs bf16 step "
          f"rel {_rel(tx8, tx16):.3g} (JAX {_rel(jx8, jx16):.3g}); the int8 "
          f"path's effect on x, port vs JAX: rel {effect:.3g}")
    np.testing.assert_allclose(t8.x.numpy(), np.asarray(j8.x), rtol=2e-3,
                               atol=2e-3)
    assert 0 < _rel(tx8, tx16) < 5e-2
    assert effect < 0.2
    assert np.all(t8.x[1].numpy() == 0)


def test_drained_run_a8_stays_near_the_bf16_run():
    """A drained run with attn_act_bits=8 (mixed lengths, a mid-run
    admission, the 8 -> 4 -> 2 schedule, pages of 8 in fused chunks)
    completes every request with finite embeddings near the bf16 run's.
    JAX takes its exact fall-back at such pages, so it is the bf16 run that
    the int8 one is held to: embeddings within 5e-2 relative."""
    kw = dict(num_slots=2, seq_len=8, page_size=8, attend_mode="paged",
              max_chunk=16)
    _, t8 = _batchers(3, dict(kw, attn_act_bits=8))
    jb, t16 = _batchers(3, kw)
    d8, d16, dj = _drain(t8, tsv), _drain(t16, tsv), _drain(jb, jsv)
    assert sorted(d8) == sorted(d16) == ["a", "b", "c"]
    for rid in d16:
        rel = _rel(d8[rid].embeddings, d16[rid].embeddings)
        print(f"drained a8 run, request {rid}: embeddings rel {rel:.3g} of the "
              f"bf16 run, {_rel(d8[rid].embeddings, dj[rid].embeddings):.3g} "
              f"of JAX's")
        assert np.isfinite(d8[rid].embeddings).all() and 0 < rel < 5e-2
        assert d8[rid].steps == d16[rid].steps


def _drain(b, mod):
    for rid, n, steps in (("a", 8, 30), ("b", 4, 5), ("c", 8, 7)):
        b.submit(mod.Request(rid, seq_len=n, num_steps=steps))
    return {c.request_id: c for c in b.run_until_drained()}


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_drained_run_matches_jax(mode):
    """Mixed lengths and step counts, a queued request admitted mid-run,
    and a 30-step request crossing the prefill -> decode boundary (buckets
    8, 4 and 2). JAX runs per step, the port in fused chunks. Dense mode
    runs the same f32 einsum attention on both sides; paged mode (pages of
    4) JAX's exact f32 fallback against the port's bf16 twin, whose
    rounding reaches the embeddings through eps' small coefficient. Both
    measured near 2e-6 on the embeddings: bound 1e-4."""
    jb, tb = _batchers(3, dict(num_slots=2, seq_len=8, page_size=4,
                               attend_mode=mode, max_chunk=1),
                       dict(num_slots=2, seq_len=8, page_size=4,
                            attend_mode=mode, max_chunk=16))
    jdone, tdone = _drain(jb, jsv), _drain(tb, tsv)
    assert sorted(jdone) == sorted(tdone) == ["a", "b", "c"]
    bound = 1e-4
    worst = max(np.abs(tdone[r].embeddings - jdone[r].embeddings).max()
                for r in jdone)
    print(f"drained run vs JAX, {mode}: embeddings max abs {worst:.3g}")
    for rid in jdone:
        np.testing.assert_allclose(tdone[rid].embeddings,
                                   jdone[rid].embeddings, rtol=bound,
                                   atol=bound)
        np.testing.assert_array_equal(tdone[rid].tokens, jdone[rid].tokens)
        assert tdone[rid].steps == jdone[rid].steps


@pytest.mark.parametrize("mode", ["paged", "dense"])
@pytest.mark.parametrize("salience", [False, True])
def test_fused_chunk_equals_per_step(mode, salience):
    """Chunks of up to 16 steps route bits (and, with salience, advance the
    score EMA and the page allocation) on the device; with max_chunk=1 the
    same state crosses to the host after every step. Same draws, same
    trajectories and scores, bit for bit."""
    _, tcfg, _, tparams = _models()

    def run(max_chunk):
        b = tsv.PagedContinuousBatcher(
            tparams, tcfg, num_slots=2, seq_len=16, page_size=4, seed=3,
            max_chunk=max_chunk, attend_mode=mode, salience_routing=salience,
            device="cpu", sanitize=True)
        b.submit(tsv.Request("a", seq_len=16, num_steps=30))
        b.submit(tsv.Request("b", seq_len=8, num_steps=5))
        b.submit(tsv.Request("c", seq_len=16, num_steps=7))
        done = {c.request_id: c.embeddings for c in b.run_until_drained()}
        return done, b.page_scores

    (per_step, s1), (chunked, s16) = run(1), run(16)
    assert sorted(per_step) == sorted(chunked) == ["a", "b", "c"]
    for rid in per_step:
        np.testing.assert_array_equal(per_step[rid], chunked[rid])
    np.testing.assert_array_equal(s1, s16)
    if salience:
        assert float(np.ptp(s16[0])) > 0   # the proxy discriminates pages


def test_hbm_budget_spills_bit_exactly():
    """Under a budget of about one pool, idle buckets move to the host tier
    and come back when the router needs them; trajectories are bit-equal to
    the unbudgeted run (every page is rewritten each step)."""
    _, tcfg, _, tparams = _models()

    def run(budget):
        b = tsv.PagedContinuousBatcher(
            tparams, tcfg, num_slots=2, seq_len=8, page_size=4, seed=3,
            attend_mode="paged", hbm_budget_bytes=budget, max_chunk=4,
            device="cpu", sanitize=True)
        b.submit(tsv.Request("a", seq_len=8, num_steps=30))
        return b, {c.request_id: c.embeddings for c in b.run_until_drained()}

    b_free, out_free = run(None)
    assert b_free.spilled_buckets() == ()
    one_pool = b_free.cache_memory_bytes() // len(b_free.buckets)
    spills, restores = (metrics.get("batcher.pool_spills"),
                        metrics.get("batcher.pool_restores"))
    b_tight, out_tight = run(one_pool + 1)
    assert metrics.get("batcher.pool_spills") > spills
    assert metrics.get("batcher.pool_restores") > restores
    assert b_tight.spilled_buckets()
    assert b_tight.cache_memory_bytes() < b_free.cache_memory_bytes()
    np.testing.assert_array_equal(out_free["a"], out_tight["a"])


def test_batcher_contract():
    """Validation, auto mode, pool-free dense mode, untouched inactive
    slots, and the int8 attention path accepted."""
    _, tcfg, _, tparams = _models()

    def make(**kw):
        base = dict(num_slots=2, seq_len=8, page_size=4, device="cpu")
        base.update(kw)
        return tsv.PagedContinuousBatcher(tparams, tcfg, **base)

    with pytest.raises(ValueError):
        make(page_size=3)
    with pytest.raises(ValueError, match="max_chunk"):
        make(max_chunk=0)
    with pytest.raises(ValueError, match="attn_act_bits"):
        make(attend_mode="paged", attn_act_bits=4)
    assert make(attend_mode="paged", attn_act_bits=8).attn_act_bits == 8
    assert make(attend_mode="dense", attn_act_bits=8).pools == {}
    b = make(attend_mode="auto")
    assert b.attend_mode == "dense" and b.pools == {}
    assert b.cache_memory_bytes() == 0
    b = make(attend_mode="paged", max_chunk=1)
    x1 = b.x[1].clone()
    b.submit(tsv.Request("solo", seq_len=8, num_steps=2))
    assert b.step() == 1 and torch.equal(b.x[1], x1)
    with pytest.raises(ValueError):
        b.submit(tsv.Request("long", seq_len=9, num_steps=2))
    with pytest.raises(ValueError):
        b.submit(tsv.Request("zero", seq_len=8, num_steps=0))
    done = b.run_until_drained()
    assert [c.request_id for c in done] == ["solo"]
    assert done[0].tokens.shape == (8,) and np.isfinite(done[0].embeddings).all()
    assert b.stats() == {"queued": 0, "active": 0, "completed": 0}
    assert math.isfinite(done[0].latency_s) and done[0].latency_s >= 0


def test_continuous_batcher_matches_jax():
    """The unpaged batcher (full-precision attention) against JAX's, with
    the key chain replayed: more requests than slots, mixed lengths and
    step counts; embeddings within 1e-5 and the same tokens."""
    jcfg, tcfg, jparams, tparams = _models()
    jb = jsv.ContinuousBatcher(jparams, jcfg, num_slots=2, seq_len=8, seed=5)
    tb = tsv.ContinuousBatcher(tparams, tcfg, num_slots=2, seq_len=8, seed=5,
                               device="cpu", noise=JaxNoise(5))
    jdone, tdone = _drain(jb, jsv), _drain(tb, tsv)
    assert sorted(tdone) == sorted(jdone) == ["a", "b", "c"]
    for rid in jdone:
        np.testing.assert_allclose(tdone[rid].embeddings,
                                   jdone[rid].embeddings, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tdone[rid].tokens, jdone[rid].tokens)


def test_sanitizers_catch_broken_slot_state_and_reentry():
    """With `sanitize`, a slot whose timestep and occupancy disagree, or a
    bucket both resident and spilled, fails loudly; a second entry into
    step() while one runs is refused."""
    from diffusion_llm_rs_tpu_torch.utils.sanitize import (
        SanitizerError, check_scheduler_invariants)

    _, tcfg, _, tparams = _models()
    b = tsv.PagedContinuousBatcher(tparams, tcfg, num_slots=2, seq_len=8,
                                   page_size=4, attend_mode="paged",
                                   device="cpu", sanitize=True)
    b.submit(tsv.Request("r", seq_len=8, num_steps=3))
    b.step()
    check_scheduler_invariants(b)
    b.t[1] = 0                               # no request in slot 1
    with pytest.raises(SanitizerError, match="occupancy"):
        check_scheduler_invariants(b)
    b.t[1] = -1
    b._spilled.add(b.buckets[0])
    with pytest.raises(SanitizerError, match="both resident and spilled"):
        check_scheduler_invariants(b)
    b._spilled.clear()
    with b._guard():
        with pytest.raises(SanitizerError, match="concurrent"):
            b.step()
