"""Port parity: page quantization, `PagedKVCache` and `MemoryManager`
against the JAX package, on the CPU.

`quantize_page` must equal JAX's bit for bit (packed bytes, scale and
zero-point): pools cross between the packages unchanged. XLA on the CPU
divides exactly in `rng / qmax` and `x / scale`, as the port's true
division does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.cache import memory_manager as jmm
from diffusion_llm_rs_tpu.cache import paged as jpaged
from diffusion_llm_rs_tpu_torch.cache import memory_manager as tmm
from diffusion_llm_rs_tpu_torch.cache import paged as tpaged


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_page_bit_equal_to_jax(bits):
    rng = np.random.default_rng(bits)
    # per-token ranges spanning four decades, a constant token (range 0)
    x = (rng.normal(size=(6, 64, 32)) *
         10.0 ** rng.uniform(-2, 2, size=(6, 64, 1))).astype(np.float32)
    x[2, 5] = 0.75
    jd, js, jz = jpaged.quantize_page(jnp.asarray(x), bits)
    td, ts, tz = tpaged.quantize_page(torch.from_numpy(x), bits)
    assert td.dtype == torch.uint8 and td.shape == (6, 64 // (8 // bits), 32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        tpaged.dequantize_page(td, ts, tz, bits).numpy(),
        np.asarray(jpaged.dequantize_page(jd, js, jz, bits)))


def _kv(rng, bh, S, D):
    return [rng.normal(size=(bh, S, D)).astype(np.float32) for _ in range(2)]


def _caches(bh=2, D=64, P=64, pages=None, with_mm=False):
    pages = pages or {8: 8, 4: 8, 2: 8}
    j = jpaged.PagedKVCache(bh=bh, head_dim=D, page_size=P,
                            pages_per_bits=pages)
    t = tpaged.PagedKVCache(bh=bh, head_dim=D, page_size=P,
                            pages_per_bits=pages, device="cpu",
                            memory_manager=(tmm.MemoryManager(device="cpu")
                                            if with_mm else None))
    return j, t


def _same_pools(j, t):
    for bits, pool in j._pools.items():
        tp = t._pools[bits]
        for name in tpaged.POOL_FIELDS:
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(pool, name)))
        assert tp.free == pool.free


def test_append_gather_free_match_jax():
    """Pools, page tables and the dequantized gather equal JAX's exactly,
    through appends at two widths, a partial tail page, and a free."""
    rng = np.random.default_rng(0)
    j, t = _caches()
    k, v = _kv(rng, 2, 150, 64)          # 3 pages, the last 22 tokens
    k2, v2 = _kv(rng, 2, 64, 64)
    for cache, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        cache.append("a", conv(k), conv(v), bits=4)
        cache.append("b", conv(k2), conv(v2), bits=8)
    _same_pools(j, t)
    assert [(h.bits, h.slot, h.tokens) for h in t.page_tables["a"]] == \
        [(h.bits, h.slot, h.tokens) for h in j.page_tables["a"]]
    assert t.seq_len("a") == j.seq_len("a") == 150
    assert t.memory_usage() == j.memory_usage()
    for sid in ("a", "b"):
        for tg, jg in zip(t.gather(sid), j.gather(sid)):
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert t.free("a") == j.free("a") == 3
    _same_pools(j, t)
    with pytest.raises(KeyError):
        t.gather("a")
    qk, qv = t.gather_packed("b")   # a uniform chain repacks along D
    assert qk.shape == qv.shape == (2, 64, 64) and qk.bits == 8


def test_mixed_precision_attend_and_batched_attend():
    """A salience-allocated chain (pages at several widths) and a second
    sequence: `attend` and `batched_attend` merge one call per bucket. JAX
    takes its exact f32 fallbacks at pages of 64, the port its twins (bf16
    q and P): 2e-2 relative, the kernel-vs-fallback bound of the JAX tests.
    An inactive slot reads zeros."""
    rng = np.random.default_rng(1)
    j, t = _caches()
    k, v = _kv(rng, 2, 256, 64)
    scores = rng.random(256).astype(np.float32)
    k2, v2 = _kv(rng, 2, 100, 64)
    for cache, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        cache.append_salient("s", conv(k), conv(v), scores, budget_bits=4.0,
                             bit_options=(8, 4, 2))
        cache.append("u", conv(k2), conv(v2), bits=4)
    _same_pools(j, t)
    assert len({h.bits for h in t.page_tables["s"]}) > 1
    q = rng.normal(size=(2, 20, 64)).astype(np.float32)
    ja = j.attend("s", jnp.asarray(q))
    ta = t.attend("s", torch.from_numpy(q))
    print(f"attend vs JAX: rel {_rel(ta.numpy(), ja):.3g}")
    assert _rel(ta.numpy(), ja) < 2e-2
    qb = rng.normal(size=(3, 2, 20, 64)).astype(np.float32)
    jb = j.batched_attend(["s", None, "u"], jnp.asarray(qb))
    tb = t.batched_attend(["s", None, "u"], torch.from_numpy(qb))
    print(f"batched_attend vs JAX: rel {_rel(tb.numpy(), jb):.3g}")
    assert _rel(tb.numpy(), jb) < 2e-2
    assert np.all(tb[1].numpy() == 0)
    assert torch.all(t.batched_attend([None] * 3, torch.from_numpy(qb)) == 0)
    with pytest.raises(KeyError):
        t.batched_attend(["nope", None, None], torch.from_numpy(qb))


def test_spill_and_restore_are_bit_exact():
    """A spilled page leaves its slot; `attend` restores it from the host
    tier into a fresh slot and reads the same values as before; a spilled
    page freed with its sequence releases its host payload."""
    rng = np.random.default_rng(2)
    _, t = _caches(with_mm=True)
    k, v = _kv(rng, 2, 192, 64)
    t.append("s", torch.from_numpy(k), torch.from_numpy(v), bits=4)
    q = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    before = t.attend("s", q)
    gathered = t.gather("s")
    free_before = t.num_free(4)
    t.spill_page("s", 1)
    t.spill_page("s", 1)                    # a second spill is a no-op
    assert t.page_tables["s"][1].slot == -1
    assert t.num_free(4) == free_before + 1
    assert t.memory_manager.usage("host") > 0
    # the freed slot is reused and overwritten while the page is away
    t.append("x", torch.from_numpy(k[:, :64]), torch.from_numpy(v[:, :64]), 4)
    torch.testing.assert_close(t.attend("s", q), before, rtol=0, atol=0)
    assert t.page_tables["s"][1].slot != -1
    for a, b in zip(t.gather("s"), gathered):
        assert torch.equal(a, b)
    t.spill_page("s", 2)
    assert t.free("s") == 3
    assert t.memory_manager.keys() == []


def test_memory_manager_tiers_match_jax(tmp_path):
    """Budgets, LRU demotion to disk and promotion on access behave as in
    the JAX manager; the device tier is a tensor on the manager's device."""
    t = tmm.MemoryManager(hbm_budget=64, host_budget=100,
                          spill_dir=str(tmp_path / "t"), device="cpu")
    j = jmm.MemoryManager(hbm_budget=64, host_budget=100,
                          spill_dir=str(tmp_path / "j"))
    for m in (t, j):
        m.allocate("a", np.arange(16, dtype=np.float32), tier="host")
        m.allocate("b", np.arange(16, dtype=np.float32) + 1, tier="host")
        m.allocate("c", np.zeros(8, np.float32), tier="hbm")
    for m in (t, j):
        assert m.tier_of("a") == "disk" and m.tier_of("b") == "host"
        assert m.usage("host") == 64 and m.usage("disk") == 64
    assert isinstance(t.get("c"), torch.Tensor)
    np.testing.assert_array_equal(t.get("a"), np.arange(16, dtype=np.float32))
    assert t.tier_of("a") == "host" and t.tier_of("b") == "disk"
    with pytest.raises(tmm.AlreadyAllocatedError):
        t.allocate("a", b"xy", tier="host")
    for key in ("a", "b", "c"):
        t.deallocate(key)
    assert t.usage() == 0 and t.keys() == []
    with pytest.raises(tmm.NotFoundError):
        t.get("a")


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_gather_packed_equal_to_jax(bits):
    """A uniform chain of 3 pages, the last 22 tokens, repacked from the
    pools' token packing into the contiguous D-packed `QuantKV`: bytes,
    scales and zero-points equal JAX's, nothing is requantized (the
    dequantized values equal `gather`'s), and the quantized-KV attention
    over them equals paged attention over the pages to the twins' bound."""
    from diffusion_llm_rs_tpu_torch.ops import attention as tat
    rng = np.random.default_rng(40 + bits)
    j, t = _caches(pages={bits: 8})
    k, v = _kv(rng, 2, 150, 64)
    for cache, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        cache.append("a", conv(k), conv(v), bits=bits)
    _same_pools(j, t)
    for tq, jq in zip(t.gather_packed("a"), j.gather_packed("a")):
        assert (tq.bits, tq.D, tq.shape) == (jq.bits, jq.D, jq.shape)
        assert tq.shape == (2, 150, 64)
        np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        np.testing.assert_array_equal(tq.zero_point.numpy(),
                                      np.asarray(jq.zero_point))
    for tq, dense in zip(t.gather_packed("a"), t.gather("a")):
        np.testing.assert_array_equal(tq.dequantize().numpy(), dense.numpy())
    q = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    rel = _rel(tat.attention(q, *t.gather_packed("a")), t.attend("a", q))
    print(f"attention over gather_packed vs attend, {bits}-bit: rel {rel:.3g}")
    assert rel < 5e-3


def test_gather_packed_refuses_what_it_cannot_repack():
    rng = np.random.default_rng(50)
    _, t = _caches(with_mm=True)
    k, v = (torch.from_numpy(a) for a in _kv(rng, 2, 100, 64))
    with pytest.raises(KeyError):
        t.gather_packed("nobody")
    t.append("mixed", k[:, :64], v[:, :64], bits=4)
    t.append("mixed", k[:, 64:], v[:, 64:], bits=8)
    with pytest.raises(ValueError, match="mixed-precision"):
        t.gather_packed("mixed")
    t.append("holes", k[:, :30], v[:, :30], bits=4)   # a partial page ...
    t.append("holes", k[:, 30:94], v[:, 30:94], bits=4)  # ... then a full one
    with pytest.raises(ValueError, match="interior partial page"):
        t.gather_packed("holes")
    # a spilled page comes back before it is repacked
    t.append("s", k, v, bits=2)
    want = [a.data.clone() for a in t.gather_packed("s")]
    t.spill_page("s", 0)
    assert t.page_tables["s"][0].slot == -1
    for a, b in zip(t.gather_packed("s"), want):
        assert torch.equal(a.data, b)
