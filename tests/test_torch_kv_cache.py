"""Port parity: the phase-aware KV cache manager against the JAX package's:
the same K/V (from a numpy seed) go through the same calls; quantized bytes,
reconstructions, phase transitions, byte accounting and eviction agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.cache import kv_cache as jkv
from diffusion_llm_rs_tpu_torch.cache import kv_cache as tkv


def _kv(seq, seed=0, L=2, B=1, H=2, Hd=16):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, B, seq, H, Hd)).astype(np.float32)
    v = rng.normal(size=(L, B, seq, H, Hd)).astype(np.float32) * 3
    k[0, 0, 0, 0] = 0.5   # a constant row: range 0 takes scale 1
    return k, v


def _same_qt(jq, tq):
    assert np.array_equal(np.asarray(jq.data), tq.data.numpy())
    assert np.array_equal(np.asarray(jq.scale), tq.scale.numpy())
    assert np.array_equal(np.asarray(jq.zero_point), tq.zero_point.numpy())
    assert (jq.bits, tuple(jq.shape), jq.granularity, jq.axis) == \
        (tq.bits, tuple(tq.shape), tq.granularity, tq.axis)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantized_entry_equals_jax_bit_for_bit(bits):
    k, v = _kv(8)
    je = jkv.QuantizedKVEntry.create(jnp.asarray(k), jnp.asarray(v), bits)
    te = tkv.QuantizedKVEntry.create(torch.from_numpy(k), torch.from_numpy(v),
                                     bits)
    _same_qt(je.keys, te.keys)
    _same_qt(je.values, te.values)
    assert te.seq_len == je.seq_len == 8
    assert te.memory_usage() == je.memory_usage()
    assert np.array_equal(np.asarray(je.dequantize_keys()),
                          te.dequantize_keys().numpy())
    assert np.array_equal(np.asarray(je.dequantize_values()),
                          te.dequantize_values().numpy())


def _entries(seq=8, **kw):
    k, v = _kv(seq)
    return (jkv.KVCacheEntry(jnp.asarray(k), jnp.asarray(v), **kw),
            tkv.KVCacheEntry(torch.from_numpy(k), torch.from_numpy(v), **kw))


def _same_state(je, te):
    assert te.is_prefill_phase == je.is_prefill_phase
    assert te.get_current_quant_bits() == je.get_current_quant_bits()
    assert te.memory_usage() == je.memory_usage()
    assert len(te) == len(je) and te.is_empty() == je.is_empty()
    assert np.array_equal(np.asarray(je.get_keys()), te.get_keys().numpy())
    assert np.array_equal(np.asarray(je.get_values()), te.get_values().numpy())
    jq, tq = je.get_quantized(), te.get_quantized()
    assert (jq is None) == (tq is None)
    if jq is not None:
        _same_qt(jq.keys, tq.keys)


def test_phase_transitions_and_progressive_precision():
    je, te = _entries(prefill_bits=8, decode_bits=4)
    _same_state(je, te)
    for e in (je, te):
        e.set_phase(False)            # builds the decode copy lazily
    _same_state(je, te)
    assert te.get_current_quant_bits() == 4
    for e in (je, te):
        e.set_decode_bits(2)          # drops the decode copy, rebuilt at 2
    _same_state(je, te)
    k2, v2 = _kv(12, seed=1)
    je.update(jnp.asarray(k2), jnp.asarray(v2))
    te.update(torch.from_numpy(k2), torch.from_numpy(v2))
    _same_state(je, te)               # decode-phase update: prefill copy gone
    assert te._prefill_quantized is None
    for e in (je, te):
        e.transition_phase(True)      # and back: prefill copy rebuilt lazily
    _same_state(je, te)
    assert te.get_quantized() is not None and len(te) == 12


def test_unquantized_entry_serves_full_precision():
    je, te = _entries(prefill_bits=0, decode_bits=0)
    _same_state(je, te)
    assert te.get_quantized() is None
    assert te.memory_usage() == 2 * 2 * 8 * 2 * 16 * 4


def test_manager_accounting_matches_jax():
    jm = jkv.KVCacheManager(max_cache_size=1 << 20, prefill_bits=8,
                            decode_bits=4)
    tm = tkv.KVCacheManager(max_cache_size=1 << 20, prefill_bits=8,
                            decode_bits=4, device="cpu")
    for i, seq in enumerate((8, 16, 4)):
        k, v = _kv(seq, seed=i)
        jm.update(f"c{i}", jnp.asarray(k), jnp.asarray(v))
        tm.update(f"c{i}", torch.from_numpy(k), torch.from_numpy(v))
        assert tm.memory_usage() == jm.memory_usage() > 0
    assert len(tm) == len(jm) == 3
    # a shrinking entry lowers the accounting (decode phase, fewer bits)
    for m in (jm, tm):
        m.get("c1").set_phase(False)
    k, v = _kv(16, seed=9)
    jm.update("c1", jnp.asarray(k), jnp.asarray(v))
    tm.update("c1", torch.from_numpy(k), torch.from_numpy(v))
    assert tm.memory_usage() == jm.memory_usage()
    assert tm.get("c1").memory_usage() == jm.get("c1").memory_usage()
    assert tm.get("nope") is None
    je, te = jm.get_or_init("new", 2, 1, 2, 16), tm.get_or_init("new", 2, 1, 2, 16)
    assert te.is_empty() and je.is_empty() and len(tm) == len(jm) == 4
    assert tm.get_or_init("new", 2, 1, 2, 16) is te
    for m in (jm, tm):
        m.clear()
    assert tm.memory_usage() == jm.memory_usage() == 0 and len(tm) == 0


def test_eviction_frees_largest_first_as_jax():
    budget = 6000
    jm = jkv.KVCacheManager(max_cache_size=budget)
    tm = tkv.KVCacheManager(max_cache_size=budget, device="cpu")
    for i, seq in enumerate((4, 8, 2, 8)):
        k, v = _kv(seq, seed=i)
        jm.update(f"c{i}", jnp.asarray(k), jnp.asarray(v))
        tm.update(f"c{i}", torch.from_numpy(k), torch.from_numpy(v))
        assert sorted(tm._entries) == sorted(jm._entries)
        assert tm.memory_usage() == jm.memory_usage()
    assert len(tm) < 4                       # something was evicted
    assert tm.evict(1) == jm.evict(1) > 0
    assert sorted(tm._entries) == sorted(jm._entries)
    assert tm.memory_usage() == jm.memory_usage()
