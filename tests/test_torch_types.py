"""Port parity: `models.types` against the JAX package's, on the CPU.

TokenizedVector's mask and JSON round trip, Normalizer, WeightManager and
PrefillKVQuant: the same numpy inputs, made from a seed, through both
packages. Tolerances: masks, JSON, bf16 weights and compressed bytes are
equal; the Normalizer's mean and standard deviation (f32 sums in another
order) within 1e-6 relative, its outputs within 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.models import types as jt
from diffusion_llm_rs_tpu_torch.models import types as tt

CPU = "cpu"


def _bf16_np(x):
    return np.asarray(torch.as_tensor(x).float())


def test_tokenized_vector_mask_and_json_equal_jax():
    emb = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    mask = np.random.default_rng(1).random((3, 6)).astype(np.float32)
    j = jt.TokenizedVector(id="v", tokens=[1, 2, 3, 4, 5], embeddings=emb)
    t = tt.TokenizedVector(id="v", tokens=[1, 2, 3, 4, 5], embeddings=emb)
    j.apply_mask(mask, offset=3)
    t.apply_mask(mask, offset=3)
    assert np.array_equal(j.embeddings, t.embeddings) and t.offset == 3
    assert np.array_equal(t.embeddings[:3], emb[:3])   # the input is kept
    assert t.to_json() == j.to_json()
    rt = tt.TokenizedVector.from_json(j.to_json())
    assert rt.id == "v" and rt.tokens == [1, 2, 3, 4, 5] and rt.offset == 3
    assert np.array_equal(rt.embeddings, t.embeddings)
    assert np.array_equal(rt.attention_mask, mask)
    bare = tt.TokenizedVector.from_json(
        jt.TokenizedVector(id="b", tokens=[], embeddings=emb).to_json())
    assert bare.attention_mask is None and bare.offset == 0


@pytest.mark.parametrize("data", [
    np.array([1.0, 2.0, 3.0, 4.0]),
    np.random.default_rng(2).normal(3.0, 2.0, size=(37, 5)),
    np.full(4, 7.0)])
def test_normalizer_equals_jax(data):
    j, t = jt.Normalizer.fit(data), tt.Normalizer.fit(data)
    assert t.mean == pytest.approx(j.mean, rel=1e-6, abs=1e-7)
    assert t.std == pytest.approx(j.std, rel=1e-6)
    x = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    # the same statistics: the same f32 operations, bit for bit
    t.mean, t.std = j.mean, j.std
    assert np.array_equal(np.asarray(j.normalize(x)), t.normalize(x).numpy())
    assert np.array_equal(np.asarray(j.denormalize(x)),
                          t.denormalize(x).numpy())
    norm = t.normalize(data).numpy()
    if data.std() > 0:
        assert abs(norm.mean()) < 1e-6 and abs(norm.std() - 1) < 1e-6
    else:
        assert t.std == 1.0   # the constant-data guard


@pytest.mark.parametrize("lr", [1.0, 1e-3, 0.3])
def test_weight_manager_equals_jax(lr):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    g1, g2 = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(2))
    j, t = jt.WeightManager(), tt.WeightManager(device=CPU)
    for m in (j, t):
        m.set_weight("w", w)
        m.set_weight("other", w)
        m.update_gradient("w", g1)
        m.update_gradient("w", g2)      # accumulates
        m.update_gradient("orphan", g1)  # no weight: dropped
    assert np.array_equal(_bf16_np(np.asarray(j.get_gradient("w"),
                                              np.float32)),
                          _bf16_np(t.get_gradient("w")))
    j.apply_gradients(lr=lr)
    t.apply_gradients(lr=lr)
    assert t.get_weight("w").dtype == torch.bfloat16
    assert np.array_equal(np.asarray(j.get_weight("w"), np.float32),
                          _bf16_np(t.get_weight("w")))
    assert np.array_equal(np.asarray(j.get_weight("other"), np.float32),
                          _bf16_np(t.get_weight("other")))
    assert t.get_gradient("w") is None and t.get_weight("missing") is None


@pytest.mark.parametrize("bits", [(8, 4), (8, 4, 2, 1), None])
def test_prefill_kv_quant_equals_jax(bits):
    tvs = [np.random.default_rng(i).normal(size=(2, 8)).astype(np.float32)
           for i in range(5)]
    j = jt.PrefillKVQuant(quantization_bits=(8, 4))
    t = tt.PrefillKVQuant(quantization_bits=(8, 4), device=CPU)
    want = j.quantize_vectors([jt.TokenizedVector(f"t{i}", [i], e)
                               for i, e in enumerate(tvs)], bits)
    got = t.quantize_vectors([tt.TokenizedVector(f"t{i}", [i], e)
                              for i, e in enumerate(tvs)], bits)
    assert [v.bits for v in got] == [v.bits for v in want]
    for a, b in zip(want, got):
        assert a.id == b.id and a.original_shape == b.original_shape
        assert np.array_equal(np.asarray(a.data), b.data)
        assert (a.quant_scale, a.quant_zero_point) == \
            (b.quant_scale, b.quant_zero_point)
    assert t.compression_ratio == j.compression_ratio > 4.0
    deq = got[0].dequantize().reshape(2, 8)
    np.testing.assert_allclose(deq, tvs[0], atol=0.05)


def test_prefill_kv_quant_rejects_bad_bits():
    with pytest.raises(ValueError):
        tt.PrefillKVQuant(quantization_bits=(3,), device=CPU)
