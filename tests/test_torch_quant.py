"""Port parity: quant/core.py and the weight layouts, bit for bit.

The same numpy inputs go through the JAX package and the PyTorch port; packed
bytes, scales, zero-points, the block-packed MatmulWeight and the decoded
Int8Weight must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.ops.matmul import decode_to_int8 as j_decode
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as tim
from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8 as t_decode
from diffusion_llm_rs_tpu_torch.quant import core as tq


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _weights(K, N, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, N)) * 0.05 + shift).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("last", [8, 13])
def test_pack_unpack_bit_exact(bits, last):
    rng = np.random.default_rng(bits * 100 + last)
    q = rng.integers(0, 1 << bits, size=(3, 5, last)).astype(np.uint8)
    jp = jq.pack_bits(jnp.asarray(q), bits)
    tp = tq.pack_bits(torch.from_numpy(q), bits)
    _same(tp, jp)
    _same(tq.unpack_bits(tp, bits, last), jq.unpack_bits(jp, bits, last))
    _same(tq.unpack_bits(tp, bits, last), q)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("granularity,kw", [
    ("tensor", {}),
    ("channel", {"axis": 1}),
    ("group", {"group_size": 32, "axis": 0}),
])
def test_quantize_bit_exact(bits, symmetric, granularity, kw):
    # a positive shift makes min > 0 for some groups: the unclamped
    # asymmetric zero-point must match too
    w = _weights(64, 24, seed=bits, shift=0.03)
    jt = jq.quantize(jnp.asarray(w), bits, symmetric=symmetric,
                     granularity=granularity, **kw)
    tt = tq.quantize(torch.from_numpy(w), bits, symmetric=symmetric,
                     granularity=granularity, **kw)
    _same(tt.data, jt.data)
    _same(tt.scale, jt.scale)
    _same(tt.zero_point, jt.zero_point)
    assert (tt.shape, tt.axis, tt.granularity) == (jt.shape, jt.axis,
                                                   jt.granularity)
    _same(tt.dequantize(), jt.dequantize())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("symmetric", [False, True])
def test_prepare_and_decode_bit_exact(bits, symmetric):
    w = _weights(256, 96, seed=7 + bits)
    jt = jq.quantize(jnp.asarray(w), bits, symmetric=symmetric,
                     granularity="group", group_size=128, axis=0)
    tt = tq.quantize(torch.from_numpy(w), bits, symmetric=symmetric,
                     granularity="group", group_size=128, axis=0)
    jm = jpm.prepare(jt, act_bits=8)
    tm = tim.prepare(tt, act_bits=8)
    _same(tm.data, jm.data)
    _same(tm.scale, jm.scale)
    _same(tm.zero_point, jm.zero_point)
    _same(tm.col_scale, jm.col_scale)
    assert (tm.K, tm.N, tm.group_size, tm.bits) == (jm.K, jm.N, jm.group_size,
                                                    jm.bits)
    _same(tm.dequantize(), jm.dequantize())
    j8, t8 = j_decode(jm), t_decode(tm)
    _same(t8.data, j8.data)
    _same(t8.col_scale, j8.col_scale)
    # straight from a QuantizedTensor, and from an act_bits=16 layout
    _same(t_decode(tt).data, j_decode(jt).data)
    _same(t_decode(tim.prepare(tt)).data, j_decode(jpm.prepare(jt)).data)


def test_quantize_tree_matches_jax():
    """Group quantization along K, the per-channel fallback for a vocab-sized
    leaf, the pos_embed exclusion and the small-leaf rule."""
    rng = np.random.default_rng(3)
    tree = {
        "tok_embed": rng.normal(size=(200, 64)).astype(np.float32),
        "pos_embed": rng.normal(size=(32, 64)).astype(np.float32),
        "blocks": [{"w": rng.normal(size=(128, 64)).astype(np.float32),
                    "b": rng.normal(size=(64,)).astype(np.float32)}],
        "small": rng.normal(size=(8, 8)).astype(np.float32),
    }
    jt = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), 4,
                          symmetric=True)
    tt = tq.quantize_tree(jax.tree_util.tree_map(torch.from_numpy, tree), 4,
                          symmetric=True)
    for path in (("tok_embed",), ("blocks", 0, "w")):
        j, t = jt, tt
        for p in path:
            j, t = j[p], t[p]
        assert isinstance(t, tq.QuantizedTensor)
        assert t.granularity == j.granularity
        _same(t.data, j.data)
        _same(t.scale, j.scale)
    assert tt["tok_embed"].granularity == "channel"
    for key in ("pos_embed", "small"):
        assert isinstance(tt[key], torch.Tensor)
    assert isinstance(tt["blocks"][0]["b"], torch.Tensor)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantized_tensor_dtype_matches_jax(bits):
    """`QuantizedTensor.dtype` is the dtype `dequantize` gives by default:
    float32 in both packages."""
    w = _weights(64, 64, bits)
    jt = jq.quantize(jnp.asarray(w), bits)
    tt = tq.quantize(torch.from_numpy(w), bits)
    assert np.dtype(jt.dtype) == np.float32
    assert tt.dtype == torch.float32
    assert tt.dequantize().dtype == tt.dtype
    assert np.dtype(jq.dequantize(jt).dtype) == np.dtype(jt.dtype)
