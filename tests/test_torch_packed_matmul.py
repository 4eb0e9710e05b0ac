"""Port parity: the packed-weight matmul (`ops/packed_matmul.py`), `linear`
over every weight layout, and FP8 storage, against the JAX package on the CPU.

The JAX `pallas_matmul.matmul` runs its Pallas kernels in interpret mode off
the TPU (and its XLA fall-back for shapes its kernels do not take); the port
runs the plain versions its CUDA kernel is held against on the card. Inputs
come from numpy seeds and go to both. Each test prints what it measured
(`pytest -rP`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import matmul as jmm
from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu_torch.ops import matmul as tmm
from diffusion_llm_rs_tpu_torch.ops import packed_matmul as tpm
from diffusion_llm_rs_tpu_torch.quant import core as tq
from diffusion_llm_rs_tpu_torch.weights import from_jax_params


def _pair(K, N, bits, gran="group", group=128, act_bits=16, seed=0):
    """The same weight quantized and prepared in both packages."""
    w = (np.random.default_rng(seed).normal(size=(K, N)) * 0.02).astype(
        np.float32)
    kw = (dict(symmetric=True, granularity="group", group_size=group, axis=0)
          if gran == "group" else
          dict(granularity="channel", axis=1) if gran == "channel" else
          dict(granularity="tensor"))
    jw = jpm.prepare(jq.quantize(jnp.asarray(w), bits, **kw), act_bits=act_bits)
    tw = tpm.prepare(tq.quantize(torch.from_numpy(w), bits, **kw),
                     act_bits=act_bits)
    return jw, tw


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_same_weight(jw, tw):
    for name in ("data", "scale", "zero_point"):
        assert np.array_equal(np.asarray(getattr(jw, name)),
                              getattr(tw, name).numpy()), name
    assert (jw.bits, jw.K, jw.N, jw.group_size, jw.act_bits) == \
        (tw.bits, tw.K, tw.N, tw.group_size, tw.act_bits)
    if jw.col_scale is None:
        assert tw.col_scale is None
    else:
        assert np.array_equal(np.asarray(jw.col_scale), tw.col_scale.numpy())


# bf16 operands are identical on both sides and the products are summed in
# f32 in another order (K <= 512 terms of size <= 0.3): |d| <= 2e-5 absolute
# on outputs of order 1. The a8 side multiplies exact integers, then scales in
# f32 in the same order: the same bound, with room for XLA's fused multiplies.
ATOL = 2e-5


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("gran", ["group", "channel", "tensor"])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_matmul_matches_jax_kernel(bits, gran, act_bits):
    jw, tw = _pair(512, 128, bits, gran, act_bits=act_bits, seed=bits)
    _assert_same_weight(jw, tw)
    x = _x((16, 512))
    b = _x((128,), seed=2) * 0.1
    for bias, act in ((None, None), (b, "gelu")):
        jo = np.asarray(jpm.matmul(
            jnp.asarray(x), jw, bias=None if bias is None else jnp.asarray(bias),
            activation=act))
        to = tpm.matmul(torch.from_numpy(x), tw,
                        bias=None if bias is None else torch.from_numpy(bias),
                        activation=act).numpy()
        err = float(np.abs(jo - to).max())
        print(f"bits={bits} {gran} act{act_bits} bias={bias is not None} "
              f"act={act}: max |d| {err:.3g} of {np.abs(jo).max():.3g}")
        assert to.dtype == np.float32 and err <= ATOL


@pytest.mark.parametrize("act_bits", [16, 8])
def test_int2_segmentation_and_small_groups(act_bits):
    """int2 at K=512 (Kp=128, segments of gcd(G, Kp)) as the JAX package's
    own kernel test; and groups of 32, several to a bit-field."""
    for K, N, bits, group in ((512, 128, 2, 128), (256, 128, 4, 32),
                              (256, 128, 1, 32)):
        jw, tw = _pair(K, N, bits, group=group, act_bits=act_bits, seed=K + bits)
        _assert_same_weight(jw, tw)
        x = _x((8, K), seed=2)
        jo = np.asarray(jpm.matmul(jnp.asarray(x), jw))
        to = tpm.matmul(torch.from_numpy(x), tw).numpy()
        err = float(np.abs(jo - to).max())
        print(f"K={K} bits={bits} G={group} act{act_bits}: max |d| {err:.3g}")
        assert err <= ATOL


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("shape,N", [((2, 8, 256), 256), ((5, 256), 256),
                                     ((3, 256), 96), ((16, 256), 96)])
def test_3d_input_and_jax_fallback_shapes(act_bits, shape, N):
    """3-D x, and the shapes the JAX package hands to its XLA fall-back
    (M % 8 != 0, N % 128 != 0): the port's plain versions serve them all."""
    jw, tw = _pair(256, N, 4, act_bits=act_bits, seed=N)
    x = _x(shape, seed=3)
    b = _x((N,), seed=4) * 0.1
    jo = np.asarray(jpm.matmul(jnp.asarray(x), jw, bias=jnp.asarray(b),
                               activation="gelu"))
    to = tpm.matmul(torch.from_numpy(x), tw, bias=torch.from_numpy(b),
                    activation="gelu").numpy()
    err = float(np.abs(jo - to).max())
    print(f"x{shape} N={N} act{act_bits}: max |d| {err:.3g}")
    assert to.shape == shape[:-1] + (N,) and err <= ATOL


@pytest.mark.parametrize("act_bits", [16, 8])
def test_bf16_in_and_out(act_bits):
    """bf16 activations and bf16 output: both sides round the f32 result
    once; a last-bit difference before it may move that rounding: one bf16
    ulp (2^-7 relative)."""
    jw, tw = _pair(256, 128, 4, act_bits=act_bits)
    x = _x((16, 256))
    b = _x((128,), seed=2) * 0.1
    jo = jpm.matmul(jnp.asarray(x).astype(jnp.bfloat16), jw,
                    out_dtype=jnp.bfloat16, bias=jnp.asarray(b),
                    activation="gelu")
    to = tpm.matmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                    out_dtype=torch.bfloat16, bias=torch.from_numpy(b),
                    activation="gelu")
    assert to.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
    jo = np.asarray(jo.astype(jnp.float32))
    to = to.float().numpy()
    moved = int((jo != to).sum())
    print(f"act{act_bits}: {moved} of {jo.size} bf16 outputs differ")
    np.testing.assert_allclose(to, jo, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("gran", ["group", "channel"])
def test_a8_regrid_equals_decode_to_int8_bit_for_bit(bits, gran):
    jw, tw = _pair(256, 128, bits, gran, act_bits=8, seed=bits + 10)
    jd = jmm.decode_to_int8(jw)
    grid = tpm.regrid_int8(tw)
    assert grid.dtype == torch.int8
    assert np.array_equal(np.asarray(jd.data), grid.numpy())
    td = tmm.decode_to_int8(tw)
    assert torch.equal(td.data, grid)
    assert np.array_equal(np.asarray(jd.col_scale), td.col_scale.numpy())


def test_quantize_act_i8_matches_jax():
    x = _x((7, 96)) * np.random.default_rng(5).uniform(0.01, 30, size=(7, 1)
                                                       ).astype(np.float32)
    x[3] = 0.0   # an all-zero row takes scale 1
    jxi, jsx = jpm.quantize_act_i8(jnp.asarray(x))
    txi, tsx = tpm.quantize_act_i8(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jxi), txi.numpy())
    assert np.array_equal(np.asarray(jsx), tsx.numpy())
    assert tsx.shape == (7, 1) and txi.dtype == torch.int8


def _both_linear(x, jw, tw, b=None, act=None, res=None, dtype=None):
    j = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jr, tr = j(res), t(res)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        jr = None if jr is None else jr.astype(jnp.bfloat16)
        tr = None if tr is None else tr.to(torch.bfloat16)
    jo = jmm.linear(jx, jw, j(b), activation=act, residual=jr)
    to = tmm.linear(tx, tw, t(b), activation=act, residual=tr)
    return (np.asarray(jo.astype(jnp.float32)), to.float().numpy(),
            jo.dtype, to.dtype)


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_over_matmul_weight_with_residual(act_bits, dtype):
    """The residual is added after the kernel's result was rounded to the
    output type (two roundings in bf16), in both packages."""
    jw, tw = _pair(256, 128, 4, act_bits=act_bits)
    x, b, r = _x((2, 8, 256)), _x((128,), 2) * 0.1, _x((2, 8, 128), 3)
    jo, to, jd, td = _both_linear(x, jw, tw, b, "gelu", r, dtype)
    print(f"act{act_bits} {dtype}: max |d| {np.abs(jo - to).max():.3g}")
    assert str(jd) == str(td).replace("torch.", "")
    if dtype == "f32":
        assert np.abs(jo - to).max() <= ATOL
    else:   # one bf16 ulp of the sum
        np.testing.assert_allclose(to, jo, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("kind", ["group", "channel", "fp8"])
def test_linear_over_quantized_tensor_and_fp8(kind):
    """Outside any kernel in both packages: dequantize (or upcast), one f32
    matmul, then bias, gelu, residual. Sums in another order: 2e-5."""
    w = (np.random.default_rng(7).normal(size=(256, 96)) * 0.02).astype(
        np.float32)
    if kind == "fp8":
        jw, tw = jq.quantize_fp8(jnp.asarray(w)), tq.quantize_fp8(
            torch.from_numpy(w))
    else:
        kw = (dict(granularity="group", group_size=128, axis=0)
              if kind == "group" else dict(granularity="channel", axis=1))
        jw = jq.quantize(jnp.asarray(w), 4, **kw)
        tw = tq.quantize(torch.from_numpy(w), 4, **kw)
    x, b, r = _x((5, 256)), _x((96,), 2) * 0.1, _x((5, 96), 3)
    jo, to, _, _ = _both_linear(x, jw, tw, b, "gelu", r)
    print(f"{kind}: max |d| {np.abs(jo - to).max():.3g}")
    assert np.abs(jo - to).max() <= ATOL
    if kind != "fp8":
        jq2 = np.asarray(jmm.quantized_matmul(jnp.asarray(x), jw))
        tq2 = tmm.quantized_matmul(torch.from_numpy(x), tw).numpy()
        assert np.abs(jq2 - tq2).max() <= ATOL


def test_linear_rejects_unknown_activation_and_weight():
    _, tw = _pair(256, 128, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        tmm.linear(torch.zeros(2, 256), tw, activation="relu")
    with pytest.raises(ValueError, match="contraction mismatch"):
        tpm.matmul(torch.zeros(2, 128), tw)
    with pytest.raises(TypeError, match="unsupported weight"):
        tmm.linear(torch.zeros(2, 256), object())
    with pytest.raises(ValueError, match="unsupported device"):
        tpm.matmul(torch.zeros(2, 256, device="meta"), tw)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_quantize_fp8_bytes_equal_jax(scale):
    """The float8_e4m3fn bytes, bit for bit: one rounding from f32, half to
    even, subnormals included (the quotient never passes 448, where the two
    frameworks' casts part: JAX gives NaN above 464, torch saturates)."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(257, 129)) * scale).astype(np.float32)
    m = np.abs(x).max() / 448.0
    x[0, :8] = [0.0, 1e-9 * scale, -m * 2 ** -10, m * 2 ** -9 * 1.5,
                m * (1 + 1 / 16), m * (1 + 3 / 16), m * (1 + 1 / 16 + 2 ** -12),
                -m * 447.9]
    j = jq.quantize_fp8(jnp.asarray(x))
    t = tq.quantize_fp8(torch.from_numpy(x))
    assert np.array_equal(np.asarray(j.data).view(np.uint8),
                          t.data.view(torch.uint8).numpy())
    assert np.array_equal(np.asarray(j.scale), t.scale.numpy())
    assert np.array_equal(np.asarray(j.dequantize()), t.dequantize().numpy())


def test_dequantize_tree_and_exported_leaves():
    """`from_jax_params` carries every quantized layout, and
    `dequantize_tree` turns each back into the JAX package's floats."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(256, 128)) * 0.02).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), 4, granularity="group", group_size=128,
                      axis=0)
    jtree = {"plain": jnp.asarray(w[:4]), "q": jqt,
             "mw": [jpm.prepare(jqt), jpm.prepare(jqt, act_bits=8)],
             "f8": jq.quantize_fp8(jnp.asarray(w)),
             "i8": jmm.decode_to_int8(jpm.prepare(jqt, act_bits=8))}

    def export(l):
        if isinstance(l, jq.QuantizedTensor):
            return dict(data=np.array(l.data), scale=np.array(l.scale),
                        zero_point=np.array(l.zero_point), bits=l.bits,
                        shape=l.shape, granularity=l.granularity,
                        group_size=l.group_size, axis=l.axis,
                        symmetric=l.symmetric)
        if isinstance(l, jpm.MatmulWeight):
            return dict(data=np.array(l.data), scale=np.array(l.scale),
                        zero_point=np.array(l.zero_point),
                        col_scale=(None if l.col_scale is None
                                   else np.array(l.col_scale)),
                        bits=l.bits, K=l.K, N=l.N, group_size=l.group_size,
                        act_bits=l.act_bits)
        if isinstance(l, jq.Fp8Tensor):
            return dict(data=np.array(l.data).view(np.uint8),
                        scale=np.array(l.scale))
        if isinstance(l, jmm.Int8Weight):
            return dict(data=np.array(l.data), col_scale=np.array(l.col_scale))
        return np.array(l)

    ttree = from_jax_params(
        {k: ([export(v) for v in l] if isinstance(l, list) else export(l))
         for k, l in jtree.items()}, device="cpu")
    assert isinstance(ttree["q"], tq.QuantizedTensor)
    assert isinstance(ttree["mw"][1], tpm.MatmulWeight)
    assert ttree["mw"][0].col_scale is None and ttree["mw"][1].act_bits == 8
    assert isinstance(ttree["f8"], tq.Fp8Tensor)
    assert isinstance(ttree["i8"], tmm.Int8Weight)
    jd = jq.dequantize_tree(jtree)
    td = tq.dequantize_tree(ttree)
    for k in ("plain", "q", "f8", "i8"):
        assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), k
    for a, b in zip(jd["mw"], td["mw"]):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the packed layout dequantizes to the same floats as the tensor it packs
    assert torch.equal(td["mw"][0], td["q"])


@pytest.mark.parametrize("K,N,bits,gran,group", [
    (24, 8, 4, "tensor", 0), (24, 6, 4, "group", 8), (40, 10, 2, "group", 8),
    (24, 8, 1, "channel", 0), (200, 30, 8, "group", 40), (96, 8, 2, "group", 6)])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_aligned_weight_is_the_weight_padded(K, N, bits, gran, group,
                                             act_bits):
    """ROADMAP C43: a packed weight off the kernels' alignment (N % 4, or K *
    bits / 8 not a multiple of 8, 16 at act_bits 8) runs through
    `_aligned`'s copy, made once: its levels are the weight's with zeros
    past it, block-packed along the padded K (a multiple of the group),
    its scales and zero points the weight's (1 and 0 past it). x padded with
    zeros meets the padded rows, so act_bits 8's plain version (exact int32
    sums) gives the weight's bits, sliced back to N; act_bits 16's sums of
    the same products and exact zeros within 1e-6."""
    rng = np.random.default_rng(K + N + bits)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) * 0.02
    if gran == "group":
        qt = tq.quantize(w, bits, symmetric=True, granularity="group",
                         group_size=group, axis=0)
    elif gran == "channel":
        qt = tq.quantize(w, bits, granularity="channel", axis=1)
    else:
        qt = tq.quantize(w, bits, granularity="tensor")
    mw = tpm.prepare(qt, act_bits=act_bits)
    al = tpm._aligned(mw)
    assert tpm._aligned(mw) is al and (al.K, al.N) == tpm._alignment(mw)
    assert al.K % al.group_size == 0 and al.N % 4 == 0
    assert al.K * bits // 8 % (16 if act_bits == 8 else 8) == 0
    lv = al.levels()
    assert torch.equal(lv[:K, :N], mw.levels())
    assert not lv[K:].any() and not lv[:, N:].any()
    assert torch.equal(al.dequantize()[:K, :N], mw.dequantize())
    x = torch.from_numpy(rng.normal(size=(3, K)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, al.K - K))
    b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)) * 0.02
    bp = torch.nn.functional.pad(b, (0, al.N - N))
    if act_bits == 8:
        got = tpm.a8_matmul_reference(xp, al, bp, "gelu", torch.float32)
        want = tpm.a8_matmul_reference(x, mw, b, "gelu", torch.float32)
        assert torch.equal(got[:, :N], want)
    else:
        got = tpm.matmul_plain(xp, al, bp, "gelu", torch.float32)
        want = tpm.matmul_plain(x, mw, b, "gelu", torch.float32)
        torch.testing.assert_close(got[:, :N], want, rtol=1e-6, atol=1e-6)
