"""Port parity: `QuantKV`, `quantize_kv` and the quantized-KV attention's
plain version against the JAX package.

`quantize_kv` is XLA code on both sides of the TPU kernel, so its packed
bytes, scales and zero-points must equal JAX's bit for bit, eagerly and under
`jax.jit` (the sampler runs it inside `lax.scan`). The attention runs in JAX
as its own tests run it on the CPU: the Pallas kernel in interpret mode where
the wrapper takes it (Sq % 8 == 0, Skv % 128 == 0), the XLA fall-back
elsewhere. The port's plain version repeats the kernel's arithmetic (bf16 q,
bf16(p * vs), the folded affine terms) at the kernel's KV tile, so against
the kernel it differs by f32 summation order and the frameworks' `exp`;
against the fall-back, which rounds the *dequantized* K and V to bf16, by
those roundings. Each test prints what it measured (`pytest -rP`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import pallas_attention as jpa
from diffusion_llm_rs_tpu_torch.ops import attention as tat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _kv(rng, BH, S, D):
    """K/V-like rows: N(0, 1) times a per-row spread, one constant row (range
    0 -> scale 1) and one row of a single repeated pair."""
    x = (rng.normal(size=(BH, S, D)) *
         rng.uniform(0.05, 20.0, size=(BH, S, 1))).astype(np.float32)
    x[0, 0] = 0.37
    x[-1, -1, ::2] = -1.5
    x[-1, -1, 1::2] = 2.25
    return x


def _assert_same(t: tat.QuantKV, j: jpa.QuantKV):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.zero_point.numpy(),
                                  np.asarray(j.zero_point))
    assert (t.bits, t.D, t.shape) == (j.bits, j.D, j.shape)


def _to_torch(j: jpa.QuantKV) -> tat.QuantKV:
    return tat.QuantKV(torch.from_numpy(np.array(j.data)),
                       torch.from_numpy(np.array(j.scale)),
                       torch.from_numpy(np.array(j.zero_point)), j.bits, j.D)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_quantize_kv_bit_equal_to_jax(bits):
    rng = np.random.default_rng(bits)
    x = _kv(rng, 6, 40, 64)
    t = tat.quantize_kv(torch.from_numpy(x), bits)
    _assert_same(t, jpa.quantize_kv(jnp.asarray(x), bits))
    assert t.data.dtype == torch.uint8 and t.scale.dtype == torch.float32
    assert t.data.shape == (6, 40, 64 * bits // 8)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_quantize_kv_bit_equal_to_jitted_jax(bits):
    """The sampler quantizes inside a compiled scan: XLA may turn a division
    by the constant qmax into a multiplication by its reciprocal there."""
    rng = np.random.default_rng(10 + bits)
    x = _kv(rng, 4, 128, 64)
    jitted = jax.jit(jpa.quantize_kv, static_argnums=1)(jnp.asarray(x), bits)
    eager = jpa.quantize_kv(jnp.asarray(x), bits)
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
        (jitted.data, eager.data), (jitted.scale, eager.scale),
        (jitted.zero_point, eager.zero_point)))
    print(f"quantize_kv {bits}-bit: jax.jit equals eager JAX: {same}")
    _assert_same(tat.quantize_kv(torch.from_numpy(x), bits, reciprocal=True),
                 jitted)


def test_quantize_kv_refuses_an_unpackable_width():
    with pytest.raises(ValueError, match="not divisible"):
        tat.quantize_kv(torch.zeros((1, 2, 6)), 2)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_dequantize_equal_to_jax(bits):
    rng = np.random.default_rng(20 + bits)
    j = jpa.quantize_kv(jnp.asarray(_kv(rng, 3, 17, 64)), bits)
    t = _to_torch(j)
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))
    np.testing.assert_array_equal(
        t.dequantize(torch.bfloat16).float().numpy(),
        np.asarray(j.dequantize(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("Skv", [128, 256])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_plain_matches_jax_kernel(bits, Skv):
    """BH=4, Sq=16, D=64 (the interpreted Pallas kernel; one KV tile of Skv):
    within 1e-4 relative. f32 sums run in another order, and where the two
    frameworks' `exp` differ in the last bit an occasional bf16(p * vs)
    rounds the other way (5e-7 to 3.6e-5 measured)."""
    rng = np.random.default_rng(30 + bits + Skv)
    BH, Sq, D = 4, 16, 64
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    jk = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                     .astype(np.float32)), bits)
    jv = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                     .astype(np.float32)), bits)
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    tout = tat.attention(torch.from_numpy(q), _to_torch(jk), _to_torch(jv))
    rel = _rel(tout, jout)
    print(f"attention_plain vs interpreted Pallas, {bits}-bit Skv={Skv}: "
          f"rel {rel:.3g}")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (BH, Sq, D)
    assert rel < 1e-4


@pytest.mark.parametrize("D", [16, 32, 128, 8, 24, 48, 80, 96, 256, 264, 384,
                               768])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_plain_matches_jax_at_other_head_widths(bits, D):
    """Heads of 16 (`DiffusionConfig.tiny()`'s), 32 (the shipped anchor's)
    and 128, the widths the CUDA kernel runs padded (8 to 96) or at its
    widest fixed instance (256), and past it in its wide instance (264, and
    384 and 768, the heads of width 768 at 2 and 1 heads), BH=4, Sq=16,
    Skv=128. JAX runs its interpreted kernel where
    a packed row splits into whole 8-channel blocks (D % (8 * vpb) == 0):
    within 1e-4 relative, as at D=64. Elsewhere (D=32 at 1 bit, D=16 at 2 or
    1 bits, D=8 and 24 at 4 bits and below, ...) it takes
    `_attention_fallback`: within its 2e-2."""
    rng = np.random.default_rng(90 + bits + D)
    BH, Sq, Skv = 4, 16, 128
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    jk = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                     .astype(np.float32)), bits)
    jv = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                     .astype(np.float32)), bits)
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    tout = tat.attention(torch.from_numpy(q), _to_torch(jk), _to_torch(jv))
    kernel = D % (8 * (8 // bits)) == 0
    rel = _rel(tout, jout)
    print(f"attention_plain vs JAX {'kernel' if kernel else 'fall-back'}, "
          f"{bits}-bit D={D}: rel {rel:.3g}")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (BH, Sq, D)
    # 8-bit levels lie about 128 from their zero point, so where the two
    # f32 sums of q.lv (D products, in another order) part in the last bit
    # and flip one bf16(p * vs), the output moves by 2^-9 p vs (lv - vz),
    # which the f32 correction does not take back (at D = 256 one flip gives
    # 8.8e-5); past 256 products the sums part more often: 5e-4 there
    # (2.2e-4 and 3.6e-4 at D = 768 and 264)
    wide8 = bits == 8 and D > 256
    assert rel < (5e-4 if wide8 else 1e-4 if kernel else 2e-2)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_plain_tile_of_the_cuda_kernel(bits):
    """The CUDA kernel steps the online softmax 64 tokens at a time, the TPU
    kernel 256 here: p is relative to another running max, so every
    bf16(p * vs) rounds afresh (2^-9 relative each), and the output, a mean
    of N(0, 1) values that mostly cancel, carries 2.6e-3 to 3.3e-3 of it:
    within 5e-3 relative of the TPU's tile, and of JAX's kernel."""
    rng = np.random.default_rng(40 + bits)
    BH, S, D = 4, 256, 64
    q = rng.normal(size=(BH, 24, D)).astype(np.float32)
    jk = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, S, D))
                                     .astype(np.float32)), bits)
    jv = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, S, D))
                                     .astype(np.float32)), bits)
    k, v = _to_torch(jk), _to_torch(jv)
    t256 = tat.attention_plain(torch.from_numpy(q), k, v)
    t64 = tat.attention_plain(torch.from_numpy(q), k, v,
                              tile=tat.KERNEL_KV_TILE)
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    print(f"tile 64 vs tile 256, {bits}-bit: rel {_rel(t64, t256):.3g}; "
          f"tile 64 vs JAX kernel: rel {_rel(t64, jout):.3g}")
    assert _rel(t64, t256) < 5e-3 and _rel(t64, jout) < 5e-3


@pytest.mark.parametrize("D", [16, 32, 64, 128, 8, 24, 48, 80, 96, 256, 264,
                               384, 768])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_plain_at_the_kernel_tile_matches_jax(bits, D):
    """`attention_plain` at the CUDA kernel's KV tile (64 tokens) against
    JAX, BH=2, Sq=16, Skv=256: JAX's interpreted kernel steps 256 tokens at
    a time, so the tiles differ (ROADMAP C19): within 5e-3 relative. Where
    a packed row does not split into whole 8-channel blocks (D=32 at 1 bit,
    D=16 at 2 and 1 bits) JAX takes `_attention_fallback`: within its
    2e-2."""
    rng = np.random.default_rng(70 + bits + D)
    BH, Sq, Skv = 2, 16, 256
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    jk, jv = (jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                          .astype(np.float32)), bits)
              for _ in range(2))
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    tout = tat.attention_plain(torch.from_numpy(q), _to_torch(jk),
                               _to_torch(jv), tile=tat.KERNEL_KV_TILE)
    kernel = D % (8 * (8 // bits)) == 0
    rel = _rel(tout, jout)
    print(f"attention_plain at tile {tat.KERNEL_KV_TILE} vs JAX "
          f"{'kernel' if kernel else 'fall-back'}, {bits}-bit D={D}: "
          f"rel {rel:.3g}")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (BH, Sq, D)
    assert rel < (5e-3 if kernel else 2e-2)


_JAX_WIDE = {}  # (D, bits) -> (inputs, JAX's output)


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D", [384, 768])
def test_plain_at_the_cluster_schedule_matches_jax(D, bits, splits):
    """`attention_plain` in the schedule of the card's cluster instance at
    heads of 264 to 2048 (tiles of 32 tokens, the chain in 1, 2 or 8 runs
    merged by (m, l)) against JAX's interpreted kernel (one tile of 256),
    BH=2, Sq=64, Skv=256, N(0, 1) q, K and V. bf16(p * vs) is rounded
    against each schedule's own running max, so each schedule, JAX's
    included, sits about 5e-3 from the exact attention over the same
    quantized K/V (f64), and two schedules differ by up to 6.7e-3 here
    (ROADMAP C44). Held: the port's schedule within 1.25x of JAX's distance
    from the exact attention, and within C44's 1e-2 of JAX."""
    if (D, bits) not in _JAX_WIDE:
        rng = np.random.default_rng(90 + bits + D)
        BH, Sq, Skv = 2, 64, 256
        q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
        jk, jv = (jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                              .astype(np.float32)), bits)
                  for _ in range(2))
        _JAX_WIDE[D, bits] = (q, jk, jv, np.asarray(
            jpa.attention(jnp.asarray(q), jk, jv)))
    q, jk, jv, jout = _JAX_WIDE[D, bits]
    k, v = _to_torch(jk), _to_torch(jv)
    tout = tat.attention_plain(torch.from_numpy(q), k, v,
                               tile=tat.CLUSTER_KV_TILE, splits=splits)

    def exact(t):  # the dequantized values, f64: scale * (level - zero)
        return ((t.levels().double() - t.zero_point.double()[..., None])
                * t.scale.double()[..., None])
    qb = torch.from_numpy(q).bfloat16().double()
    ref = torch.softmax(qb @ exact(k).transpose(1, 2) / math.sqrt(D),
                        dim=-1) @ exact(v)
    port, jax_, between = _rel(tout, ref), _rel(jout, ref), _rel(tout, jout)
    print(f"tile {tat.CLUSTER_KV_TILE} in {splits} run(s), {bits}-bit D={D}: "
          f"port {port:.3g} and JAX {jax_:.3g} from exact, {between:.3g} "
          f"apart")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == q.shape
    assert port <= 1.25 * jax_ and between < 1e-2


@pytest.fixture
def one_thread():
    """Small tensors on the CPU: with the suite's six test processes on one
    machine, torch's thread pool costs each of them more than it gives (the
    k-slice model below took 5.6 s on eight threads beside them, 0.05 s on
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nsplit", [1, 2])
def test_slices_schedule_matches_jax_kernel_past_2048(nsplit, one_thread):
    """Past 2048 the card's cluster instance gives a block k slices of 256
    channels (2 at D = 2560, `cluster_plan`) and runs two passes; its
    schedule (`test_torch_wide_routing.contig_slices_model`: tiles of 32
    tokens, S from each block's partial over its slices in rank order, P.V
    replayed slice by slice, the chain in 1 or 2 runs) against JAX's
    interpreted kernel at the 2560 model's head, BH=1, Sq = Skv = 256,
    4 bits (JAX's VMEM estimate admits it), N(0, 1) q, K and V: C44's
    bounds, the port within 1.25x of JAX's distance from the exact
    attention over the same quantized K/V (f64), and within 1e-2 of JAX."""
    from test_torch_wide_routing import contig_slices_model
    D, bits = 2560, 4
    if (D, bits) not in _JAX_WIDE:
        rng = np.random.default_rng(2560)
        BH, S = 1, 256
        q = rng.normal(size=(BH, S, D)).astype(np.float32)
        jk, jv = (jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, S, D))
                                              .astype(np.float32)), bits)
                  for _ in range(2))
        # JAX's VMEM estimate (`attention`): its kernel, not the fall-back
        assert 2 * S * (D // 2) + 4 * S * 4 + S * D * 10 <= 12 * 2**20
        _JAX_WIDE[D, bits] = (q, jk, jv, np.asarray(
            jpa.attention(jnp.asarray(q), jk, jv)))
    q, jk, jv, jout = _JAX_WIDE[D, bits]
    k, v = _to_torch(jk), _to_torch(jv)
    tout = contig_slices_model(torch.from_numpy(q), k, v, 1.0 / math.sqrt(D),
                               nsplit)

    def exact(t):  # the dequantized values, f64: scale * (level - zero)
        return ((t.levels().double() - t.zero_point.double()[..., None])
                * t.scale.double()[..., None])
    qb = torch.from_numpy(q).bfloat16().double()
    ref = torch.softmax(qb @ exact(k).transpose(1, 2) / math.sqrt(D),
                        dim=-1) @ exact(v)
    port, jax_, between = _rel(tout, ref), _rel(jout, ref), _rel(tout, jout)
    print(f"k-slice schedule in {nsplit} run(s), {bits}-bit D={D}: port "
          f"{port:.3g} and JAX {jax_:.3g} from exact, {between:.3g} apart")
    assert tuple(tout.shape) == q.shape
    assert port <= 1.25 * jax_ and between < 1e-2


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_plain_at_the_kernel_tile_at_a_ragged_skv(bits):
    """Skv = 200, a ragged last tile of 8 tokens at the kernel's tile; JAX
    takes `_attention_fallback` (no tile of 128 divides 200): within its
    2e-2 relative (ROADMAP C18)."""
    rng = np.random.default_rng(80 + bits)
    BH, Sq, Skv, D = 2, 16, 200, 64
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    jk, jv = (jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, Skv, D))
                                          .astype(np.float32)), bits)
              for _ in range(2))
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    tout = tat.attention_plain(torch.from_numpy(q), _to_torch(jk),
                               _to_torch(jv), tile=tat.KERNEL_KV_TILE)
    rel = _rel(tout, jout)
    print(f"attention_plain at tile {tat.KERNEL_KV_TILE}, Skv={Skv}, vs JAX "
          f"fall-back, {bits}-bit: rel {rel:.3g}")
    assert rel < 2e-2


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_plain_matches_jax_fallback_at_an_odd_shape(bits):
    """Skv = 10, Sq = 10 (no tile divides them: JAX takes `_attention_fallback`,
    which rounds the dequantized K, V and the normalized P to bf16): within
    2e-2 relative, JAX's own kernel-vs-reference bound."""
    rng = np.random.default_rng(50 + bits)
    BH, S, D = 4, 10, 64
    q = rng.normal(size=(BH, S, D)).astype(np.float32)
    jk = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, S, D))
                                     .astype(np.float32)), bits)
    jv = jpa.quantize_kv(jnp.asarray(rng.normal(size=(BH, S, D))
                                     .astype(np.float32)), bits)
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    jfb = jpa._attention_fallback(jnp.asarray(q), jk, jv, 1.0 / math.sqrt(D))
    np.testing.assert_array_equal(np.asarray(jout), np.asarray(jfb))
    tout = tat.attention(torch.from_numpy(q), _to_torch(jk), _to_torch(jv))
    exact = torch.softmax(
        torch.from_numpy(q) @ _to_torch(jk).dequantize().transpose(1, 2)
        / math.sqrt(D), dim=-1) @ _to_torch(jv).dequantize()
    print(f"attention_plain vs JAX fall-back, {bits}-bit Skv=10: rel "
          f"{_rel(tout, jout):.3g}; vs f32 attention over the dequantized "
          f"K/V: plain {_rel(tout, exact):.3g}, fall-back "
          f"{_rel(jout, exact):.3g}")
    assert _rel(tout, jout) < 2e-2


def test_attention_sm_scale_and_checks():
    rng = np.random.default_rng(60)
    q = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    x = rng.normal(size=(2, 128, 64)).astype(np.float32)
    jk, jv = (jpa.quantize_kv(jnp.asarray(x), 4),
              jpa.quantize_kv(jnp.asarray(x[:, ::-1].copy()), 4))
    k, v = _to_torch(jk), _to_torch(jv)
    jout = jpa.attention(jnp.asarray(q.numpy()), jk, jv, sm_scale=0.05)
    assert _rel(tat.attention(q, k, v, sm_scale=0.05), jout) < 1e-4
    k2 = tat.quantize_kv(torch.from_numpy(x), 2)
    with pytest.raises(ValueError, match="bits"):
        tat.attention(q, k2, v)
    with pytest.raises(ValueError, match="over K/V"):
        tat.attention(q[:1], k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tat.attention(q.to("meta"), k, v)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("D", [12, 20])
def test_attention_takes_jax_fallback_where_no_kernel_runs(bits, D):
    """Heads of no multiple of 8 (12 and 20, packable at 8, 4 and 2 bits):
    JAX's `attention` runs `_attention_fallback`, and so does the port's, on
    either device (`attention_fallback`), launching nothing. The same bf16
    roundings on both sides; f32 sums in another order can flip a bf16(p):
    within 1e-4 relative (measured 6.7e-8 to 1.3e-5 at D=12)."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    rng = np.random.default_rng(60 + bits + D)
    BH, Sq, Skv = 4, 16, 128
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    jk, jv = (jpa.quantize_kv(jnp.asarray(_kv(rng, BH, Skv, D)), bits)
              for _ in range(2))
    jout = jpa.attention(jnp.asarray(q), jk, jv)
    jfb = jpa._attention_fallback(jnp.asarray(q), jk, jv, 1.0 / math.sqrt(D))
    np.testing.assert_array_equal(np.asarray(jout), np.asarray(jfb))
    _build.reset_launch_counts()
    tout = tat.attention(torch.from_numpy(q), _to_torch(jk), _to_torch(jv))
    assert sum(_build.launch_counts.values()) == 0
    rel = _rel(tout, jout)
    print(f"attention_fallback vs JAX, {bits}-bit D={D}: rel {rel:.3g}")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (BH, Sq, D)
    assert rel < 1e-4
