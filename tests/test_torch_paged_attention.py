"""Port parity: the paged-attention twins and `merge_partials` against the
JAX package.

JAX runs as its own tests run it on the CPU: its Pallas kernels in interpret
mode where its wrappers take the kernel (pages of 128 tokens, G*D = 128; the
bf16 path and, with act_bits=8, the int8 path), its exact XLA fallbacks
elsewhere. The port's twins repeat the TPU kernels'
arithmetic (bf16 q, bf16 P, the same folded affine terms), so against the
kernel path they differ only by f32 summation order and the frameworks'
`exp`; against the fallbacks, which compute in f32 over dequantized K/V,
they differ by those bf16 roundings. Each test prints the errors it
measured (`pytest -rP` shows them).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.cache.paged import quantize_page as jquantize_page
from diffusion_llm_rs_tpu.ops import pallas_paged_attention as jppa
from diffusion_llm_rs_tpu_torch.ops import paged_attention as tpa


def _grouped_pools(rng, H, S, D, P, G, bits):
    """K/V [H, S, D] ~ N(0, 1) quantized by JAX into grouped pools
    [S/P, H/G, P/vpb, G*D] (numpy), one pool slot per page."""
    nps, HG = S // P, H // G
    Pp = P // (8 // bits)
    out = []
    for _ in range(2):
        x = rng.normal(size=(H, S, D)).astype(np.float32)
        d, s, z = jquantize_page(
            jnp.asarray(x.reshape(H, nps, P, D).transpose(1, 0, 2, 3)
                        .reshape(nps * H, P, D)), bits)
        d = (np.asarray(d).reshape(nps, HG, G, Pp, D).transpose(0, 1, 3, 2, 4)
             .reshape(nps, HG, Pp, G * D))
        out += [d, np.asarray(s).reshape(nps, HG, G * P),
                np.asarray(z).reshape(nps, HG, G * P)]
    kd, ks, kz, vd, vs, vz = out
    return kd, ks, kz, vd, vs, vz


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _lse_err(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# slot 0 reads both pages, the last one partial; slot 1 is inactive
PT = np.array([[0, 1], [0, 0]], np.int32)
NT = np.array([[128, 77], [0, 0]], np.int32)
NPG = np.array([2, 0], np.int32)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_batched_twin_matches_jax_kernel(bits):
    """B=2, H=2, D=64, G=2, P=128 (the JAX kernel path, interpret mode):
    output within 1e-3 relative, lse within 1e-4; the inactive slot is 0
    with lse -1e30 on both sides."""
    B, H, Sq, D, P, G = 2, 2, 16, 64, 128, 2
    rng = np.random.default_rng(bits)
    pools = _grouped_pools(rng, H, 2 * P, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, PT, NT, NPG, *pools), bits=bits, return_lse=True, head_group=G)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, PT, NT, NPG, *pools), bits=bits, return_lse=True, head_group=G)
    rel, lse = _rel(tout[0], jout[0]), _lse_err(tlse, jlse)
    print(f"batched twin vs JAX kernel, {bits}-bit: rel {rel:.3g}, "
          f"lse {lse:.3g}")
    assert rel < 1e-3
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)
    assert np.all(tout[1].numpy() == 0) and np.all(np.asarray(jout[1]) == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


@pytest.mark.parametrize("bits", [4, 8])
def test_single_twin_matches_jax_kernel(bits):
    """One sequence over three scattered pages (partial last page) at
    D=128, P=128, the shapes the JAX kernel takes: output 1e-3 relative,
    lse 1e-4."""
    BH, Sq, D, P = 2, 16, 128, 128
    rng = np.random.default_rng(10 + bits)
    kd, ks, kz, vd, vs, vz = _grouped_pools(rng, BH, 4 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([3, 0, 2], np.int32)
    nt = np.array([P, P, 45], np.int32)
    pools = (kd, ks, kz, vd, vs, vz)
    jout, jlse = jppa.paged_attention(*_j(q, pt, *pools), bits=bits,
                                      page_tokens=jnp.asarray(nt),
                                      return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    rel, lse = _rel(tout, jout), _lse_err(tlse, jlse)
    print(f"single twin vs JAX kernel, {bits}-bit: rel {rel:.3g}, "
          f"lse {lse:.3g}")
    assert rel < 1e-3
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_single_twin_mixed_slots_and_partial_pages(bits):
    """Four pages in mixed slot order, two of them partial (one in the
    middle of the chain), at the JAX kernel's D=128, P=128: output within
    1e-3 relative, lse within 1e-4, as above."""
    BH, Sq, D, P = 2, 16, 128, 128
    rng = np.random.default_rng(40 + bits)
    pools = _grouped_pools(rng, BH, 5 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([4, 1, 3, 0], np.int32)
    nt = np.array([P, 9, P, 100], np.int32)
    jout, jlse = jppa.paged_attention(*_j(q, pt, *pools), bits=bits,
                                      page_tokens=jnp.asarray(nt),
                                      return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    rel, lse = _rel(tout, jout), _lse_err(tlse, jlse)
    print(f"single twin vs JAX kernel, mixed slots, {bits}-bit: rel "
          f"{rel:.3g}, lse {lse:.3g}")
    assert rel < 1e-3
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [1, 2])
def test_batched_twin_matches_jax_fallback(bits, G):
    """Pages of 64 tokens (the page `Engine.sample` picks), where JAX runs
    its exact f32 `_batched_fallback`: within JAX's own kernel-vs-fallback
    bounds (tests/test_paged_attention.py), 2e-2 relative on the output and
    1e-3 absolute plus 1e-3 relative on the lse. bf16 q moves a logit by up
    to 2^-9 of its size, and at 1 bit the dequantized keys are large."""
    B, H, Sq, D, P = 3, 4, 24, 64, 64
    rng = np.random.default_rng(20 + bits)
    pools = _grouped_pools(rng, H, 4 * P, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    pt = np.array([[2, 0, 3], [0, 0, 0], [1, 0, 0]], np.int32)
    nt = np.array([[P, P, 30], [0, 0, 0], [P, 0, 0]], np.int32)
    npg = np.array([3, 0, 1], np.int32)
    kd, ks, kz, vd, vs, vz = _j(*pools)
    jout, jlse = jppa._batched_fallback(
        *_j(q, pt, nt, npg), jppa.degroup_pool(kd, G),
        jppa.degroup_sidecar(ks, G), jppa.degroup_sidecar(kz, G),
        jppa.degroup_pool(vd, G), jppa.degroup_sidecar(vs, G),
        jppa.degroup_sidecar(vz, G), bits, 1.0 / math.sqrt(D),
        return_lse=True)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G)
    print(f"batched twin vs JAX fallback, {bits}-bit G={G}: rel "
          f"{_rel(tout, jout):.3g}, lse {_lse_err(tlse, jlse):.3g}")
    assert _rel(tout, jout) < 2e-2
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-3,
                               atol=1e-3)
    assert np.all(tout[1].numpy() == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


@pytest.mark.parametrize("P", [8, 16, 32])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_batched_twins_at_heads_of_32(P, bits, act_bits):
    """The shipped anchor's pools (8 heads of 32 in groups of G = 4, rows
    of 128) at the pages `Engine.sample` picks for short sequences, where
    JAX runs its exact f32 fall-back: the bf16 twin within the 2e-2 of
    `test_batched_twin_matches_jax_fallback`, the int8 twin within JAX's a8
    bound of 3.5e-2; 1-bit pages take the bf16 path at either act_bits. The
    lse: bf16 q moves a logit by up to 2^-9 of |q||k| / sqrt(D), and at heads
    of 32 the logits are twice as large as at 64, so both twins are held to
    JAX's a8 lse bound, 2e-2 (measured up to 1.3e-2)."""
    B, H, Sq, D, G = 2, 8, 24, 32, 4
    rng = np.random.default_rng(100 + P + bits + act_bits)
    pools = _grouped_pools(rng, H, 4 * P, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    pt = np.array([[2, 0, 3], [1, 0, 0]], np.int32)
    nt = np.array([[P, P, P // 2 + 1], [P, 0, 0]], np.int32)
    npg = np.array([3, 1], np.int32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, pt, nt, npg, *pools), bits=bits, return_lse=True,
        head_group=G, act_bits=act_bits)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True,
        head_group=G, act_bits=act_bits)
    a8 = act_bits == 8 and bits != 1
    rel = _rel(tout, jout)
    print(f"batched {'a8' if a8 else 'bf16'} twin vs JAX fall-back, P={P} "
          f"{bits}-bit: rel {rel:.3g}, lse {_lse_err(tlse, jlse):.3g}")
    assert rel < (3.5e-2 if a8 else 2e-2)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("bits", [2, 8])
def test_single_twin_matches_jax_fallback(bits):
    BH, Sq, D, P = 3, 10, 64, 64
    rng = np.random.default_rng(30 + bits)
    pools = _grouped_pools(rng, BH, 3 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([2, 1], np.int32)
    nt = np.array([P, 9], np.int32)
    jout, jlse = jppa._fallback(*_j(q, pt, *pools), bits, 1.0 / math.sqrt(D),
                                jnp.asarray(nt), return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    print(f"single twin vs JAX fallback, {bits}-bit: rel "
          f"{_rel(tout, jout):.3g}, lse {_lse_err(tlse, jlse):.3g}")
    assert _rel(tout, jout) < 2e-2
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_single_twin_at_heads_of_16_matches_jax(bits):
    """`DiffusionConfig.tiny()`'s heads of 16 over pages of 8 (scattered,
    the last one partial): JAX's `paged_attention` takes its fall-back there
    (D % 128 != 0), which rounds the dequantized K and V to bf16 where the
    twin keeps bf16 q over exact levels (ROADMAP C9). Within C9's 2e-2
    relative, and the lse within 2e-2, as at heads of 32 (measured: output
    3.3e-3 to 4.2e-3, lse 2.9e-3 to 5.5e-3)."""
    BH, Sq, D, P = 4, 10, 16, 8
    rng = np.random.default_rng(40 + bits)
    pools = _grouped_pools(rng, BH, 4 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([3, 0, 2], np.int32)
    nt = np.array([P, P, 5], np.int32)
    jout, jlse = jppa.paged_attention(*_j(q, pt, *pools), bits=bits,
                                      page_tokens=jnp.asarray(nt),
                                      return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    print(f"single twin vs JAX at heads of 16, {bits}-bit: rel "
          f"{_rel(tout, jout):.3g}, lse {_lse_err(tlse, jlse):.3g}")
    assert tout.shape == (BH, Sq, D)
    assert _rel(tout, jout) < 2e-2
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                               atol=2e-2)


def test_degroup_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(3, 2, 16, 128)).astype(np.uint8)
    side = rng.normal(size=(3, 2, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        tpa.degroup_pool(torch.from_numpy(data), 2).numpy(),
        np.asarray(jppa.degroup_pool(jnp.asarray(data), 2)))
    np.testing.assert_array_equal(
        tpa.degroup_sidecar(torch.from_numpy(side), 2).numpy(),
        np.asarray(jppa.degroup_sidecar(jnp.asarray(side), 2)))


def test_merge_partials_matches_jax():
    """Bit for bit where the merge weights are exact (one part; a row whose
    keys are all in one part; a row empty in every part, which stays 0).
    Elsewhere XLA's f32 `exp` and torch's differ by up to one ulp, and the
    merge by up to 2 ulp of the largest part (measured over 20 seeds):
    bound 4 ulp."""
    rng = np.random.default_rng(4)
    outs = [rng.normal(size=(2, 3, 5, 8)).astype(np.float32) for _ in range(3)]
    lses = [rng.normal(size=(2, 3, 5)).astype(np.float32) * 3
            for _ in range(3)]
    for i in range(3):  # slot 1: no keys in any part
        outs[i][1] = 0.0
        lses[i][1] = tpa.NEG_INF
    lses[1][0, 0] = tpa.NEG_INF   # head 0 of slot 0: keys only in parts 0, 2
    outs[1][0, 0] = 0.0
    jparts = [(jnp.asarray(o), jnp.asarray(l)) for o, l in zip(outs, lses)]
    tparts = [(torch.from_numpy(o), torch.from_numpy(l))
              for o, l in zip(outs, lses)]
    one = tpa.merge_partials(tparts[:1]).numpy()
    np.testing.assert_array_equal(one, np.asarray(jppa.merge_partials(jparts[:1])))
    merged = tpa.merge_partials(tparts).numpy()
    jmerged = np.asarray(jppa.merge_partials(jparts))
    np.testing.assert_array_equal(merged[1], 0.0)
    np.testing.assert_array_equal(merged[1], jmerged[1])
    ulp = np.spacing(np.abs(np.stack(outs)).max(axis=0))
    print(f"merge_partials vs JAX: {(np.abs(merged - jmerged) / ulp).max()} "
          f"ulp of the largest part")
    assert np.all(np.abs(merged - jmerged) <= 4 * ulp)
    # exact weights: part 0 holds the keys, part 1 none
    solo = [tparts[0], (torch.zeros_like(tparts[1][0]),
                        torch.full_like(tparts[1][1], tpa.NEG_INF))]
    jsolo = [(jnp.asarray(o.numpy()), jnp.asarray(l.numpy())) for o, l in solo]
    np.testing.assert_array_equal(tpa.merge_partials(solo).numpy(),
                                  np.asarray(jppa.merge_partials(jsolo)))


def test_wrappers_refuse_the_int8_path_and_empty_tables():
    """The int8 path is served now (act_bits=8 runs, on the CPU through its
    plain version); an act_bits that is neither 8 nor 16, an empty page
    table and an unknown device are refused."""
    q = torch.zeros((1, 2, 8, 64))
    pt = torch.zeros((1, 1), dtype=torch.int32)
    npg = torch.ones((1,), dtype=torch.int32)
    nt = torch.full((1, 1), 128, dtype=torch.int32)
    pools = (torch.zeros((1, 1, 32, 128), dtype=torch.uint8),) + tuple(
        torch.ones((1, 1, 128)) for _ in range(2))
    pools = pools + pools
    out = tpa.batched_paged_attention(q, pt, nt, npg, *pools, bits=4,
                                      head_group=2, act_bits=8)
    assert tuple(out.shape) == (1, 2, 8, 64) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="act_bits"):
        tpa.batched_paged_attention(q, pt, nt, npg, *pools, bits=4,
                                    head_group=2, act_bits=4)
    with pytest.raises(ValueError, match="empty page table"):
        tpa.paged_attention(q[0], pt[0, :0], *pools, bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.batched_paged_attention(q.to("meta"), pt, pt, npg, *pools, bits=4,
                                    head_group=2)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.batched_paged_attention(q.to("meta"), pt, pt, npg, *pools, bits=4,
                                    head_group=2, act_bits=8)


# ------------------------------------------------- int8 activations (a8)


def _a8_case(seed, bits, B, H, Sq, D, P, G, S):
    rng = np.random.default_rng(seed)
    pools = _grouped_pools(rng, H, S, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    return q, pools


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_batched_a8_twin_matches_jax_kernel(bits):
    """JAX's own a8 test shape (B=2, H=2, Sq=64, D=64, P=128, G=2, three full
    pages; the interpreted Pallas kernel, one page per group). The int32 dots
    are exact on both sides. Compiled for the CPU, JAX's kernel divides by
    127 through the f32 reciprocal: with `reciprocal` the twin does too, and
    only `exp`'s last bit separates them, which moves an occasional int8
    level of the folded weights (1/127 of the page's largest): output within
    5e-4 relative, lse within 1e-5. With IEEE divisions (the default, the
    CUDA kernel's) a scale differs in its last bit and one level of q in a
    few hundred rows rounds the other way: 2e-3 and lse 2e-3. Against the
    bf16 twin the a8 twin stays within JAX's a8 bounds (3.5e-2, lse 2e-2)."""
    B, H, Sq, D, P, G, S = 2, 2, 64, 64, 128, 2, 384
    q, pools = _a8_case(11, bits, B, H, Sq, D, P, G, S)
    nps = S // P
    pt = np.tile(np.arange(nps, dtype=np.int32)[None], (B, 1))
    nt = np.full((B, nps), P, np.int32)
    npg = np.full((B,), nps, np.int32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G,
        act_bits=8)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G,
        act_bits=8)
    trec, tlse_rec = tpa.batched_paged_attention_a8_plain(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G,
        reciprocal=True)
    t16, tlse16 = tpa.batched_paged_attention(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G)
    print(f"a8 twin vs JAX a8 kernel, {bits}-bit: reciprocal rel "
          f"{_rel(trec, jout):.3g}, lse {_lse_err(tlse_rec, jlse):.3g}; IEEE "
          f"division rel {_rel(tout, jout):.3g}, lse "
          f"{_lse_err(tlse, jlse):.3g}; a8 twin vs bf16 twin: rel "
          f"{_rel(tout, t16):.3g}, lse "
          f"{float((tlse - tlse16).abs().max()):.3g}")
    assert _rel(trec, jout) < 5e-4
    np.testing.assert_allclose(tlse_rec.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)
    assert _rel(tout, jout) < 2e-3
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=2e-3)
    assert _rel(tout, t16) < 3.5e-2
    np.testing.assert_allclose(tlse.numpy(), tlse16.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_batched_a8_twin_varied_lengths_and_inactive():
    """A partial page, a one-page slot and an inactive slot (JAX's
    `test_batched_a8_varied_lengths_and_inactive` shape), 4 bits."""
    B, H, Sq, D, P, G, S = 3, 2, 16, 64, 128, 2, 256
    q, pools = _a8_case(12, 4, B, H, Sq, D, P, G, S)
    pt = np.array([[0, 1], [0, 0], [1, 0]], np.int32)
    nt = np.array([[P, P // 2], [0, 0], [P, 0]], np.int32)
    npg = np.array([2, 0, 1], np.int32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, pt, nt, npg, *pools), bits=4, return_lse=True, head_group=G,
        act_bits=8)
    tout, tlse = tpa.batched_paged_attention_a8_plain(
        *_t(q, pt, nt, npg, *pools), bits=4, return_lse=True, head_group=G,
        reciprocal=True)
    for b in (0, 2):
        print(f"a8 twin vs JAX a8 kernel, slot {b}: rel "
              f"{_rel(tout[b], jout[b]):.3g}")
        assert _rel(tout[b], jout[b]) < 5e-4
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)
    assert np.all(tout[1].numpy() == 0) and np.all(np.asarray(jout[1]) == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


def test_batched_a8_twin_one_bit_takes_the_bf16_path():
    """1-bit pages keep the bf16 arithmetic under act_bits=8, as in JAX."""
    B, H, Sq, D, P, G, S = 1, 1, 8, 128, 128, 1, 128
    q, pools = _a8_case(13, 1, B, H, Sq, D, P, G, S)
    pt = np.zeros((B, 1), np.int32)
    nt = np.full((B, 1), P, np.int32)
    npg = np.ones((B,), np.int32)
    t8 = tpa.batched_paged_attention(*_t(q, pt, nt, npg, *pools), bits=1,
                                     act_bits=8)
    t16 = tpa.batched_paged_attention(*_t(q, pt, nt, npg, *pools), bits=1)
    j8 = jppa.batched_paged_attention(*_j(q, pt, nt, npg, *pools), bits=1,
                                      act_bits=8)
    assert torch.equal(t8, t16)
    assert _rel(t8, j8) < 1e-3


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("G", [1, 2])
def test_batched_a8_twin_at_pages_of_64(bits, G):
    """Pages of 64 tokens: JAX's wrapper takes its exact f32 fall-back there
    whatever act_bits says, while the port's a8 kernel (and twin) serves
    them in int8. The difference stays within JAX's own a8-vs-exact bounds:
    3.5e-2 relative, lse within 2e-2."""
    B, H, Sq, D, P = 3, 4, 24, 64, 64
    q, pools = _a8_case(40 + bits, bits, B, H, Sq, D, P, G, 4 * P)
    pt = np.array([[2, 0, 3], [0, 0, 0], [1, 0, 0]], np.int32)
    nt = np.array([[P, P, 30], [0, 0, 0], [P, 0, 0]], np.int32)
    npg = np.array([3, 0, 1], np.int32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G,
        act_bits=8)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True, head_group=G,
        act_bits=8)
    print(f"a8 twin vs JAX (exact fall-back) at P=64, {bits}-bit G={G}: rel "
          f"{_rel(tout, jout):.3g}, lse {_lse_err(tlse, jlse):.3g}")
    assert _rel(tout, jout) < 3.5e-2
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                               atol=2e-2)
    assert np.all(tout[1].numpy() == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


# the head widths the CUDA kernels run padded (8 to 96), at their widest
# fixed instance (256) or in their wide instance (264, 384, 768), and the
# head group each batched case takes: JAX's batched kernel runs where a pool
# row is whole 128-lane blocks (heads of 48 in groups of 8, of 96 in groups
# of 4, of 256, 384 and 768 alone), its fall-back elsewhere (264)
WIDE = [(8, 1), (24, 1), (48, 8), (80, 1), (96, 4), (256, 1), (264, 1),
        (384, 1), (768, 1)]


@pytest.mark.parametrize("D,G", WIDE)
@pytest.mark.parametrize("act_bits", [16, 8])
def test_batched_twins_at_wide_and_padded_heads_match_jax(D, G, act_bits):
    """4-bit pages of 128, slot 0 over both pages (the last partial), slot 1
    inactive; G heads (at least 2). Where JAX runs its interpreted kernel
    (G*D % 128 == 0): the bf16 twin within 1e-3 relative and lse 1e-4, as
    at heads of 64; the int8 twin within the 2e-3 (lse 2e-3) of its IEEE
    divisions. Where JAX runs its exact f32 fall-back: the bf16 twin within
    2e-2 and the int8 twin within JAX's a8 bound 3.5e-2, the lse within 2e-2
    (bf16 q moves a logit by 2^-9 of its size), as at heads of 32."""
    B, H, Sq, P, bits = 2, max(2, G), 16, 128, 4
    rng = np.random.default_rng(D + G + act_bits)
    pools = _grouped_pools(rng, H, 2 * P, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, PT, NT, NPG, *pools), bits=bits, return_lse=True,
        head_group=G, act_bits=act_bits)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, PT, NT, NPG, *pools), bits=bits, return_lse=True,
        head_group=G, act_bits=act_bits)
    kernel, a8 = G * D % 128 == 0, act_bits == 8
    rel, lse = _rel(tout[0], jout[0]), _lse_err(tlse, jlse)
    print(f"batched {'a8' if a8 else 'bf16'} twin vs JAX "
          f"{'kernel' if kernel else 'fall-back'}, D={D} G={G}: rel "
          f"{rel:.3g}, lse {lse:.3g}")
    assert tout.shape == (B, H, Sq, D)
    if kernel:
        assert rel < (2e-3 if a8 else 1e-3) and lse < (2e-3 if a8 else 1e-4)
    else:
        assert rel < (3.5e-2 if a8 else 2e-2)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                                   atol=2e-2)
    assert np.all(tout[1].numpy() == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


@pytest.mark.parametrize("D", [8, 24, 48, 80, 96, 256, 264, 384, 768])
def test_single_twin_at_wide_and_padded_heads_matches_jax(D):
    """One sequence over three scattered 4-bit pages of 128, the last one
    partial. JAX runs its interpreted kernel at D=256, 384 and 768 (D % 128
    == 0): within
    1e-3 relative and lse 1e-4, as at D=128; its fall-back elsewhere: within
    ROADMAP C9's 2e-2, lse 2e-2, as at heads of 16."""
    BH, Sq, P, bits = 2, 16, 128, 4
    rng = np.random.default_rng(300 + D)
    pools = _grouped_pools(rng, BH, 4 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([3, 0, 2], np.int32)
    nt = np.array([P, P, 45], np.int32)
    jout, jlse = jppa.paged_attention(*_j(q, pt, *pools), bits=bits,
                                      page_tokens=jnp.asarray(nt),
                                      return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    kernel = D % 128 == 0
    rel, lse = _rel(tout, jout), _lse_err(tlse, jlse)
    print(f"single twin vs JAX {'kernel' if kernel else 'fall-back'}, D={D}: "
          f"rel {rel:.3g}, lse {lse:.3g}")
    assert tout.shape == (BH, Sq, D)
    if kernel:
        assert rel < 1e-3 and lse < 1e-4
    else:
        assert rel < 2e-2
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("D", [2056, 2560])
def test_single_twin_past_2048_matches_jax(D):
    """Heads past 2048, which the card runs in its cluster kernel with two
    256-column slices a block: one sequence over two 4-bit pages of 128 (the
    last partial), Sq = 16. JAX runs its XLA `_fallback` at 2056 and its
    interpreted kernel at 2560 (D % 128 == 0): the tolerances of
    `test_single_twin_at_wide_and_padded_heads_matches_jax`."""
    BH, Sq, P, bits = 1, 16, 128, 4
    rng = np.random.default_rng(700 + D)
    pools = _grouped_pools(rng, BH, 3 * P, D, P, 1, bits)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    pt = np.array([2, 0], np.int32)
    nt = np.array([P, 45], np.int32)
    jout, jlse = jppa.paged_attention(*_j(q, pt, *pools), bits=bits,
                                      page_tokens=jnp.asarray(nt),
                                      return_lse=True)
    tout, tlse = tpa.paged_attention(*_t(q, pt, *pools), bits=bits,
                                     page_tokens=torch.from_numpy(nt),
                                     return_lse=True)
    kernel = D % 128 == 0
    rel, lse = _rel(tout, jout), _lse_err(tlse, jlse)
    print(f"single twin vs JAX {'kernel' if kernel else 'fall-back'}, D={D}: "
          f"rel {rel:.3g}, lse {lse:.3g}")
    assert tout.shape == (BH, Sq, D)
    if kernel:
        assert rel < 1e-3 and lse < 1e-4
    else:
        assert rel < 2e-2
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("D", [2056, 2560])
def test_batched_twin_past_2048_matches_jax(D):
    """The batched bf16 path past 2048, which the card runs in its cluster
    kernel with two 256-column slices a block: one head, slot 0 over two
    4-bit pages of 128 (the last partial), slot 1 inactive, Sq = 16. JAX
    runs its interpreted kernel at 2560 (G*D % 128 == 0) and its exact f32
    `_batched_fallback` at 2056: the tolerances of
    `test_batched_twins_at_wide_and_padded_heads_match_jax` (the kernel:
    1e-3 and lse 1e-4; the fall-back: 2e-2, lse 2e-2)."""
    B, H, Sq, P, bits = 2, 1, 16, 128, 4
    rng = np.random.default_rng(900 + D)
    pools = _grouped_pools(rng, H, 2 * P, D, P, 1, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, PT, NT, NPG, *pools), bits=bits, return_lse=True)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, PT, NT, NPG, *pools), bits=bits, return_lse=True)
    kernel = D % 128 == 0
    rel, lse = _rel(tout[0], jout[0]), _lse_err(tlse, jlse)
    print(f"batched bf16 twin vs JAX {'kernel' if kernel else 'fall-back'}, "
          f"D={D}: rel {rel:.3g}, lse {lse:.3g}")
    assert tout.shape == (B, H, Sq, D)
    if kernel:
        assert rel < 1e-3 and lse < 1e-4
    else:
        assert rel < 2e-2
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                                   atol=2e-2)
    assert np.all(tout[1].numpy() == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


@pytest.mark.parametrize("D", [2056, 2560])
def test_batched_a8_twin_past_2048_matches_jax(D):
    """The batched int8 path past 2048, which the card runs in its cluster
    kernel with two 256-column slices a block: one head, slot 0 over two
    4-bit pages of 128 (the last partial), slot 1 inactive, Sq = 16. JAX
    runs its interpreted a8 kernel at 2560 (G*D % 128 == 0) and its exact
    f32 `_batched_fallback` at 2056: the tolerances of
    `test_batched_twins_at_wide_and_padded_heads_match_jax` (the kernel: 2e-3
    and lse 2e-3, the twin's IEEE divisions; the fall-back: JAX's a8 bound
    3.5e-2, lse 2e-2)."""
    B, H, Sq, P, bits = 2, 1, 16, 128, 4
    rng = np.random.default_rng(800 + D)
    pools = _grouped_pools(rng, H, 2 * P, D, P, 1, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    jout, jlse = jppa.batched_paged_attention(
        *_j(q, PT, NT, NPG, *pools), bits=bits, return_lse=True, act_bits=8)
    tout, tlse = tpa.batched_paged_attention(
        *_t(q, PT, NT, NPG, *pools), bits=bits, return_lse=True, act_bits=8)
    kernel = D % 128 == 0
    rel, lse = _rel(tout[0], jout[0]), _lse_err(tlse, jlse)
    print(f"batched a8 twin vs JAX {'kernel' if kernel else 'fall-back'}, "
          f"D={D}: rel {rel:.3g}, lse {lse:.3g}")
    assert tout.shape == (B, H, Sq, D)
    if kernel:
        assert rel < 2e-3 and lse < 2e-3
    else:
        assert rel < 3.5e-2
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=2e-2,
                                   atol=2e-2)
    assert np.all(tout[1].numpy() == 0)
    assert np.all(tlse[1].numpy() == tpa.NEG_INF)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("D,G", [(12, 1), (12, 2), (20, 1)])
def test_fallback_ports_match_jax_where_no_kernel_runs(bits, D, G):
    """Heads of no multiple of 8: JAX's wrappers run `_fallback` and
    `_batched_fallback`, and so do the port's (`paged_attention_fallback`,
    `batched_paged_attention_fallback`, at either act_bits), launching
    nothing; the same f32 math in another order: outputs within 1e-5
    relative, lse within 1e-5; the inactive slot 0 with lse -1e30."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    B, H, Sq, P = 2, 4, 10, 64
    rng = np.random.default_rng(500 + bits + D + G)
    pools = _grouped_pools(rng, H, 3 * P, D, P, G, bits)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    pt = np.array([[2, 0], [0, 0]], np.int32)
    nt = np.array([[P, 33], [0, 0]], np.int32)
    npg = np.array([2, 0], np.int32)
    _build.reset_launch_counts()
    for act_bits in (16, 8):
        jout, jlse = jppa.batched_paged_attention(
            *_j(q, pt, nt, npg, *pools), bits=bits, return_lse=True,
            head_group=G, act_bits=act_bits)
        tout, tlse = tpa.batched_paged_attention(
            *_t(q, pt, nt, npg, *pools), bits=bits, return_lse=True,
            head_group=G, act_bits=act_bits)
        rel = _rel(tout[0], jout[0])
        print(f"batched fall-back vs JAX, {bits}-bit D={D} G={G} act "
              f"{act_bits}: rel {rel:.3g}, lse {_lse_err(tlse, jlse):.3g}")
        assert rel < 1e-5 and _lse_err(tlse, jlse) < 1e-5
        assert np.all(tout[1].numpy() == 0)
        assert np.all(tlse[1].numpy() == tpa.NEG_INF)
    if G == 1:
        pools1 = _grouped_pools(rng, H, 3 * P, D, P, 1, bits)
        jout, jlse = jppa.paged_attention(
            *_j(q[0], pt[0], *pools1), bits=bits, page_tokens=jnp.asarray(nt[0]),
            return_lse=True)
        tout, tlse = tpa.paged_attention(
            *_t(q[0], pt[0], *pools1), bits=bits,
            page_tokens=torch.from_numpy(nt[0]), return_lse=True)
        print(f"single fall-back vs JAX, {bits}-bit D={D}: rel "
              f"{_rel(tout, jout):.3g}, lse {_lse_err(tlse, jlse):.3g}")
        assert _rel(tout, jout) < 1e-5 and _lse_err(tlse, jlse) < 1e-5
    assert sum(_build.launch_counts.values()) == 0
