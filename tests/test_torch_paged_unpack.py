"""The batched paged attention's two stages on the CPU: the unpack twin and
the attention twin over its operands, as the card runs them
(`csrc/paged_unpack.cu`, then `csrc/paged_flash.cuh`).

  - composed, they equal the one-piece twins they replaced bit for bit
    (`_one_piece_bf16`, `_one_piece_a8` below: the plain versions as they
    stood before the split, page by page over the packed pools), over the
    grid of tests/test_torch_paged_attention.py;
  - the unpack twin's levels, recombined as (lv - zp) * scale in f32, equal
    the dequantized pages of JAX's `_batched_fallback`
    (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:846-857, its `deq`,
    evaluated by JAX) bit for bit;
  - the int8 layout's V^T column order is a permutation within each 32
    tokens, and the attention twin's gather undoes it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import pallas_paged_attention as jppa
from diffusion_llm_rs_tpu_torch.ops import paged_attention as tpa
from diffusion_llm_rs_tpu_torch.ops.paged_attention import (
    NEG_INF, _bf16, unpack_levels)
from diffusion_llm_rs_tpu_torch.quant.core import div_const


def _one_piece_bf16(q, page_tables, page_tokens, n_pages,
                                  k_data, k_scale, k_zp, v_data, v_scale,
                                  v_zp, bits: int, sm_scale=None,
                                  return_lse: bool = False,
                                  head_group: int = 1):
    """Plain twin of `batched_paged_attention`, the bf16 path of the TPU
    `_batched_kernel`: bf16 q and its f32 channel sum qsum; ks' = ks * sm;
    logits = raw * ks' - (ks' * kz) * qsum; v_sc = bf16(v_lv * vs) per page;
    acc = acc * alpha + bf16(p) . v_sc - sum(p * vs * vz); out = acc * (1/l),
    and 0 with lse -1e30 where a slot had no page."""
    B, H, Sq, D = q.shape
    G = head_group
    n_max = page_tables.shape[1]
    P = k_data.shape[2] * (8 // bits)
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    qb = _bf16(q)
    qsum = qb.sum(dim=-1, keepdim=True)                      # [B, H, Sq, 1]
    tok = torch.arange(P, device=dev)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)

    def pages(arr, slots):  # [B, H/G, Pp, G*D] -> levels [B, H, P, D]
        lv = unpack_levels(arr.index_select(0, slots), bits).float()
        return lv.reshape(B, H // G, P, G, D).transpose(2, 3).reshape(
            B, H, P, D)

    def side(arr, slots):   # [B, H/G, G*P] -> [B, H, 1, P]
        return arr.index_select(0, slots).reshape(B, H, 1, P)

    for j in range(n_max):
        slots = page_tables[:, j].to(torch.int64)
        live = (j < n_pages).reshape(B, 1, 1, 1)
        k_lv, v_lv = pages(k_data, slots), pages(v_data, slots)
        ks, kz, vs, vz = (side(a, slots)
                          for a in (k_scale, k_zp, v_scale, v_zp))
        ks = ks * sm
        raw = qb @ k_lv.transpose(2, 3)                      # [B, H, Sq, P]
        logits = raw * ks - (ks * kz) * qsum
        valid = (tok[None, :] < page_tokens[:, j:j + 1]).reshape(B, 1, 1, P)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        v_sc = _bf16(v_lv * vs.transpose(2, 3))              # [B, H, P, D]
        pv = _bf16(p) @ v_sc
        corr = (p * (vs * vz)).sum(dim=-1, keepdim=True)
        acc = torch.where(live, acc * alpha + pv - corr, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    has = l > 0
    safe_l = torch.where(has, l, torch.ones_like(l))
    out = acc * (1.0 / safe_l)
    if return_lse:
        lse = torch.where(has, m + torch.log(safe_l), NEG_INF)[..., 0]
        return out, lse
    return out


def _one_piece_a8(q, page_tables, page_tokens, n_pages,
                                     k_data, k_scale, k_zp, v_data, v_scale,
                                     v_zp, bits: int, sm_scale=None,
                                     return_lse: bool = False,
                                     head_group: int = 1,
                                     reciprocal: bool = False):
    """Plain twin of `batched_paged_attention(act_bits=8)`, the int8 path of
    the TPU `_batched_kernel` (one page per step). With off = 2^(bits-1):
    levels centered to lv - off (int8) and kz, vz reduced by off; bf16 q
    quantized per (head, row): sq = amax / 127 (1 where 0), qi = round(q /
    sq), qsum = sum(qi) * sq; logits = (qi.k_lv * sq) * ks' - (ks' * kz) *
    qsum with ks' = ks * sm; per page w = p * vs (0 on invalid tokens), sw =
    max_t w / 127 (1 where 0), wi = round(w / sw); acc = acc * alpha +
    (wi.v_lv) * sw - sum(w * vz); out = acc * (1/l), and 0 with lse -1e30
    where a slot had no page. Both integer dots are exact in f32. The two
    divisions by 127 are IEEE divisions, as in the CUDA kernel; `reciprocal`
    multiplies by the f32 reciprocal of 127 instead, as XLA compiles the
    interpreted JAX kernel on the CPU (`quant.core.div_const`)."""
    B, H, Sq, D = q.shape
    G = head_group
    n_max = page_tables.shape[1]
    P = k_data.shape[2] * (8 // bits)
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    off = float(1 << (bits - 1))
    dev = q.device
    qb = _bf16(q)
    amax = qb.abs().amax(dim=-1, keepdim=True)               # [B, H, Sq, 1]
    sq = torch.where(amax > 0, div_const(amax, 127.0, reciprocal),
                     torch.ones_like(amax))
    qi = torch.round(qb / sq)
    qsum = qi.sum(dim=-1, keepdim=True) * sq
    tok = torch.arange(P, device=dev)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)

    def pages(arr, slots):  # [B, H/G, Pp, G*D] -> centered levels [B, H, P, D]
        lv = unpack_levels(arr.index_select(0, slots), bits).float() - off
        return lv.reshape(B, H // G, P, G, D).transpose(2, 3).reshape(
            B, H, P, D)

    def side(arr, slots):   # [B, H/G, G*P] -> [B, H, 1, P]
        return arr.index_select(0, slots).reshape(B, H, 1, P)

    for j in range(n_max):
        slots = page_tables[:, j].to(torch.int64)
        live = (j < n_pages).reshape(B, 1, 1, 1)
        k_lv, v_lv = pages(k_data, slots), pages(v_data, slots)
        ks, kz, vs, vz = (side(a, slots)
                          for a in (k_scale, k_zp, v_scale, v_zp))
        ks = ks * sm
        kz = kz - off
        vz = vz - off
        raw = (qi @ k_lv.transpose(2, 3)) * sq               # [B, H, Sq, P]
        logits = raw * ks - (ks * kz) * qsum
        valid = (tok[None, :] < page_tokens[:, j:j + 1]).reshape(B, 1, 1, P)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        w = torch.where(valid, p * vs, 0.0)
        wmax = w.amax(dim=-1, keepdim=True)
        sw = torch.where(wmax > 0, div_const(wmax, 127.0, reciprocal),
                         torch.ones_like(wmax))
        wi = torch.round(w / sw)
        pv = (wi @ v_lv) * sw
        corr = (w * vz).sum(dim=-1, keepdim=True)
        acc = torch.where(live, acc * alpha + pv - corr, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    has = l > 0
    safe_l = torch.where(has, l, torch.ones_like(l))
    out = acc * (1.0 / safe_l)
    if return_lse:
        lse = torch.where(has, m + torch.log(safe_l), NEG_INF)[..., 0]
        return out, lse
    return out


def _case(seed, bits, P, D, G, n_slots=6):
    rng = np.random.default_rng(seed)
    H = 4 if G < 4 else 8
    HG = H // G
    Pp, qmax = P // (8 // bits), (1 << bits) - 1
    data = [torch.from_numpy(rng.integers(0, 256, (n_slots, HG, Pp, G * D))
                             .astype(np.uint8)) for _ in range(2)]
    side = [torch.from_numpy((rng.random((n_slots, HG, G * P)) * s + o)
                             .astype(np.float32))
            for s, o in ((3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax),
                         (3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax))]
    pools = (data[0], side[0], side[1], data[1], side[2], side[3])
    q = torch.from_numpy(rng.normal(size=(3, H, 20, D)).astype(np.float32))
    return q, pools


# slot 0 reads three scattered pages with a partial last one, slot 1 is
# empty, slot 2 reads one page of slot 0's table (a compacted table shorter
# than n_max)
PT_ = torch.tensor([[5, 0, 3], [0, 0, 0], [3, 0, 0]], dtype=torch.int32)
NPG = torch.tensor([3, 0, 1], dtype=torch.int32)

# (D, G, P): the grid of tests/test_torch_paged_attention.py -- its JAX
# kernel shape (heads of 64 in pairs, pages of 128), its fall-back shape
# (pages of 64, G = 1 and 2) and the anchor's pools (heads of 32 in fours,
# pages of 8, 16, 32)
GRID = [(64, 2, 128), (64, 1, 64), (64, 2, 64), (32, 4, 8), (32, 4, 16),
        (32, 4, 32)] + [
    # heads the CUDA kernels run padded (scratch rows of the next instance's
    # width, zero past D) and at their widest: heads of 48 in groups of 8
    # (rows of 384 lanes, JAX's kernel shape), of 24 in pairs (8-byte reads
    # of a pool row in the kernel), of 8, 80, 96 and 256; and past 256, where
    # the scratch's rows are D rounded up to 64 (the wide instance's chunk):
    # 264 (rows of 320) and 768
    (8, 1, 8), (24, 2, 72), (48, 8, 128), (80, 1, 64), (96, 1, 128),
    (256, 1, 128), (264, 1, 32), (768, 1, 8)]


@pytest.mark.parametrize("D,G,P", GRID)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_stages_compose_to_the_one_piece_twins(D, G, P, bits, act_bits):
    """paged_unpack_plain then batched_paged_attention_unpacked_plain equal
    the one-piece twin bit for bit, output and lse (1-bit pages take the
    bf16 path at either act_bits; the int8 path also with XLA's reciprocal
    division)."""
    q, pools = _case(1000 * bits + P + D + G + act_bits, bits, P, D, G)
    nt = torch.tensor([[P, P, P // 2 + 3], [0, 0, 0], [P, 0, 0]],
                      dtype=torch.int32)
    a8 = act_bits == 8 and bits != 1
    args = (q, PT_, nt, NPG) + pools
    if a8:
        for reciprocal in (False, True):
            want = _one_piece_a8(*args, bits=bits, return_lse=True,
                                 head_group=G, reciprocal=reciprocal)
            got = tpa.batched_paged_attention_a8_plain(
                *args, bits=bits, return_lse=True, head_group=G,
                reciprocal=reciprocal)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        want = _one_piece_bf16(*args, bits=bits, return_lse=True,
                               head_group=G)
        got = tpa.batched_paged_attention(*args, bits=bits, return_lse=True,
                                          head_group=G, act_bits=act_bits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _jax_deq(data, scale, zp, page_tables, bits):
    """JAX's `_batched_fallback` `deq` (pallas_paged_attention.py:846-857)
    on degrouped pools: every table entry's page, (lv - zp) * scale in f32,
    [B, H, n_max * P, D]."""
    B, n_pages_max = page_tables.shape
    P = data.shape[2] * (8 // bits)
    H, D = data.shape[1], data.shape[3]
    pages = data[page_tables.reshape(-1)]
    sc = scale[page_tables.reshape(-1)]
    z = zp[page_tables.reshape(-1)]
    vpb = 8 // bits
    mask = (1 << bits) - 1
    d32 = pages.astype(jnp.int32)
    parts = [((d32 >> (p * bits)) & mask) for p in range(vpb)]
    lv = jnp.concatenate(parts, axis=2).astype(jnp.float32)
    full = (lv - z[..., None]) * sc[..., None]
    full = full.reshape(B, n_pages_max, H, P, D)
    return np.asarray(jnp.moveaxis(full, 2, 1).reshape(B, H, n_pages_max * P,
                                                       D))


@pytest.mark.parametrize("P", [8, 32, 64, 72, 128])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("D,G", [(64, 1), (64, 2), (32, 4), (8, 1), (24, 2),
                                 (48, 8), (96, 1), (256, 1), (264, 1)])
def test_unpacked_levels_match_jax_dequantization(P, bits, D, G):
    """K levels of both layouts and the int8 layout's V levels (centered,
    column-permuted), recombined as (lv - zp) * scale in f32, equal JAX's
    dequantized pages bit for bit; the scratch's rows past D (heads run
    padded to the kernels' next width) are zero. Slot 1's table reads slot
    0's pages."""
    q, pools = _case(7 * bits + P + D + G, bits, P, D, G)
    kd, ks, kz, vd, vs, vz = pools
    B, H = 2, q.shape[1]
    pt = torch.tensor([[4, 1, 2], [2, 4, 5]], dtype=torch.int32)
    npg = torch.tensor([3, 3], dtype=torch.int32)
    PT = tpa.tile_tokens(P)

    def side(a):  # the table's sidecars, [B, H, n_max * P, 1]
        return (a.index_select(0, pt.reshape(-1).long())
                .reshape(B, 3, H // G, G, P).permute(0, 2, 3, 1, 4)
                .reshape(B, H, 3 * P, 1))

    def recombine(lv, sc, zp):  # levels [B, H, n_max, P, D]
        return ((lv.reshape(B, H, 3 * P, D) - side(zp)) * side(sc)).numpy()

    jpt = jnp.asarray(pt.numpy())
    want_k = _jax_deq(jppa.degroup_pool(jnp.asarray(kd.numpy()), G),
                      jppa.degroup_sidecar(jnp.asarray(ks.numpy()), G),
                      jppa.degroup_sidecar(jnp.asarray(kz.numpy()), G),
                      jpt, bits)
    k, _, _ = tpa.paged_unpack_plain(pt, npg, *pools, bits=bits, head_group=G)
    assert k.shape[-1] == tpa.kernel_width(D) and not k[..., D:].any()
    np.testing.assert_array_equal(
        recombine(k[..., :P, :D].float(), ks, kz), want_k)
    if bits == 1:  # 1-bit pages have no int8 layout
        return
    off = float(1 << (bits - 1))
    k8, vt, _ = tpa.paged_unpack_plain(pt, npg, *pools, bits=bits,
                                       head_group=G, a8=True)
    np.testing.assert_array_equal(
        recombine(k8[..., :P, :D].float() + off, ks, kz), want_k)
    assert not k8[..., D:].any() and not vt[..., D:, :].any()
    v_lv = vt[..., :D, tpa.vt_columns(PT)[:P]].transpose(3, 4).float() + off
    want_v = _jax_deq(jppa.degroup_pool(jnp.asarray(vd.numpy()), G),
                      jppa.degroup_sidecar(jnp.asarray(vs.numpy()), G),
                      jppa.degroup_sidecar(jnp.asarray(vz.numpy()), G),
                      jpt, bits)
    np.testing.assert_array_equal(recombine(v_lv, vs, vz), want_v)


@pytest.mark.parametrize("PT", [32, 64, 128])
def test_vt_columns_permute_each_32_tokens(PT):
    cols = tpa.vt_columns(PT)
    assert sorted(cols.tolist()) == list(range(PT))
    assert torch.equal(cols // 32, torch.arange(PT) // 32)
    # a thread's weights of n-blocks (0, 1) and (2, 3) are 4 adjacent bytes
    for t in range(4):
        assert cols[[2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t]].tolist() == \
            list(range(4 * t, 4 * t + 4))


@pytest.mark.parametrize("P", [8, 24, 72, 128])
def test_attention_twin_undoes_the_vt_order(P):
    """The int8 layout's V^T, gathered by `vt_columns` as the attention twin
    gathers it, gives the centered V levels in token order; the columns of
    the tile past P are 0."""
    bits, D, G = 4, 64, 2
    q, pools = _case(50 + P, bits, P, D, G)
    pt = torch.tensor([[1, 3]], dtype=torch.int32)
    npg = torch.tensor([2], dtype=torch.int32)
    _, vt, _ = tpa.paged_unpack_plain(pt, npg, *pools, bits=bits, head_group=G,
                                      a8=True)
    PT = tpa.tile_tokens(P)
    lv = unpack_levels(tpa.degroup_pool(pools[3], G), bits)  # [n, H, P, D]
    want = lv[pt[0].long()].permute(1, 0, 3, 2) - 8          # [H, 2, D, P]
    got = vt[0][..., tpa.vt_columns(PT)[:P]]
    assert torch.equal(got.to(torch.int32), want)
    rest = torch.ones(PT, dtype=torch.bool)
    rest[tpa.vt_columns(PT)[:P]] = False
    assert torch.all(vt[0][..., rest] == 0)
