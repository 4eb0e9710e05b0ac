"""Which design serves each head width, and the cluster design's arithmetic.

Dense, quantized-KV (contiguous and single-sequence paged) and batched
paged attention run heads of 264 to 2048 in the cluster kernels of
`csrc/wide_cluster_flash.cuh` (ceil(D / 256) blocks, each 256 columns of the
head, the partial S summed in rank order); past 2048 dense, single-sequence
paged and batched int8 paged attention run the same design with blocks of k
slices of 256 columns (`cluster_plan`), quantized-KV and batched bf16 paged
attention `csrc/wide_flash.cuh`; fused-QKV
attention runs heads of up to 256 in its `wgmma` design's instances of
32-256, and wider ones in the same two passes over a cluster
(`csrc/fused_qkv_attention_wide.cu`, k slices a block past 2048). The
routing is plain Python (`ops/attention.py: instance`, `dense_instance`,
`cluster_blocks`, `cluster_plan`, `fused_qkv_head_width`,
`fused_qkv_instance`,
`ops/paged_attention.py: batched_instance`, `paged_instance`), checked
here without a card. The models below repeat
the cluster kernels' schedule in torch on the CPU (tiles of 32 tokens, the S
of each tile summed from 256-column partials in rank order, q's channel sum
likewise, the chain of tiles split and merged; the contiguous mode's levels
unpacked from the bytes of each block-packed row that hold a block's
channels; the batched int8 path's exchanges of q's row maxima and integer
sums, its s32 partial S in sub-tiles of 64 tokens, a page's sub-tiles held
for the per-page requantization and P.V in two halves of 128 columns a
block; fused-QKV attention's two exact passes, the logits of the first
kept for the second; past 2048 each block's partial S summed over its k
slices, and pass 2 slice by slice, dense, single-sequence paged and batched
int8 attention replaying the online recurrence that pass 1 kept) and hold
it against the
plain versions the card tests hold the kernels against, at those tests'
tolerances. No JAX.
"""

import math

import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu_torch.ops import attention as qa
from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors on the CPU: with the suite's six test processes on one
    machine, torch's thread pool costs each of them more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (D, blocks of a cluster at k = 1, dense suffix, quant_attention suffix,
# batched paged suffix (bf16), single-sequence paged suffix, batched paged
# suffix (int8))
ROUTES = [
    (8, 0, "", "_padded", "", "_padded", ""), (64, 0, "", "", "", "", ""),
    (200, 0, "", "_padded", "", "_padded", ""), (256, 0, "", "", "", "", ""),
    (264, 2, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (272, 2, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (384, 2, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (512, 2, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (520, 3, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (768, 3, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (1024, 4, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (2048, 8, "_cluster", "_cluster", "_cluster", "_cluster", "_cluster"),
    (2056, 0, "_cluster", "_wide", "_wide", "_cluster", "_cluster"),
    (4096, 0, "_cluster", "_wide", "_wide", "_cluster", "_cluster")]


# each case keeps the ID it was first given, when quant_attention ran
# "_wide" past 256 and dense attention past 2048
@pytest.mark.parametrize("D,blocks,dense,other,batched,paged,batched_a8",
                         ROUTES,
                         ids=[f"{D}-{n}-{'_wide' if D > 2048 else c}-"
                              f"{'_wide' if D > 256 else o}"
                              for D, n, c, o, *_ in ROUTES])
def test_each_head_width_reaches_its_design(D, blocks, dense, other,
                                            batched, paged, batched_a8):
    """`dense_attention` launches `dense_instance(D)`, the cluster kernel at
    every width past 256; `attention` launches `instance(D)` (its padded
    source between the fixed widths); `paged_attention` launches
    `paged_instance(D)`, the cluster kernel at every width past 256; the
    batched int8 path the cluster kernel past 256, its bf16 path
    `csrc/wide_flash.cuh` past 2048."""
    assert qa.cluster_blocks(D) == blocks
    assert qa.dense_instance(D) == dense
    assert qa.instance(D) == other
    assert pa.batched_instance(D, a8=False) == batched
    assert pa.paged_instance(D) == paged
    assert pa.batched_instance(D, a8=True) == batched_a8


# (D, blocks of a cluster, 256-column slices a block): k = 1 from 264 to
# 2048, then k = ceil(ceil(D / 256) / 8) and C = ceil(ceil(D / 256) / k)
PLANS = [(8, 0, 0), (256, 0, 0), (260, 0, 0), (264, 2, 1), (768, 3, 1),
         (2048, 8, 1), (2056, 5, 2), (2560, 5, 2), (4096, 8, 2),
         (4104, 6, 3), (10240, 8, 5), (10248, 7, 6)]


@pytest.mark.parametrize("D,C,k", PLANS)
def test_cluster_plan(D, C, k):
    """Every slice is owned: C blocks of k slices cover the ceil(D / 256)
    slices, the last block owns at least one, and a cluster has at most 8
    blocks."""
    assert qa.cluster_plan(D) == (C, k)
    if C:
        n = -(-D // 256)
        assert C <= qa.CLUSTER_MAX and (C - 1) * k < n <= C * k
        assert (k == 1) == (D <= 2048)
        assert k > 1 or C == qa.cluster_blocks(D)


# (head width, the fused-QKV wgmma instance that runs it (0: past 256),
# the suffix of the C entry point it launches: "_cluster" past 256)
QKV_ROUTES = [(8, 32, ""), (24, 32, ""), (32, 32, ""), (40, 64, ""),
              (64, 64, ""), (72, 128, ""), (120, 128, ""), (128, 128, ""),
              (136, 192, ""), (192, 192, ""), (200, 256, ""), (256, 256, ""),
              (264, 0, "_cluster"), (768, 0, "_cluster"),
              (2048, 0, "_cluster"), (2056, 0, "_cluster"),
              (4104, 0, "_cluster")]


# each case keeps the ID it was first given, before the entry point was
# part of it
@pytest.mark.parametrize("Hd,width,route", QKV_ROUTES,
                         ids=[f"{Hd}-{w}" for Hd, w, _ in QKV_ROUTES])
def test_fused_qkv_head_width(Hd, width, route):
    assert qa.fused_qkv_head_width(Hd) == width
    assert qa.fused_qkv_instance(Hd) == route


@pytest.mark.parametrize("D", [260, 2050, 12])
def test_widths_off_the_multiples_of_8_take_no_cluster(D):
    assert qa.cluster_blocks(D) == 0


def _partials_sum(a, b, cols=256):
    """a @ b^T over the last dim as ceil(D / 256) partials of 256 columns,
    added in rank order, as every block of a cluster adds them."""
    s = None
    for c0 in range(0, a.shape[-1], cols):
        part = a[..., c0:c0 + cols] @ b[..., c0:c0 + cols].transpose(-1, -2)
        s = part if s is None else s + part
    return s


def dense_cluster_model(q, k, v, sm):
    """kDense's schedule: KV tiles of 32 tokens, S from partials, bf16(p),
    tokens past Skv weigh nothing."""
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    BH, Sq, D = q.shape
    m = torch.full((BH, Sq, 1), qa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((BH, Sq, D))
    for j in range(0, k.shape[1], 32):
        logits = _partials_sum(qf, kf[:, j:j + 32]) * sm
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, j:j + 32]
        m = m_new
    return acc / l


@pytest.mark.parametrize("D", [264, 384, 520])
@pytest.mark.parametrize("Skv", [64, 130])
def test_dense_cluster_schedule_matches_the_plain_version(D, Skv):
    """The tolerance of the card test (|d| <= 1e-2, rel Frobenius <=
    1e-2): bf16(p) rounds after other tiles than the plain version's."""
    rng = np.random.default_rng(D + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 70, D), (2, Skv, D), (2, Skv, D)))
    sm = 1.0 / math.sqrt(D)
    out = dense_cluster_model(q, k, v, sm)
    ref = qa.dense_attention_plain(q, k, v, sm, torch.float32)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    assert float((out - ref).norm() / ref.norm()) <= 1e-2


def paged_cluster_model(q, pt, k_data, k_scale, k_zp, v_data, v_scale, v_zp,
                        bits, sm, page_tokens, nsplit=1):
    """kPaged's schedule: a page runs as tiles of 32 tokens; qsum and S from
    256-column partials in rank order; masked tokens at -1e30; the V scale
    folded into P before bf16. The tiles split into `nsplit` runs, each its
    own online softmax, merged in split order by (m, l): M = max m_s, w_s =
    exp(m_s - M), out = sum w_s acc_s / sum w_s l_s."""
    BH, Sq, D = q.shape
    P = k_data.shape[2] * (8 // bits)
    qb = q.to(torch.bfloat16).float()
    qsum = None
    for c0 in range(0, D, 256):
        part = qb[..., c0:c0 + 256].sum(-1, keepdim=True)
        qsum = part if qsum is None else qsum + part
    tiles = [(j, h0) for j in range(pt.shape[0]) for h0 in range(0, P, 32)]
    per = -(-len(tiles) // nsplit)
    parts = []
    for t0 in range(0, len(tiles), per):
        m = torch.full((BH, Sq, 1), pa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, Sq, D))
        for j, h0 in tiles[t0:t0 + per]:
            s = int(pt[j])
            k_lv = pa.unpack_levels(k_data[s], bits).float()  # [BH, P, D]
            v_lv = pa.unpack_levels(v_data[s], bits).float()
            sl = slice(h0, min(P, h0 + 32))
            ks, kz, vs, vz = (a[s][:, None, sl]
                              for a in (k_scale, k_zp, v_scale, v_zp))
            raw = _partials_sum(qb, k_lv[:, sl])
            logits = (raw * ks - qsum * (ks * kz)) * sm
            tok = torch.arange(sl.start, sl.stop)
            logits = torch.where(tok < int(page_tokens[j]), logits, pa.NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = (p * vs).to(torch.bfloat16).float() @ v_lv[:, sl]
            acc = acc * alpha + pv - (p * vs * vz).sum(-1, keepdim=True)
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    wl = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
    return acc / wl, (M + torch.log(wl))[..., 0]


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("bits,P,D", [(4, 128, 264), (1, 32, 384),
                                      (8, 72, 520), (2, 64, 272)])
def test_paged_cluster_schedule_matches_the_plain_version(bits, P, D, nsplit):
    """The card tests' tolerance (rel Frobenius <= 1e-2, lse within 1e-3)
    over an empty first page, a partial page and slots in mixed order, the
    chain in one run or split in three; and a chain with every page empty,
    where every key weighs 1 in both."""
    rng = np.random.default_rng(bits * 1000 + P + D)
    BH, Sq, n_slots = 2, 40, 5
    Pp = P // (8 // bits)
    qmax = (1 << bits) - 1
    data = [torch.from_numpy(rng.integers(0, 256, (n_slots, BH, Pp, D),
                                          dtype=np.uint8)) for _ in range(2)]
    side = [torch.from_numpy((rng.random((n_slots, BH, P)) * s + o)
                             .astype(np.float32))
            for s, o in ((3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax),
                         (3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax))]
    pools = (data[0], side[0], side[1], data[1], side[2], side[3])
    q = torch.from_numpy(rng.standard_normal((BH, Sq, D), dtype=np.float32))
    pt = torch.tensor([4, 1, 2], dtype=torch.int32)
    nt = torch.tensor([0, P, min(17, P - 1)], dtype=torch.int32)
    sm = 1.0 / math.sqrt(D)
    for tokens in (nt, torch.zeros_like(nt)):
        out, lse = paged_cluster_model(q, pt, *pools, bits, sm, tokens, nsplit)
        ref, ref_lse = pa.paged_attention_plain(
            q, pt, *pools, bits=bits, page_tokens=tokens, return_lse=True)
        assert float((out - ref).norm() / ref.norm()) <= 1e-2
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


def contig_block_levels(data, D, bits, c0):
    """The levels kContig's block of columns [c0, c0 + 256) unpacks from a
    block-packed [BH, S, Dp] row: the n = min(ncol, Dp) bytes from c0 % Dp
    on, wrapping at Dp, as copied (raw[k] = byte (c0 % Dp + k) % Dp), then
    column i = bit field (c0 + i) // Dp of raw[i % Dp]."""
    Dp = D // (8 // bits)
    ncol = min(256, D - c0)
    raw = data[..., (c0 % Dp + torch.arange(min(ncol, Dp))) % Dp]
    i = torch.arange(ncol)
    return ((raw[..., i % Dp].to(torch.int32) >> ((c0 + i) // Dp * bits))
            & ((1 << bits) - 1))


def contig_cluster_model(q, k, v, sm, nsplit):
    """kContig's schedule: each block's levels from its bytes of the packed
    rows; KV tiles of 32 tokens, the chain of ceil(Skv / 32) tiles in runs
    of ceil(tiles / nsplit), each its own online softmax, merged in split
    order by (m, l); qsum and S from 256-column partials in rank order;
    logits = raw * ka' - kb * qsum (ka' = ks * sm, kb = ka' * kz); the V
    scale folded into P before bf16; out = acc * (1 / l)."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    qb = q.to(torch.bfloat16).float()
    qsum = _rank_sum(qb)
    k_lv, v_lv = (torch.cat([contig_block_levels(t.data, D, t.bits, c0)
                             for c0 in range(0, D, 256)], -1).float()
                  for t in (k, v))
    tiles = list(range(0, Skv, 32))
    per = -(-len(tiles) // nsplit)
    parts = []
    for t0 in range(0, len(tiles), per):
        m = torch.full((BH, Sq, 1), qa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, Sq, D))
        for j in tiles[t0:t0 + per]:
            sl = slice(j, min(Skv, j + 32))
            ks, kz, vs, vz = (a[:, None, sl] for a in (
                k.scale, k.zero_point, v.scale, v.zero_point))
            ka = ks * sm
            logits = _partials_sum(qb, k_lv[:, sl]) * ka - (ka * kz) * qsum
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = (p * vs).to(torch.bfloat16).float() @ v_lv[:, sl]
            acc = acc * alpha + pv - (p * vs * vz).sum(-1, keepdim=True)
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    wl = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return sum(wi * a for wi, (_, _, a) in zip(w, parts)) * (1.0 / wl)


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("Skv", [64, 130])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("D", [264, 520])
def test_contig_cluster_schedule_matches_the_plain_version(D, bits, Skv,
                                                           nsplit):
    """Each block's unpacked levels equal `QuantKV.levels()` over its
    columns bit for bit (at D = 264 and 1 bit the rows are 33 bytes, so
    every block's channels span fields of one byte run that wraps); the
    schedule is within the card test's 2e-3 of `attention_plain` at the
    kernel's tile of 32 tokens, with the chain in one run and split as the
    model splits it."""
    rng = np.random.default_rng(D + bits + Skv + nsplit)
    BH, Sq = 2, 40
    q = torch.from_numpy(rng.standard_normal((BH, Sq, D), dtype=np.float32))
    k, v = (qa.quantize_kv(torch.from_numpy(
        (rng.standard_normal((BH, Skv, D)) * s + o).astype(np.float32)), bits)
        for s, o in ((1.0, 0.0), (3.0, 1.0)))
    for t in (k, v):
        lv = t.levels()
        for c0 in range(0, D, 256):
            assert torch.equal(contig_block_levels(t.data, D, bits, c0),
                               lv[..., c0:c0 + 256])
    sm = 1.0 / math.sqrt(D)
    out = contig_cluster_model(q, k, v, sm, nsplit)
    for splits in (1, nsplit):
        ref = qa.attention_plain(q, k, v, sm, tile=32, splits=splits)
        assert float((out - ref).norm() / ref.norm()) <= 2e-3


def _rank_max(x, cols=256):
    """The row maxima of |x| as the cluster exchanges them: each block's
    over its 256 columns, then the maximum of the partials."""
    return torch.stack([x[..., c0:c0 + cols].abs().amax(-1, keepdim=True)
                        for c0 in range(0, x.shape[-1], cols)]).amax(0)


def _rank_sum(x, cols=256):
    """The row sums of x as C partial sums of 256 columns, added in rank
    order."""
    s = None
    for c0 in range(0, x.shape[-1], cols):
        part = x[..., c0:c0 + cols].sum(-1, keepdim=True)
        s = part if s is None else s + part
    return s


def batched_cluster_model(q, page_tokens, n_pages, k, v, side, P):
    """kScratch16's schedule over the bf16 scratch of `paged_unpack_plain`:
    each slot's pages as tiles of 32 tokens (the last tile of a page ends at
    P), qsum and S from 256-column partials in rank order, -1e30 past a
    page's valid tokens, acc * alpha + bf16(p) . v_sc - sum p * vc; a slot
    with no page 0 with an lse of -1e30."""
    B, H, Sq, D = q.shape
    qb = q.to(torch.bfloat16).float()
    qsum = _rank_sum(qb)
    out = torch.zeros((B, H, Sq, D))
    lse = torch.full((B, H, Sq), pa.NEG_INF)
    for b in range(B):
        m = torch.full((H, Sq, 1), pa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((H, Sq, D))
        for j in range(int(n_pages[b])):
            for h0 in range(0, P, 32):
                sl = slice(h0, min(P, h0 + 32))
                ka, kb, vc = (side[b, :, j, i, None, sl] for i in range(3))
                raw = _partials_sum(qb[b], k[b, :, j, sl, :D].float())
                logits = raw * ka - kb * qsum[b]
                tok = torch.arange(sl.start, sl.stop)
                logits = torch.where(tok < int(page_tokens[b, j]), logits,
                                     pa.NEG_INF)
                m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
                p = torch.exp(logits - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                pv = p.to(torch.bfloat16).float() @ v[b, :, j, sl, :D].float()
                acc = acc * alpha + pv - (p * vc).sum(-1, keepdim=True)
                m = m_new
        if int(n_pages[b]):
            out[b] = acc * (1.0 / l)
            lse[b] = (m + torch.log(l))[..., 0]
    return out, lse


def batched_a8_cluster_model(q, page_tokens, n_pages, k, vt, side, P):
    """kScratch8's schedule over the int8 scratch: q's row amax as the
    maximum of 256-column partial maxima, qi = rint(q / sq), qsum from the
    partial integer sums; each sub-tile's S (64 tokens, a page of 32 in
    one) as the sum of s32 partials (any order: exact), a page's S held
    until its last sub-tile; the page's softmax, w = p * vs (0 past the
    valid tokens), sw = max w / 127, wi = rint(w / sw); P.V over each
    block's 256 columns in two halves of 128, each folded into o as acc *
    alpha + (wi . v) * sw - sum w * vz'."""
    B, H, Sq, D = q.shape
    qb = q.to(torch.bfloat16).float()
    amax = _rank_max(qb)
    sq = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qi = torch.round(qb / sq)
    qsum = _rank_sum(qi.double()).float() * sq
    cols = pa.vt_columns(vt.shape[-1])[:P]
    out = torch.zeros((B, H, Sq, D))
    lse = torch.full((B, H, Sq), pa.NEG_INF)
    for b in range(B):
        m = torch.full((H, Sq, 1), pa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((H, Sq, D))
        for j in range(int(n_pages[b])):
            subs = [_partials_sum(qi[b].double(),
                                  k[b, :, j, h0:min(P, h0 + 64), :D].double())
                    for h0 in range(0, P, 64)]
            raw = torch.cat(subs, -1).float() * sq[b]
            ka, kb, vs, vz = (side[b, :, j, i, None, :P] for i in range(4))
            valid = torch.arange(P) < int(page_tokens[b, j])
            logits = torch.where(valid, raw * ka - kb * qsum[b], pa.NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            w = torch.where(valid, p * vs, 0.0)
            wmax = w.amax(-1, keepdim=True)
            sw = torch.where(wmax > 0, wmax / 127.0, torch.ones_like(wmax))
            wi = torch.round(w / sw)
            corr = (w * vz).sum(-1, keepdim=True)
            v_lv = vt[b, :, j][..., cols].float()             # [H, DK, P]
            for c0 in range(0, D, 128):                       # a half
                c1 = min(D, c0 + 128)
                pv = wi @ v_lv[:, c0:c1].transpose(1, 2)
                acc[..., c0:c1] = acc[..., c0:c1] * alpha + pv * sw - corr
            m = m_new
        if int(n_pages[b]):
            out[b] = acc * (1.0 / l)
            lse[b] = (m + torch.log(l))[..., 0]
    return out, lse


def _batched_scratch(D, P, bits, G, a8, seed):
    """Three slots over a pool of five: two pages (the second partial), no
    page, one page whose every token is masked; q of 40 rows, two heads (a
    group of G), then `paged_unpack_plain`'s scratch."""
    rng = np.random.default_rng(seed)
    H, Sq, n_slots = 2, 40, 5
    Pp, qmax = P // (8 // bits), (1 << bits) - 1
    data = [torch.from_numpy(rng.integers(0, 256, (n_slots, H // G, Pp, G * D),
                                          dtype=np.uint8)) for _ in range(2)]
    side = [torch.from_numpy((rng.random((n_slots, H // G, G * P)) * s + o)
                             .astype(np.float32))
            for s, o in ((3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax),
                         (3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax))]
    pools = (data[0], side[0], side[1], data[1], side[2], side[3])
    q = torch.from_numpy(rng.standard_normal((3, H, Sq, D), dtype=np.float32))
    pt = torch.tensor([[4, 1], [0, 0], [2, 0]], dtype=torch.int32)
    nt = torch.tensor([[P, min(17, P - 1)], [0, 0], [0, 0]],
                      dtype=torch.int32)
    npg = torch.tensor([2, 0, 1], dtype=torch.int32)
    k, v, sd = pa.paged_unpack_plain(pt, npg, *pools, bits=bits,
                                     head_group=G, a8=a8)
    return q, nt, npg, k, v, sd


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("D,P,bits,G", [(264, 32, 4, 1), (384, 72, 8, 2),
                                        (520, 72, 2, 1), (384, 32, 4, 2)])
def test_batched_cluster_schedules_match_the_plain_version(D, P, bits, G, a8):
    """The card tests' tolerances: bf16 rel Frobenius <= 1e-2, int8 <= 5e-3,
    lse within 1e-3; an empty slot gives 0 and an lse of -1e30, and a page
    whose every token is masked weighs each key 1 in both."""
    q, nt, npg, k, v, sd = _batched_scratch(D, P, bits, G, a8,
                                            D + P + bits + 10 * a8)
    model = batched_a8_cluster_model if a8 else batched_cluster_model
    out, lse = model(q, nt, npg, k, v, sd, P)
    ref, ref_lse = pa.batched_paged_attention_unpacked_plain(
        q, nt, npg, k, v, sd, P, return_lse=True)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == pa.NEG_INF)
    assert float((out - ref).norm() / ref.norm()) <= (5e-3 if a8 else 1e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


def qkv_cluster_model(qkv, H, sm, out_dtype=torch.float32):
    """`csrc/fused_qkv_attention_wide.cu`'s schedule for each (batch row,
    head): the keys in tiles of 32; pass 1 takes S of a tile from
    256-column partials added in rank order, keeps it, and updates a
    running maximum of logit * log2(e) and a running sum of 2^(that -
    maximum) a tile; pass 2 reads the kept S and forms p = 2^(logit log2(e)
    - (max + log2 sum)), rounded to bf16, times the V tile."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    Hd = D // H
    x = qkv.to(torch.bfloat16).float()
    q, k, v = (x[..., i * D:(i + 1) * D].reshape(B, S, H, Hd).transpose(1, 2)
               for i in range(3))
    sl2 = sm * math.log2(math.e)
    m = torch.full((B, H, S, 1), qa.NEG_INF)
    l = torch.zeros_like(m)
    kept = []
    for j in range(0, S, 32):  # pass 1
        s = _partials_sum(q, k[:, :, j:j + 32])
        kept.append(s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        l = l * torch.exp2(m - m_new) + torch.exp2(s * sl2 - m_new).sum(
            -1, keepdim=True)
        m = m_new
    bias = m + torch.log2(l)
    o = torch.zeros((B, H, S, Hd))
    for j, s in zip(range(0, S, 32), kept):  # pass 2
        p = torch.exp2(s * sl2 - bias).to(torch.bfloat16).float()
        o = o + p @ v[:, :, j:j + 32]
    return o.transpose(1, 2).reshape(B, S, D).to(out_dtype)


@pytest.mark.parametrize("S", [104, 136])
@pytest.mark.parametrize("D,H", [(528, 2), (768, 2), (768, 1)])
def test_qkv_cluster_schedule_matches_the_plain_version(D, H, S):
    """Heads of 264 (a last block of 8 columns), 384 and 768, S of 104 and
    136 (a last tile of 8 keys): the card test's tolerances (rel Frobenius
    <= 1e-3 with f32 out, 5e-3 with bf16 out), since p is rounded to bf16
    after the same normalisation and only f32 orders differ."""
    rng = np.random.default_rng(D + H + S)
    qkv = torch.from_numpy(rng.standard_normal((2, S, 3 * D),
                                               dtype=np.float32))
    sm = 1.0 / math.sqrt(D // H)
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-3)):
        out = qkv_cluster_model(qkv, H, sm, dtype).float()
        ref = qa.fused_qkv_attention_plain(qkv, H, sm, dtype).float()
        rel = float((out - ref).norm() / ref.norm())
        print(f"D={D} H={H} S={S} {dtype}: rel {rel:.3g}")
        assert rel <= tol


def qkv_slices_model(qkv, H, sm, out_dtype=torch.float32):
    """`csrc/fused_qkv_attention_wide.cu`'s schedule past 2048: that of
    `dense_slices_model` (the kernel they share) over each (batch row,
    head)'s q, K and V."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    Hd = D // H
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, S, H, Hd)
               .transpose(1, 2) for i in range(3))
    o = dense_slices_model(q, k, v, sm, normalised=True)
    return o.transpose(1, 2).reshape(B, S, D).to(out_dtype)


@pytest.mark.parametrize("S", [104, 136])
@pytest.mark.parametrize("D", [2056, 4104])
def test_qkv_slices_schedule_matches_the_plain_version(D, S):
    """One head of 2056 (5 blocks of 2 slices, the last a slice of 8
    columns) and of 4104 (6 blocks of 3, the last 2), a last tile of 8 keys
    at S = 104 and 136: the card test's tolerances, rel Frobenius <= 1e-3
    with f32 out and 5e-3 with bf16 out."""
    rng = np.random.default_rng(D + S)
    qkv = torch.from_numpy(rng.standard_normal((2, S, 3 * D),
                                               dtype=np.float32))
    sm = 1.0 / math.sqrt(D)
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-3)):
        out = qkv_slices_model(qkv, 1, sm, dtype).float()
        ref = qa.fused_qkv_attention_plain(qkv, 1, sm, dtype).float()
        rel = float((out - ref).norm() / ref.norm())
        print(f"D={D} S={S} {dtype}: rel {rel:.3g}")
        assert rel <= tol


def paged_slices_model(q, pt, k_data, k_scale, k_zp, v_data, v_scale, v_zp,
                       bits, sm, page_tokens, nsplit=1):
    """kPaged's schedule past 2048 (`wide_cluster_paged_slices`): the cluster
    of `cluster_plan(D)`, C blocks of k slices; a page runs as tiles of 32
    tokens, split into `nsplit` runs. Pass 1, over a run's tiles: qsum and S
    from each block's partial over its k slices, added in rank order; the
    online softmax, keeping for each tile bf16(p * vs), alpha and csum =
    sum(p * vs * vz). Pass 2 replays the recurrence slice by slice, acc =
    acc * alpha - csum + bf16(p * vs) . lv; the runs merge by (m, l) as in
    `paged_cluster_model`."""
    BH, Sq, D = q.shape
    cols = 256 * qa.cluster_plan(D)[1]
    P = k_data.shape[2] * (8 // bits)
    qb = q.to(torch.bfloat16).float()
    qsum = _rank_sum(qb, cols)
    tiles = [(j, h0) for j in range(pt.shape[0]) for h0 in range(0, P, 32)]
    per = -(-len(tiles) // nsplit)
    parts = []
    for t0 in range(0, len(tiles), per):
        m = torch.full((BH, Sq, 1), pa.NEG_INF)
        l = torch.zeros_like(m)
        kept = []
        for j, h0 in tiles[t0:t0 + per]:  # pass 1
            s = int(pt[j])
            sl = slice(h0, min(P, h0 + 32))
            k_lv = pa.unpack_levels(k_data[s], bits).float()[:, sl]
            ks, kz, vs, vz = (a[s][:, None, sl]
                              for a in (k_scale, k_zp, v_scale, v_zp))
            raw = _partials_sum(qb, k_lv, cols)
            logits = (raw * ks - qsum * (ks * kz)) * sm
            tok = torch.arange(sl.start, sl.stop)
            logits = torch.where(tok < int(page_tokens[j]), logits, pa.NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            kept.append(((p * vs).to(torch.bfloat16).float(), alpha,
                         (p * vs * vz).sum(-1, keepdim=True),
                         pa.unpack_levels(v_data[s], bits).float()[:, sl]))
            m = m_new
        acc = torch.zeros((BH, Sq, D))
        for c0 in range(0, D, 256):  # pass 2, a slice at a time
            a = acc[..., c0:c0 + 256]
            for w, alpha, csum, v_lv in kept:
                a = a * alpha - csum + w @ v_lv[..., c0:c0 + 256]
            acc[..., c0:c0 + 256] = a
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    wl = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
    return acc / wl, (M + torch.log(wl))[..., 0]


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("bits,P,D", [(4, 32, 2056), (2, 72, 4104)])
def test_paged_slices_schedule_matches_the_plain_version(bits, P, D, nsplit):
    """Past 2048, at k = 2 (2056: a last block of one slice of 8 columns)
    and k = 3 (4104), the chain in one run and split in three: the card
    tests' tolerance (rel Frobenius <= 1e-2, lse within 1e-3) over an empty
    first page, a partial page and slots in mixed order, and a chain with
    every page empty, where every key weighs 1."""
    rng = np.random.default_rng(bits * 1000 + P + D + nsplit)
    BH, Sq, n_slots = 2, 40, 5
    Pp = P // (8 // bits)
    qmax = (1 << bits) - 1
    data = [torch.from_numpy(rng.integers(0, 256, (n_slots, BH, Pp, D),
                                          dtype=np.uint8)) for _ in range(2)]
    side = [torch.from_numpy((rng.random((n_slots, BH, P)) * s + o)
                             .astype(np.float32))
            for s, o in ((3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax),
                         (3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax))]
    pools = (data[0], side[0], side[1], data[1], side[2], side[3])
    q = torch.from_numpy(rng.standard_normal((BH, Sq, D), dtype=np.float32))
    pt = torch.tensor([4, 1, 2], dtype=torch.int32)
    nt = torch.tensor([0, P, min(17, P - 1)], dtype=torch.int32)
    sm = 1.0 / math.sqrt(D)
    for tokens in (nt, torch.zeros_like(nt)):
        out, lse = paged_slices_model(q, pt, *pools, bits, sm, tokens, nsplit)
        ref, ref_lse = pa.paged_attention_plain(
            q, pt, *pools, bits=bits, page_tokens=tokens, return_lse=True)
        rel = float((out - ref).norm() / ref.norm())
        print(f"D={D} {bits}-bit P={P} nsplit={nsplit}: rel {rel:.3g}")
        assert rel <= 1e-2
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


def dense_slices_model(q, k, v, sm, normalised=False):
    """`csrc/wide_cluster_flash.cuh: slices_attention`'s schedule, which
    dense and fused-QKV attention run past 2048: the cluster of
    `cluster_plan(D)`, C blocks of k slices of 256 columns; pass 1 takes S
    of each tile of 32 keys from each block's partial over its k slices,
    the partials added in rank order, keeps it, and runs a maximum m of
    logit * log2(e) and a sum l of 2^(that - m); pass 2 runs slice by
    slice, p = 2^(logit log2(e) - m) rounded to bf16, times the slice's
    columns of each V tile, and out = o / l (dense attention's TPU kernel
    divides after P.V); where `normalised` (fused-QKV's divides before
    rounding), p = 2^(logit log2(e) - (m + log2 l)) and out = o. q [...,
    Sq, D], k and v [..., Skv, D]; f32 out."""
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    D, Skv = q.shape[-1], k.shape[-2]
    cols = 256 * qa.cluster_plan(D)[1]
    sl2 = sm * math.log2(math.e)
    m = torch.full(q.shape[:-1] + (1,), qa.NEG_INF)
    l = torch.zeros_like(m)
    kept = []
    for j in range(0, Skv, 32):  # pass 1
        s = _partials_sum(qf, kf[..., j:j + 32, :], cols)
        kept.append(s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        l = l * torch.exp2(m - m_new) + torch.exp2(s * sl2 - m_new).sum(
            -1, keepdim=True)
        m = m_new
    bias = m + torch.log2(l) if normalised else m
    o = torch.zeros(q.shape)
    for c0 in range(0, D, 256):  # pass 2, a slice at a time
        for j, s in zip(range(0, Skv, 32), kept):
            p = torch.exp2(s * sl2 - bias).to(torch.bfloat16).float()
            o[..., c0:c0 + 256] += p @ vf[..., j:j + 32, c0:c0 + 256]
    return o if normalised else o / l


@pytest.mark.parametrize("Skv", [64, 130])
@pytest.mark.parametrize("D", [2056, 4104])
def test_dense_slices_schedule_matches_the_plain_version(D, Skv):
    """Past 2048, at k = 2 (2056: a last block of one slice of 8 columns)
    and k = 3 (4104), a last tile of 2 keys at Skv = 130: the card test's
    tolerance (|d| <= 1e-2, rel Frobenius <= 1e-2)."""
    rng = np.random.default_rng(D + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 70, D), (2, Skv, D), (2, Skv, D)))
    sm = 1.0 / math.sqrt(D)
    out = dense_slices_model(q, k, v, sm)
    ref = qa.dense_attention_plain(q, k, v, sm, torch.float32)
    rel = float((out - ref).norm() / ref.norm())
    print(f"D={D} Skv={Skv}: max {float((out - ref).abs().max()):.3g}, "
          f"rel {rel:.3g}")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    assert rel <= 1e-2


def batched_a8_slices_model(q, page_tokens, n_pages, k, vt, side, P):
    """kScratch8's schedule past 2048 (`wide_cluster_a8_slices`): the
    cluster of `cluster_plan(D)`, C blocks of k slices; q's row amax as the
    maximum of the blocks' partial maxima over their k slices, qi = rint(q /
    sq) (the levels the kernel writes to its scratch and streams a slice a
    step), qsum from the blocks' partial integer sums. Pass 1: each
    sub-tile's S (64 tokens, a page of 32 in one) as the sum of the blocks'
    s32 partials, a page's S held until its last sub-tile, then the page's
    softmax and requantization as in `batched_a8_cluster_model`, keeping
    wi, alpha, sw and csum a page. Pass 2 slice by slice, each page's two
    halves of 128 columns folded as acc * alpha + (wi . v) * sw - csum."""
    B, H, Sq, D = q.shape
    cols = 256 * qa.cluster_plan(D)[1]
    qb = q.to(torch.bfloat16).float()
    amax = _rank_max(qb, cols)
    sq = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qi = torch.round(qb / sq)
    qsum = _rank_sum(qi.double(), cols).float() * sq
    vcols = pa.vt_columns(vt.shape[-1])[:P]
    out = torch.zeros((B, H, Sq, D))
    lse = torch.full((B, H, Sq), pa.NEG_INF)
    for b in range(B):
        m = torch.full((H, Sq, 1), pa.NEG_INF)
        l = torch.zeros_like(m)
        kept = []
        for j in range(int(n_pages[b])):  # pass 1
            subs = [_partials_sum(qi[b].double(),
                                  k[b, :, j, h0:min(P, h0 + 64), :D].double(),
                                  cols)
                    for h0 in range(0, P, 64)]
            raw = torch.cat(subs, -1).float() * sq[b]
            ka, kb, vs, vz = (side[b, :, j, i, None, :P] for i in range(4))
            valid = torch.arange(P) < int(page_tokens[b, j])
            logits = torch.where(valid, raw * ka - kb * qsum[b], pa.NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            w = torch.where(valid, p * vs, 0.0)
            wmax = w.amax(-1, keepdim=True)
            sw = torch.where(wmax > 0, wmax / 127.0, torch.ones_like(wmax))
            kept.append((torch.round(w / sw), alpha, sw,
                         (w * vz).sum(-1, keepdim=True),
                         vt[b, :, j][..., vcols].float()))
            m = m_new
        acc = torch.zeros((H, Sq, D))
        for c0 in range(0, D, 256):  # pass 2, a slice at a time
            for wi, alpha, sw, corr, v_lv in kept:
                for h0 in range(c0, min(D, c0 + 256), 128):  # its halves
                    h1 = min(D, h0 + 128)
                    pv = wi @ v_lv[:, h0:h1].transpose(1, 2)
                    acc[..., h0:h1] = acc[..., h0:h1] * alpha + pv * sw - corr
        if int(n_pages[b]):
            out[b] = acc * (1.0 / l)
            lse[b] = (m + torch.log(l))[..., 0]
    return out, lse


@pytest.mark.parametrize("D,P,bits,G", [(2056, 72, 4, 1), (2056, 128, 8, 2),
                                        (4104, 32, 2, 1)])
def test_batched_a8_slices_schedule_matches_the_plain_version(D, P, bits, G):
    """Past 2048, at k = 2 (2056: a last block of one slice of 8 columns)
    and k = 3 (4104), pages of 72 (two sub-tiles), 128 (heads in groups of
    2) and 32 (one): the card tests' tolerance (rel Frobenius <= 5e-3, lse
    within 1e-3) over `_batched_scratch`'s slots, an empty slot giving 0
    and an lse of -1e30, and a page whose every token is masked weighing
    each key 1 in both."""
    q, nt, npg, k, v, sd = _batched_scratch(D, P, bits, G, True,
                                            D + P + bits + G)
    out, lse = batched_a8_slices_model(q, nt, npg, k, v, sd, P)
    ref, ref_lse = pa.batched_paged_attention_unpacked_plain(
        q, nt, npg, k, v, sd, P, return_lse=True)
    rel = float((out - ref).norm() / ref.norm())
    print(f"D={D} P={P} {bits}-bit G={G}: rel {rel:.3g}")
    assert torch.all(out[1] == 0) and torch.all(lse[1] == pa.NEG_INF)
    assert rel <= 5e-3
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
