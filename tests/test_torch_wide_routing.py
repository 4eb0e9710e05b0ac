"""Which design serves each head width, and the cluster design's arithmetic.

Dense and single-sequence paged attention run heads of 264 to 2048 in the
cluster kernels of `csrc/wide_cluster_flash.cuh` (ceil(D / 256) blocks, each
256 columns of the head, the partial S summed in rank order), and past 2048
in `csrc/wide_flash.cuh`; the other attention kernels keep `wide_flash.cuh`
past 256. The routing is plain Python (`ops/attention.py: instance`,
`cluster_blocks`), checked here without a card. The models below repeat the
cluster kernels' schedule in torch on the CPU (tiles of 32 tokens, the S of
each tile summed from 256-column partials in rank order, q's channel sum
likewise, the paged chain split and merged) and hold it against the plain
versions the card tests hold the kernels against, at those tests'
tolerances. No JAX.
"""

import math

import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu_torch.ops import attention as qa
from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa

# (D, blocks of a cluster, dense and paged suffix, quant_attention suffix)
ROUTES = [
    (8, 0, "", "_padded"), (64, 0, "", ""), (200, 0, "", "_padded"),
    (256, 0, "", ""), (264, 2, "_cluster", "_wide"),
    (272, 2, "_cluster", "_wide"), (384, 2, "_cluster", "_wide"),
    (512, 2, "_cluster", "_wide"), (520, 3, "_cluster", "_wide"),
    (768, 3, "_cluster", "_wide"), (1024, 4, "_cluster", "_wide"),
    (2048, 8, "_cluster", "_wide"), (2056, 0, "_wide", "_wide"),
    (4096, 0, "_wide", "_wide")]


@pytest.mark.parametrize("D,blocks,cluster,other", ROUTES)
def test_each_head_width_reaches_its_design(D, blocks, cluster, other):
    assert qa.cluster_blocks(D) == blocks
    assert qa.instance(D, cluster=True) == (cluster or other)
    assert qa.instance(D) == other


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
