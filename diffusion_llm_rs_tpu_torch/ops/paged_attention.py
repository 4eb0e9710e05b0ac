"""Flash attention over paged, quantized KV pools.

Counterpart of `diffusion_llm_rs_tpu/ops/pallas_paged_attention.py`:
`paged_attention` (one sequence, TPU kernel `_kernel`) and
`batched_paged_attention` (B slots over one pool, TPU kernel
`_batched_kernel`: its bf16 path, and with `act_bits=8` its int8 path, where
q, the centered K/V levels and the softmax weights folded with the V scale
all go through the int8 tensor cores), `merge_partials`, `degroup_pool` and
`degroup_sidecar`. On a CUDA tensor each wrapper launches its kernel of
`csrc/paged_attention.cu` or `csrc/paged_attention_a8.cu` (head dims 32, 64
and 128, pages of any multiple of 8 tokens up to 128, 1/2/4/8 bits, any head
group dividing the heads) and raises on anything else; on a CPU tensor it
runs its plain twin (`*_plain`), which repeats the TPU kernel's arithmetic
page by page at the same rounding points.

The pools keep the JAX layout, so arrays cross between the packages as they
are:
  - data: uint8 [n_slots, H/G, P/vpb, G*D], token-block packed: byte (t, d)
    holds the levels of tokens t + p*P/vpb in bit field p (vpb = 8 / bits);
  - sidecars (k_scale, k_zp, v_scale, v_zp): f32 [n_slots, H/G, G*P];
  - head h reads lanes (h % G)*D.. and sidecar columns (h % G)*P.. of
    group h // G.
The single-sequence function takes G = 1 pools, [n_slots, BH, P/vpb, D].
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.quant.core import div_const

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_PAGE_SIZES = tuple(range(8, 129, 8))
KERNEL_BITS = (1, 2, 4, 8)


def unpack_levels(data: torch.Tensor, bits: int) -> torch.Tensor:
    """Token-block-packed bytes [..., P/vpb, X] -> int32 levels [..., P, X]
    in token order."""
    vpb = 8 // bits
    mask = (1 << bits) - 1
    d32 = data.to(torch.int32)
    return torch.cat([(d32 >> (p * bits)) & mask for p in range(vpb)], dim=-2)


def merge_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> torch.Tensor:
    """Flash-merge of attention partials (out [..., Sq, D], lse [..., Sq])
    over disjoint key sets, e.g. one per bit-width bucket. A row with no key
    in any part (all lse -1e30, outputs 0) stays 0."""
    if len(parts) == 1:
        return parts[0][0]
    lses = torch.stack([p[1] for p in parts])
    outs = torch.stack([p[0] for p in parts])
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)
    denom = w.sum(dim=0)
    num = (outs * w[..., None]).sum(dim=0)
    return num / torch.where(denom > 0, denom, torch.ones_like(denom))[..., None]


def degroup_pool(data: torch.Tensor, G: int) -> torch.Tensor:
    """[n_slots, H/G, Pp, G*D] grouped pages -> [n_slots, H, Pp, D]."""
    n, HG, Pp, GD = data.shape
    D = GD // G
    return (data.reshape(n, HG, Pp, G, D).permute(0, 1, 3, 2, 4)
            .reshape(n, HG * G, Pp, D))


def degroup_sidecar(s: torch.Tensor, G: int) -> torch.Tensor:
    """[n_slots, H/G, G*P] grouped sidecars -> [n_slots, H, P]."""
    n, HG, GP = s.shape
    return s.reshape(n, HG * G, GP // G)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------- one sequence


def paged_attention_plain(q, page_table, k_data, k_scale, k_zp, v_data,
                          v_scale, v_zp, bits: int, sm_scale=None,
                          page_tokens=None, return_lse: bool = False):
    """Plain twin of `paged_attention`, the TPU `_kernel`'s arithmetic:
    logits = (q.lv_k * ks - qsum * (ks*kz)) * sm_scale over bf16 q; the V
    scale folds into P (ps = bf16(p * vs) times the raw levels) with the
    zero-point as a row correction sum(p*vs*vz); out = acc / l, f32."""
    BH, Sq, D = q.shape
    n_pages = page_table.shape[0]
    if n_pages == 0:
        raise ValueError("paged_attention: empty page table")
    P = k_data.shape[2] * (8 // bits)
    if page_tokens is None:
        page_tokens = torch.full((n_pages,), P, dtype=torch.int32,
                                 device=q.device)
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qb = _bf16(q)
    qsum = qb.sum(dim=-1, keepdim=True)                       # [BH, Sq, 1]
    tok = torch.arange(P, device=q.device)
    m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(n_pages):
        slot = page_table[j:j + 1].to(torch.int64)
        k_lv = unpack_levels(k_data.index_select(0, slot)[0], bits).float()
        v_lv = unpack_levels(v_data.index_select(0, slot)[0], bits).float()
        ks, kz, vs, vz = (a.index_select(0, slot)[0][:, None, :]
                          for a in (k_scale, k_zp, v_scale, v_zp))
        raw = qb @ k_lv.transpose(1, 2)                       # [BH, Sq, P]
        logits = (raw * ks - qsum * (ks * kz)) * sm
        valid = tok < page_tokens[j]
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = _bf16(p * vs) @ v_lv
        corr = (p * vs * vz).sum(dim=-1, keepdim=True)
        acc = acc * alpha + pv - corr
        m = m_new
    out = acc / l
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def paged_attention(q, page_table, k_data, k_scale, k_zp, v_data, v_scale,
                    v_zp, bits: int, sm_scale=None, page_tokens=None,
                    return_lse: bool = False):
    """Flash attention of q [BH, Sq, D] over one paged quantized sequence.

    `page_table` int [n_pages] names the pool slot of each page;
    `page_tokens[j]` the valid tokens of page j (all full by default). The
    output is f32 [BH, Sq, D]; with `return_lse` also the log-sum-exp
    [BH, Sq], so partials over disjoint pages merge exactly
    (`merge_partials`)."""
    if page_table.shape[0] == 0:
        raise ValueError("paged_attention: empty page table")
    if q.device.type == "cpu":
        return paged_attention_plain(q, page_table, k_data, k_scale, k_zp,
                                     v_data, v_scale, v_zp, bits, sm_scale,
                                     page_tokens, return_lse)
    if page_tokens is None:
        page_tokens = torch.full(page_table.shape,
                                 k_data.shape[2] * (8 // bits),
                                 dtype=torch.int32, device=q.device)
    out, lse = _launch("paged_attention", "dlm_paged_attention", q[None],
                       page_table[None], page_tokens[None], None, k_data,
                       k_scale, k_zp, v_data, v_scale, v_zp, bits, sm_scale, 1)
    out, lse = out[0], lse[0]
    return (out, lse) if return_lse else out


# ----------------------------------------------------------------- batched


def batched_paged_attention_plain(q, page_tables, page_tokens, n_pages,
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


def batched_paged_attention_a8_plain(q, page_tables, page_tokens, n_pages,
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


def batched_paged_attention(q, page_tables, page_tokens, n_pages, k_data,
                            k_scale, k_zp, v_data, v_scale, v_zp, bits: int,
                            sm_scale=None, return_lse: bool = False,
                            head_group: int = 1, act_bits: int = 16):
    """Flash attention for B independent sequences over one page pool.

    q [B, H, Sq, D]; `page_tables`, `page_tokens` int [B, n_max] (slot and
    valid tokens of each slot's pages); `n_pages` int [B], the pages each
    slot reads (0 = inactive: zeros and lse -1e30). Output f32
    [B, H, Sq, D], with `return_lse` also the lse [B, H, Sq].

    act_bits=8 runs both products in int8 (q per row, the folded softmax
    weights per page and query); 1-bit pages keep the bf16 path, as in the
    JAX package."""
    if act_bits not in (8, 16):
        raise ValueError(f"act_bits must be 8 or 16, got {act_bits}")
    a8 = act_bits == 8 and bits != 1
    if q.device.type == "cpu":
        plain = (batched_paged_attention_a8_plain if a8
                 else batched_paged_attention_plain)
        return plain(q, page_tables, page_tokens, n_pages, k_data, k_scale,
                     k_zp, v_data, v_scale, v_zp, bits, sm_scale, return_lse,
                     head_group)
    name = "batched_paged_attention_a8" if a8 else "batched_paged_attention"
    out, lse = _launch(name, f"dlm_{name}", q, page_tables, page_tokens,
                       n_pages, k_data, k_scale, k_zp, v_data, v_scale, v_zp,
                       bits, sm_scale, head_group)
    return (out, lse) if return_lse else out


def _launch(name, fn, q, page_tables, page_tokens, n_pages, k_data, k_scale,
            k_zp, v_data, v_scale, v_zp, bits, sm_scale, G):
    """Check what the kernel takes and launch it: q [B, H, Sq, D], tables
    [B, n_max], `n_pages` [B] or None (one sequence over all n_max pages)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}, the kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")
    if bits not in KERNEL_BITS:
        raise ValueError(f"{name}: bits {bits}, the kernel takes {KERNEL_BITS}")
    if G < 1 or H % G:
        raise ValueError(f"{name}: head group {G} does not divide {H} heads")
    n_slots, HG, Pp, GD = k_data.shape
    P = Pp * (8 // bits)
    if P not in KERNEL_PAGE_SIZES:
        raise ValueError(f"{name}: page size {P}, the kernel takes multiples "
                         "of 8 tokens up to 128")
    if HG != H // G or GD != G * D:
        raise ValueError(f"{name}: pool {tuple(k_data.shape)} does not hold "
                         f"{H} heads of {D} in groups of {G}")
    n_max = page_tables.shape[1]
    if page_tables.shape != (B, n_max) or page_tokens.shape != (B, n_max) \
            or (n_pages is not None and n_pages.shape != (B,)):
        raise ValueError(f"{name}: page tables {tuple(page_tables.shape)}, "
                         f"tokens {tuple(page_tokens.shape)} for batch {B}")
    for arr in (k_data, v_data):
        if arr.dtype != torch.uint8 or arr.shape != k_data.shape:
            raise ValueError(f"{name}: pages must be uint8 "
                             f"{tuple(k_data.shape)}")
    for arr in (k_scale, k_zp, v_scale, v_zp):
        if arr.dtype != torch.float32 or arr.shape != (n_slots, HG, G * P):
            raise ValueError(f"{name}: sidecars must be f32 "
                             f"{(n_slots, HG, G * P)}")
    tensors = [q, page_tables, page_tokens, k_data, k_scale, k_zp, v_data,
               v_scale, v_zp] + ([] if n_pages is None else [n_pages])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qb = q.to(torch.bfloat16).contiguous()
    pt, nt = (t.to(torch.int32).contiguous() for t in (page_tables, page_tokens))
    pools = [t.contiguous() for t in (k_data, k_scale, k_zp, v_data, v_scale,
                                      v_zp)]
    if any(t.data_ptr() % 16 for t in [qb] + pools):
        raise ValueError(f"{name}: q and the pools must be 16-byte aligned")
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if n_pages is None:
        err = _build.function(fn)(
            qb.data_ptr(), pt.data_ptr(), nt.data_ptr(),
            *(t.data_ptr() for t in pools), out.data_ptr(), lse.data_ptr(),
            H, Sq, D, n_max, n_slots, P, bits, float(sm), stream)
    else:
        npg = n_pages.to(torch.int32).contiguous()
        err = _build.function(fn)(
            qb.data_ptr(), pt.data_ptr(), nt.data_ptr(), npg.data_ptr(),
            *(t.data_ptr() for t in pools), out.data_ptr(), lse.data_ptr(),
            B, H, Sq, D, n_max, n_slots, G, P, bits, float(sm), stream)
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return out, lse
