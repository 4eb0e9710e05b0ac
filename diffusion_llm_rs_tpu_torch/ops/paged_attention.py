"""Flash attention over paged, quantized KV pools.

Counterpart of `diffusion_llm_rs_tpu/ops/pallas_paged_attention.py`:
`paged_attention` (one sequence, TPU kernel `_kernel`) and
`batched_paged_attention` (B slots over one pool, TPU kernel
`_batched_kernel`: its bf16 path, and with `act_bits=8` its int8 path, where
q, the centered K/V levels and the softmax weights folded with the V scale
all go through the int8 tensor cores), `merge_partials`, `degroup_pool` and
`degroup_sidecar`. On a CUDA tensor each wrapper launches its kernels (head
dims that are multiples of 8, with no upper limit, `head_dim_fits`; pages of
any multiple of 8 tokens up to 128, 1/2/4/8 bits, any head group dividing
the heads) and raises on anything else; on a CPU tensor it runs its plain
twin (`*_plain`), which repeats the TPU kernel's arithmetic page by page at
the same rounding points. A head of D up to 256 runs in the kernels'
instance of the smallest `KERNEL_WIDTHS` entry that holds it, past 256 in
the cluster design (`csrc/wide_cluster_flash.cuh`; the batched kernels'
entry points in `csrc/paged_flash_cluster.cu`, `paged_instance`,
`batched_instance`): from 264 to 2048 a cluster of ceil(D / 256) blocks,
each 256 columns of the head, past 2048 blocks of several slices of 256
columns (`ops/attention.py: cluster_plan`); the batched path's scratch rows
are `kernel_width(D)` wide (past 256, D rounded up to 64), zero past D.
Where D % 8 != 0 no kernel of either package serves the pools (JAX's need
rows of 128 lanes) and both wrappers take JAX's XLA paths on either
device: `paged_attention_fallback` (JAX's `_fallback`) and
`batched_paged_attention_fallback` (`_batched_fallback`).

`paged_attention` launches `csrc/quant_flash_paged.cu` (the design is
`csrc/quant_flash.cuh`, shared with `ops/attention.py: attention`: each page
unpacked once a 128-query block, S and P.V on wgmma). `batched_paged_attention`
launches two kernels a call: `paged_unpack` (`csrc/paged_unpack.cu`) unpacks
each live page of each (slot, head) once into a scratch of the operands the
attention kernel reads, then `csrc/batched_paged_attention.cu` (bf16) or
`csrc/paged_attention_a8.cu` (int8) attends over it by TMA and wgmma (the
design is in `csrc/paged_flash.cuh`). Its twin is the same two stages,
`paged_unpack_plain` and `batched_paged_attention_unpacked_plain`.

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
from diffusion_llm_rs_tpu_torch.ops.attention import (CLUSTER_KV_TILE,
                                                      KERNEL_WIDTHS,
                                                      _head_dim_error,
                                                      cluster_plan,
                                                      head_dim_fits, instance,
                                                      kernel_width,
                                                      replay_scratch,
                                                      split_scratch)
from diffusion_llm_rs_tpu_torch.quant.core import div_const

NEG_INF = -1e30
KERNEL_PAGE_SIZES = tuple(range(8, 129, 8))
KERNEL_BITS = (1, 2, 4, 8)
KERNEL_TILES = (32, 64, 128)


def tile_tokens(P: int) -> int:
    """The tile of 32, 64 or 128 tokens a page of P tokens runs in."""
    return next(t for t in KERNEL_TILES if P <= t)


def vt_columns(PT: int, device=None) -> torch.Tensor:
    """Column of each token in a row of the int8 path's V^T tile of PT
    tokens: within each 32 tokens, token i2*8 + t*2 + e moves to (i2 // 2)*16
    + t*4 + (i2 % 2)*2 + e, the order in which a thread of the int8 P.V
    product holds its softmax weights in the register A operand."""
    tok = torch.arange(PT, device=device)
    i2, t, e = (tok >> 3) & 3, (tok >> 1) & 3, tok & 1
    return (tok & ~31) + (i2 >> 1) * 16 + t * 4 + (i2 & 1) * 2 + e


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


def _dequant_pages(data, scale, zp, bits, slots):
    """The pages `slots` of a pool [n_slots, X, P/vpb, D], dequantized in f32
    in token order: [n, X, P, D]."""
    lv = unpack_levels(data.index_select(0, slots), bits).to(torch.float32)
    sc, z = (a.index_select(0, slots)[..., None] for a in (scale, zp))
    return (lv - z) * sc


def paged_attention_fallback(q, page_table, k_data, k_scale, k_zp, v_data,
                             v_scale, v_zp, bits: int, sm: float, page_tokens,
                             return_lse: bool = False):
    """JAX's `_fallback`, the XLA path of its `paged_attention`: the chain's
    pages gathered and dequantized in f32, f32 logits, tokens past
    page_tokens at -1e30, softmax, f32 out; the lse is the logits'
    log-sum-exp."""
    slots = page_table.to(torch.int64)
    n, BH = page_table.shape[0], q.shape[0]

    def chain(data, scale, zp):  # [BH, n * P, D]
        full = _dequant_pages(data, scale, zp, bits, slots)
        return full.transpose(0, 1).reshape(BH, -1, full.shape[-1])

    kd, vd = chain(k_data, k_scale, k_zp), chain(v_data, v_scale, v_zp)
    P = kd.shape[1] // n
    valid = (torch.arange(P, device=q.device)[None, :]
             < page_tokens.to(q.device)[:, None]).reshape(-1)
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), kd) * sm
    logits = torch.where(valid, logits, NEG_INF)
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(logits, dim=-1), vd)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def paged_attention(q, page_table, k_data, k_scale, k_zp, v_data, v_scale,
                    v_zp, bits: int, sm_scale=None, page_tokens=None,
                    return_lse: bool = False):
    """Flash attention of q [BH, Sq, D] over one paged quantized sequence.

    `page_table` int [n_pages] names the pool slot of each page;
    `page_tokens[j]` the valid tokens of page j (all full by default). The
    output is f32 [BH, Sq, D]; with `return_lse` also the log-sum-exp
    [BH, Sq], so partials over disjoint pages merge exactly
    (`merge_partials`). Where D % 8 != 0, JAX's XLA path on either device
    (`paged_attention_fallback`)."""
    if page_table.shape[0] == 0:
        raise ValueError("paged_attention: empty page table")
    D = q.shape[-1]
    if D % 8:  # JAX's XLA path, on either device
        if page_tokens is None:
            page_tokens = torch.full(page_table.shape,
                                     k_data.shape[2] * (8 // bits),
                                     dtype=torch.int32, device=q.device)
        return paged_attention_fallback(
            q, page_table, k_data, k_scale, k_zp, v_data, v_scale, v_zp, bits,
            sm_scale if sm_scale is not None else 1.0 / math.sqrt(D),
            page_tokens, return_lse)
    if q.device.type == "cpu":
        return paged_attention_plain(q, page_table, k_data, k_scale, k_zp,
                                     v_data, v_scale, v_zp, bits, sm_scale,
                                     page_tokens, return_lse)
    name = "paged_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if page_tokens is None:
        page_tokens = torch.full(page_table.shape,
                                 k_data.shape[2] * (8 // bits),
                                 dtype=torch.int32, device=q.device)
    BH, Sq, D = q.shape
    n_slots, n_pages = k_data.shape[0], page_table.shape[0]
    if page_tokens.shape != page_table.shape:
        raise ValueError(f"{name}: page table {tuple(page_table.shape)}, "
                         f"tokens {tuple(page_tokens.shape)}")
    Dp, P, pools = _check_pools(name, (page_table, page_tokens), k_data,
                                k_scale, k_zp, v_data, v_scale, v_zp, bits, 1)
    if k_data.shape[1] != BH or Dp != D:
        raise ValueError(f"{name}: pool {tuple(k_data.shape)} does not hold "
                         f"{BH} heads of {D}")
    if q.device != k_data.device:
        raise ValueError(f"{name}: inputs on different devices")
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    pt, nt = (t.to(torch.int32).contiguous() for t in (page_table, page_tokens))
    out = torch.empty((BH, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    suffix = paged_instance(D)
    args = (qb.data_ptr(), pt.data_ptr(), nt.data_ptr(),
            *(t.data_ptr() for t in pools), out.data_ptr(), lse.data_ptr(), BH,
            Sq, D, n_pages, n_slots, P, bits, float(sm),
            torch.cuda.current_stream(q.device).cuda_stream)
    if suffix == "_cluster":  # the chain split over clusters, merged in-launch
        n, *scratch = _cluster_splits(q.device, BH, Sq, D, n_pages, P)
        replay = replay_scratch(q.device, D, BH, Sq,
                                n_pages * -(-P // CLUSTER_KV_TILE))
        args += (n, *(None if t is None else t.data_ptr()
                      for t in (*scratch, replay)))
    err = _build.function(f"dlm_paged_attention{suffix}")(*args)
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return (out, lse) if return_lse else out


def paged_instance(D: int) -> str:
    """The suffix of the C entry point `paged_attention` launches for heads
    of D: `instance(D)` up to 256, and past it "_cluster" at every width
    (`dlm_paged_attention_cluster`: a block one 256-column slice of the head
    up to 2048, several past it, `cluster_plan`)."""
    return "_cluster" if D > KERNEL_WIDTHS[-1] else instance(D)


def _cluster_splits(device, BH, Sq, D, n_pages, P):
    """What `dlm_paged_attention_cluster` takes past the single-sequence
    arguments: the splits of the page chain (`csrc/wide_cluster_flash.cuh:
    paged_splits`) and `split_scratch` for them."""
    n = _build.function("dlm_paged_attention_cluster_splits")(
        BH, Sq, D, n_pages, P)
    if n < 0:
        _build.check(-n, "paged_attention")
    return (n, *split_scratch(device, n, BH, Sq, D))


# ----------------------------------------------------------------- batched


def paged_unpack_plain(page_tables, n_pages, k_data, k_scale, k_zp, v_data,
                       v_scale, v_zp, bits: int, sm_scale=None,
                       head_group: int = 1, a8: bool = False):
    """Plain twin of `paged_unpack`: the first n_pages[b] pages of each
    slot's table, every head, as the operands of the attention stage, each
    page padded to its tile of PT = `tile_tokens(P)` tokens with zeros, and
    each head's rows to DK = `kernel_width(D)` with zeros.

    bf16 (a8 False): K bf16 [B, H, n_max, PT, DK] levels; V bf16 [B, H,
    n_max, PT, DK] = bf16(v_lv * vs); side f32 [B, H, n_max, 3, PT] = (ka' =
    ks * sm, ka' * kz, vs * vz). int8 (a8 True), with off = 2^(bits-1): K
    int8 [B, H, n_max, PT, DK] = lv - off; V^T int8 [B, H, n_max, DK, PT] =
    lv - off with its columns in `vt_columns` order; side f32 [B, H, n_max,
    4, PT] = (ka', ka' * (kz - off), vs, vz - off). Pages past n_pages[b] are
    0 (the kernel leaves them unwritten)."""
    B, n_max = page_tables.shape
    n_slots, HG, Pp, GD = k_data.shape
    G = head_group
    H, D, P = HG * G, GD // G, Pp * (8 // bits)
    PT, DK = tile_tokens(P), kernel_width(D)
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = k_data.device
    live = torch.arange(n_max, device=dev)[None, :] < n_pages[:, None]
    slots = torch.where(live, page_tables, 0).reshape(-1).to(torch.int64)

    def levels(data):  # [B, H, n_max, P, D] int32
        lv = unpack_levels(data.index_select(0, slots), bits)
        return (lv.reshape(B, n_max, HG, P, G, D).permute(0, 2, 4, 1, 3, 5)
                .reshape(B, H, n_max, P, D))

    def side(arr):     # [B, H, n_max, P]
        return (arr.index_select(0, slots).reshape(B, n_max, HG, G, P)
                .permute(0, 2, 3, 1, 4).reshape(B, H, n_max, P))

    ks, kz, vs, vz = (side(a) for a in (k_scale, k_zp, v_scale, v_zp))
    ka = ks * sm
    k = torch.zeros((B, H, n_max, PT, DK), dtype=torch.int8 if a8 else
                    torch.bfloat16, device=dev)
    if a8:
        off = 1 << (bits - 1)
        k[..., :P, :D] = (levels(k_data) - off).to(torch.int8)
        v = torch.zeros((B, H, n_max, DK, PT), dtype=torch.int8, device=dev)
        v[..., :D, vt_columns(PT, dev)[:P]] = (levels(v_data) - off).to(
            torch.int8).transpose(3, 4)
        sides = (ka, ka * (kz - float(off)), vs, vz - float(off))
    else:
        k[..., :P, :D] = levels(k_data).to(torch.bfloat16)
        v = torch.zeros_like(k)
        v[..., :P, :D] = (levels(v_data).float() * vs[..., None]).to(
            torch.bfloat16)
        sides = (ka, ka * kz, vs * vz)
    sd = torch.zeros((B, H, n_max, len(sides), PT), dtype=torch.float32,
                     device=dev)
    sd[..., :P] = torch.stack(sides, dim=3)
    dead = ~live[:, None, :, None, None]
    return (k.masked_fill(dead, 0), v.masked_fill(dead, 0),
            sd.masked_fill(dead, 0.0))


def batched_paged_attention_unpacked_plain(q, page_tokens, n_pages, k, v,
                                           side, page_size: int,
                                           return_lse: bool = False,
                                           reciprocal: bool = False):
    """Plain twin of the attention stage of `batched_paged_attention`, over
    `paged_unpack_plain`'s operands of pages of `page_size` tokens (int8 K
    means the int8 path). The TPU `_batched_kernel`'s arithmetic:

    bf16: bf16 q and its f32 channel sum qsum; logits = raw * ka' - kb *
    qsum; acc = acc * alpha + bf16(p) . v_sc - sum(p * vc).
    int8: q quantized per (head, row): sq = amax / 127 (1 where 0), qi =
    round(q / sq), qsum = sum(qi) * sq; logits = (qi.k_lv * sq) * ka' - kb' *
    qsum; per page w = p * vs (0 on invalid tokens), sw = max_t w / 127 (1
    where 0), wi = round(w / sw); acc = acc * alpha + (wi.v_lv) * sw -
    sum(w * vz'). Both integer dots are exact in f32. The two divisions by
    127 are IEEE divisions, as in the CUDA kernel; `reciprocal` multiplies by
    the f32 reciprocal of 127 instead, as XLA compiles the interpreted JAX
    kernel on the CPU (`quant.core.div_const`).

    Tokens past page_tokens get logits of -1e30; out = acc * (1/l), and 0
    with lse -1e30 where a slot had no page. The operands' rows past q's D
    (zeros) are left out. (At kernel widths of 192 and 256 the bf16 kernel
    steps its softmax half a page of 128 at a time, this version a page.)"""
    B, H, Sq, D = q.shape
    n_max = k.shape[2]
    P = page_size
    a8 = k.dtype == torch.int8
    k = k[..., :D]
    v = v[..., :D, :] if a8 else v[..., :D]
    dev = q.device
    qb = _bf16(q)
    if a8:
        amax = qb.abs().amax(dim=-1, keepdim=True)           # [B, H, Sq, 1]
        sq = torch.where(amax > 0, div_const(amax, 127.0, reciprocal),
                         torch.ones_like(amax))
        qb = torch.round(qb / sq)
        qsum = qb.sum(dim=-1, keepdim=True) * sq
        cols = vt_columns(v.shape[-1], dev)[:P]
    else:
        qsum = qb.sum(dim=-1, keepdim=True)                  # [B, H, Sq, 1]
    tok = torch.arange(P, device=dev)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for j in range(n_max):
        live = (j < n_pages).reshape(B, 1, 1, 1)
        ka, kb, s2 = (side[:, :, j, i, None, :P] for i in range(3))
        k_lv = k[:, :, j, :P].float().contiguous()           # [B, H, P, D]
        raw = qb @ k_lv.transpose(2, 3)                      # [B, H, Sq, P]
        if a8:
            raw = raw * sq
        logits = raw * ka - kb * qsum
        valid = (tok[None, :] < page_tokens[:, j:j + 1]).reshape(B, 1, 1, P)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        if a8:
            w = torch.where(valid, p * s2, 0.0)
            wmax = w.amax(dim=-1, keepdim=True)
            sw = torch.where(wmax > 0, div_const(wmax, 127.0, reciprocal),
                             torch.ones_like(wmax))
            v_lv = v[:, :, j][..., cols].float().transpose(2, 3).contiguous()
            pv = (torch.round(w / sw) @ v_lv) * sw
            corr = (w * side[:, :, j, 3, None, :P]).sum(dim=-1, keepdim=True)
        else:
            pv = _bf16(p) @ v[:, :, j, :P].float().contiguous()
            corr = (p * s2).sum(dim=-1, keepdim=True)
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


def batched_paged_attention_fallback(q, page_tables, page_tokens, n_pages,
                                     k_data, k_scale, k_zp, v_data, v_scale,
                                     v_zp, bits: int, sm: float,
                                     return_lse: bool = False,
                                     head_group: int = 1):
    """JAX's `_batched_fallback`, the XLA path of `batched_paged_attention`
    (after `degroup_pool` where head_group > 1): every slot's chain gathered
    and dequantized in f32, tokens past page_tokens and pages past n_pages
    at -1e30, f32 softmax and out, whatever act_bits; a slot with no valid
    token gives 0 and lse -1e30. Table entries past n_pages read slot 0."""
    if head_group > 1:
        k_data, v_data = (degroup_pool(a, head_group) for a in (k_data, v_data))
        k_scale, k_zp, v_scale, v_zp = (degroup_sidecar(a, head_group) for a in
                                        (k_scale, k_zp, v_scale, v_zp))
    B, H, Sq, D = q.shape
    n_max = page_tables.shape[1]
    P = k_data.shape[2] * (8 // bits)
    dev = q.device
    page_ok = torch.arange(n_max, device=dev)[None, :] < n_pages[:, None]
    slots = torch.where(page_ok, page_tables, 0).reshape(-1).to(torch.int64)

    def chain(data, scale, zp):  # [B, H, n_max * P, D]
        full = _dequant_pages(data, scale, zp, bits, slots)
        return (full.reshape(B, n_max, H, P, D).transpose(1, 2)
                .reshape(B, H, n_max * P, D))

    kd, vd = chain(k_data, k_scale, k_zp), chain(v_data, v_scale, v_zp)
    tok_ok = torch.arange(P, device=dev)[None, None, :] < page_tokens[:, :, None]
    valid = (page_ok[:, :, None] & tok_ok).reshape(B, 1, 1, -1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kd) * sm
    logits = torch.where(valid, logits, NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), vd)
    any_valid = valid.any(dim=-1)                            # [B, 1, 1]
    out = torch.where(any_valid[..., None], out, 0.0)
    if return_lse:
        lse = torch.where(any_valid, torch.logsumexp(logits, dim=-1), NEG_INF)
        return out, lse
    return out


def batched_paged_attention_plain(q, page_tables, page_tokens, n_pages,
                                  k_data, k_scale, k_zp, v_data, v_scale,
                                  v_zp, bits: int, sm_scale=None,
                                  return_lse: bool = False,
                                  head_group: int = 1):
    """Plain twin of `batched_paged_attention`, the bf16 path of the TPU
    `_batched_kernel`: `paged_unpack_plain`, then
    `batched_paged_attention_unpacked_plain` (whose docstring holds the
    arithmetic)."""
    P = k_data.shape[2] * (8 // bits)
    k, v, side = paged_unpack_plain(page_tables, n_pages, k_data, k_scale,
                                    k_zp, v_data, v_scale, v_zp, bits,
                                    sm_scale, head_group)
    return batched_paged_attention_unpacked_plain(
        q, page_tokens, n_pages, k, v, side, P, return_lse)


def batched_paged_attention_a8_plain(q, page_tables, page_tokens, n_pages,
                                     k_data, k_scale, k_zp, v_data, v_scale,
                                     v_zp, bits: int, sm_scale=None,
                                     return_lse: bool = False,
                                     head_group: int = 1,
                                     reciprocal: bool = False):
    """Plain twin of `batched_paged_attention(act_bits=8)`, the int8 path of
    the TPU `_batched_kernel` (one page per step): `paged_unpack_plain(a8=
    True)`, then `batched_paged_attention_unpacked_plain`."""
    P = k_data.shape[2] * (8 // bits)
    k, v, side = paged_unpack_plain(page_tables, n_pages, k_data, k_scale,
                                    k_zp, v_data, v_scale, v_zp, bits,
                                    sm_scale, head_group, a8=True)
    return batched_paged_attention_unpacked_plain(
        q, page_tokens, n_pages, k, v, side, P, return_lse, reciprocal)


def paged_unpack(page_tables, n_pages, k_data, k_scale, k_zp, v_data,
                 v_scale, v_zp, bits: int, sm_scale=None, head_group: int = 1,
                 a8: bool = False):
    """The unpack stage of `batched_paged_attention`: (K, V or V^T, side) as
    `paged_unpack_plain` lays them out, pages past n_pages[b] left
    unwritten. On a CUDA tensor one launch of `csrc/paged_unpack.cu` (counted
    as `paged_unpack`); on a CPU tensor its plain twin."""
    if page_tables.device.type == "cpu":
        return paged_unpack_plain(page_tables, n_pages, k_data, k_scale, k_zp,
                                  v_data, v_scale, v_zp, bits, sm_scale,
                                  head_group, a8)
    name = "paged_unpack"
    if page_tables.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {page_tables.device}")
    B, n_max = page_tables.shape
    n_slots, HG = k_data.shape[:2]
    if n_pages.shape != (B,):
        raise ValueError(f"{name}: n_pages {tuple(n_pages.shape)} for the "
                         f"tables {tuple(page_tables.shape)}")
    D, P, pools = _check_pools(name, (page_tables, n_pages), k_data, k_scale,
                               k_zp, v_data, v_scale, v_zp, bits, head_group)
    H, PT, DK = HG * head_group, tile_tokens(P), kernel_width(D)
    if a8 and bits == 1:
        raise ValueError(f"{name}: 1-bit pages take the bf16 path")
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = k_data.device
    dtype = torch.int8 if a8 else torch.bfloat16
    k = torch.empty((B, H, n_max, PT, DK), dtype=dtype, device=dev)
    v = torch.empty((B, H, n_max, DK, PT) if a8 else (B, H, n_max, PT, DK),
                    dtype=dtype, device=dev)
    side = torch.empty((B, H, n_max, 4 if a8 else 3, PT), dtype=torch.float32,
                       device=dev)
    pt, npg = (t.to(torch.int32).contiguous() for t in (page_tables, n_pages))
    err = _build.function("dlm_paged_unpack")(
        pt.data_ptr(), npg.data_ptr(), *(t.data_ptr() for t in pools),
        k.data_ptr(), v.data_ptr(), side.data_ptr(), B, H, D, n_max, n_slots,
        head_group, P, PT, bits, int(a8), float(sm),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return k, v, side


def batched_instance(D: int, a8: bool) -> str:
    """The suffix of the batched kernels' C entry point for heads of D (the
    int8 path's where a8): "" up to 256 (the instance of the scratch's
    width, `paged_flash.cuh`), and past it "_cluster" on both paths (a block
    one 256-column slice of the head up to 2048, several past it,
    `cluster_plan`)."""
    return "" if D <= KERNEL_WIDTHS[-1] else "_cluster"


def _a8_slices_scratch(device, Z, Sq, D, DK, n_max, PT):
    """What `dlm_batched_paged_attention_a8_cluster` takes past the other
    batched arguments: past 2048 (`cluster_plan(D)[1] > 1`) q's int8 levels
    [Z, Sq, DK], which the kernel writes once and streams a slice a step,
    and `replay_scratch` for a page's wi, alpha, sw and csum (PT / 32 + 2
    words a thread and page of the `n_max` a slot); (None, None) at 264 to
    2048."""
    replay = replay_scratch(device, D, Z, Sq, n_max, PT // 32 + 2)
    if replay is None:
        return (None, None)
    return (torch.empty((Z, Sq, DK), dtype=torch.int8, device=device), replay)


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
    JAX package. On a CUDA tensor: `paged_unpack`, then one launch of the
    attention kernel (counted as `batched_paged_attention` or
    `batched_paged_attention_a8`). Where D % 8 != 0, JAX's XLA path on
    either device (`batched_paged_attention_fallback`, exact math at any
    act_bits)."""
    if act_bits not in (8, 16):
        raise ValueError(f"act_bits must be 8 or 16, got {act_bits}")
    a8 = act_bits == 8 and bits != 1
    D = q.shape[-1]
    if D % 8:  # JAX's XLA path, on either device
        return batched_paged_attention_fallback(
            q, page_tables, page_tokens, n_pages, k_data, k_scale, k_zp,
            v_data, v_scale, v_zp, bits,
            sm_scale if sm_scale is not None else 1.0 / math.sqrt(D),
            return_lse, head_group)
    if q.device.type == "cpu":
        plain = (batched_paged_attention_a8_plain if a8
                 else batched_paged_attention_plain)
        return plain(q, page_tables, page_tokens, n_pages, k_data, k_scale,
                     k_zp, v_data, v_scale, v_zp, bits, sm_scale, return_lse,
                     head_group)
    name = "batched_paged_attention_a8" if a8 else "batched_paged_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    G = head_group
    if G < 1 or H % G:
        raise ValueError(f"{name}: head group {G} does not divide {H} heads")
    if k_data.dim() != 4 or k_data.shape[1] != H // G or \
            k_data.shape[3] != G * D:
        raise ValueError(f"{name}: pool {tuple(k_data.shape)} does not hold "
                         f"{H} heads of {D} in groups of {G}")
    n_max = page_tables.shape[1]
    if page_tables.shape != (B, n_max) or page_tokens.shape != (B, n_max) \
            or n_pages.shape != (B,):
        raise ValueError(f"{name}: page tables {tuple(page_tables.shape)}, "
                         f"tokens {tuple(page_tokens.shape)} for batch {B}")
    if any(t.device != q.device for t in (page_tables, page_tokens, n_pages,
                                          k_data)):
        raise ValueError(f"{name}: inputs on different devices")
    k, v, side = paged_unpack(page_tables, n_pages, k_data, k_scale, k_zp,
                              v_data, v_scale, v_zp, bits, sm_scale, G, a8)
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    nt, npg = (t.to(torch.int32).contiguous() for t in (page_tokens, n_pages))
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # past 256 the cluster kernel, which also takes the scratch's rows and
    # the page's tokens, and past 2048 scratch for its pass 2 (the int8
    # path's also for q's levels)
    suffix = batched_instance(D, a8)
    P = k_data.shape[2] * (8 // bits)
    extra = (k.shape[4], P) if suffix else ()
    scratch = ()  # tensors: held until the launch
    if a8 and suffix:
        scratch = _a8_slices_scratch(q.device, B * H, Sq, D, k.shape[4],
                                     n_max, k.shape[3])
    elif suffix:
        scratch = (replay_scratch(q.device, D, B * H, Sq,
                                  n_max * -(-P // CLUSTER_KV_TILE)),)
    err = _build.function(f"dlm_{name}{suffix}")(
        qb.data_ptr(), nt.data_ptr(), npg.data_ptr(), k.data_ptr(),
        v.data_ptr(), side.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H,
        Sq, D, n_max, k.shape[3], *extra,
        torch.cuda.current_stream(q.device).cuda_stream,
        *(None if t is None else t.data_ptr() for t in scratch))
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return (out, lse) if return_lse else out


def _check_pools(name, tables, k_data, k_scale, k_zp, v_data, v_scale, v_zp,
                 bits, G):
    """Check the pools the kernels take, and that they lie beside the int
    `tables`; return (D, P, the pools contiguous)."""
    n_slots, HG, Pp, GD = k_data.shape
    if bits not in KERNEL_BITS:
        raise ValueError(f"{name}: bits {bits}, the kernel takes {KERNEL_BITS}")
    if G < 1 or GD % G:
        raise ValueError(f"{name}: head group {G} does not divide rows of {GD}")
    D, P = GD // G, Pp * (8 // bits)
    if not head_dim_fits(D):
        raise _head_dim_error(name, D)
    if P not in KERNEL_PAGE_SIZES:
        raise ValueError(f"{name}: page size {P}, the kernel takes multiples "
                         "of 8 tokens up to 128")
    for arr in (k_data, v_data):
        if arr.dtype != torch.uint8 or arr.shape != k_data.shape:
            raise ValueError(f"{name}: pages must be uint8 "
                             f"{tuple(k_data.shape)}")
    for arr in (k_scale, k_zp, v_scale, v_zp):
        if arr.dtype != torch.float32 or arr.shape != (n_slots, HG, G * P):
            raise ValueError(f"{name}: sidecars must be f32 "
                             f"{(n_slots, HG, G * P)}")
    pools = [t.contiguous() for t in (k_data, k_scale, k_zp, v_data, v_scale,
                                      v_zp)]
    if any(t.device != k_data.device for t in list(tables) + pools):
        raise ValueError(f"{name}: inputs on different devices")
    if any(t.data_ptr() % 16 for t in pools):
        raise ValueError(f"{name}: the pools must be 16-byte aligned")
    return D, P, pools
