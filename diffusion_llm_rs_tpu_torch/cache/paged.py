"""Paged quantized KV cache: fixed-size token pages, per-page bit-width.

Counterpart of `diffusion_llm_rs_tpu/cache/paged.py` (`quantize_page`,
`dequantize_page`, `PageHandle`, `PagedKVCache`). Pages are fixed token
blocks quantized per token when they are appended; each bit-width has its
own pool, and a page handle is (bits, slot, tokens). `quantize_page` equals
the JAX function bit for bit (packed bytes, scale, zero-point).

The pools are tensors allocated once on the cache's device (the card by
default) and written in place, where the JAX package rebuilds its arrays.
Pages spill to a `MemoryManager`'s host tier and come back on demand.
`gather_packed` hands a uniform-width chain to the quantized-KV attention of
the phase-aware sampler (`ops.attention.attention`) without requantizing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.cache.salience import allocate_bits
from diffusion_llm_rs_tpu_torch.ops.attention import QuantKV
from diffusion_llm_rs_tpu_torch.ops.paged_attention import (
    batched_paged_attention, merge_partials, paged_attention, unpack_levels)
from diffusion_llm_rs_tpu_torch.quant.core import true_div


def quantize_page(x: torch.Tensor, bits: int):
    """Per-token quantize one page [BH, P, D] into the token-block-packed
    layout: data uint8 [BH, P/vpb, D], byte (t, d) holding the levels of
    tokens t + p*(P/vpb) in bit field p. Returns (data, scale [BH, P],
    zp [BH, P])."""
    BH, P, D = x.shape
    vpb = 8 // bits
    if P % vpb:
        raise ValueError(f"page tokens {P} not divisible by {vpb}")
    x = x.to(torch.float32)
    qmax = float((1 << bits) - 1)
    mn = x.amin(dim=-1)
    rng = x.amax(dim=-1) - mn
    scale = torch.where(rng > 0, true_div(rng, qmax), torch.ones_like(rng))
    zp = -mn / scale
    lv = torch.clamp(torch.round(x / scale[..., None] + zp[..., None]),
                     0.0, qmax).to(torch.uint8)
    Pp = P // vpb
    if bits == 8:
        data = lv
    else:
        acc = lv[:, 0:Pp].to(torch.int32)
        for p in range(1, vpb):
            acc = acc | (lv[:, p * Pp:(p + 1) * Pp].to(torch.int32)
                         << (p * bits))
        data = acc.to(torch.uint8)
    return data, scale, zp


def dequantize_page(data: torch.Tensor, scale: torch.Tensor,
                    zp: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of quantize_page: [BH, P/vpb, D] -> [BH, P, D] f32."""
    lv = unpack_levels(data, bits).to(torch.float32)
    return (lv - zp[..., None]) * scale[..., None]


@dataclasses.dataclass
class PageHandle:
    bits: int
    slot: int    # -1 while the page is spilled
    tokens: int  # valid tokens in this page (<= page_size)


POOL_FIELDS = ("k_data", "v_data", "k_scale", "k_zp", "v_scale", "v_zp")


@dataclasses.dataclass
class _Pool:
    """Page pool of one bit-width: data uint8 [n, BH, P/vpb, D], sidecars
    f32 [n, BH, P]."""

    k_data: torch.Tensor
    v_data: torch.Tensor
    k_scale: torch.Tensor
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor
    free: List[int] = dataclasses.field(default_factory=list)


class PagedKVCache:
    """Page-pooled quantized KV store for one model (layers x heads folded
    into the BH axis)."""

    def __init__(self, bh: int, head_dim: int, page_size: int = 64,
                 pages_per_bits: Optional[Dict[int, int]] = None,
                 memory_manager=None, device="cuda"):
        self.bh = bh
        self.head_dim = head_dim
        self.page_size = page_size
        self.memory_manager = memory_manager
        self.device = torch.device(device)
        pages_per_bits = pages_per_bits or {8: 64, 4: 128, 2: 128, 1: 64}
        self._pools: Dict[int, _Pool] = {}
        for bits, n in pages_per_bits.items():
            vpb = 8 // bits
            shape_d = (n, bh, page_size // vpb, head_dim)
            shape_s = (n, bh, page_size)

            def zeros(shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self._pools[bits] = _Pool(
                k_data=zeros(shape_d, torch.uint8),
                v_data=zeros(shape_d, torch.uint8),
                k_scale=torch.ones(shape_s, device=self.device),
                k_zp=zeros(shape_s),
                v_scale=torch.ones(shape_s, device=self.device),
                v_zp=zeros(shape_s),
                free=list(range(n - 1, -1, -1)))
        # sequence id -> ordered page handles
        self.page_tables: Dict[str, List[PageHandle]] = {}

    # -- page lifecycle -------------------------------------------------------

    def num_free(self, bits: int) -> int:
        return len(self._pools[bits].free)

    def _alloc(self, bits: int) -> int:
        pool = self._pools[bits]
        if not pool.free:
            raise MemoryError(f"no free {bits}-bit pages")
        return pool.free.pop()

    def _write(self, pool: _Pool, slot: int, values: Dict[str, torch.Tensor]):
        for name, val in values.items():
            getattr(pool, name)[slot].copy_(val)

    def append(self, seq_id: str, k: torch.Tensor, v: torch.Tensor,
               bits: int) -> List[PageHandle]:
        """Append [BH, S, D] K/V, quantized at `bits`, page by page."""
        BH, S, D = k.shape
        if BH != self.bh or D != self.head_dim:
            raise ValueError(f"K/V {tuple(k.shape)} for a cache of "
                             f"{self.bh} x {self.head_dim}")
        handles = self.page_tables.setdefault(seq_id, [])
        P = self.page_size
        for start in range(0, S, P):
            tokens = min(P, S - start)
            kc = k[:, start:start + tokens].to(self.device)
            vc = v[:, start:start + tokens].to(self.device)
            if tokens < P:  # pad the tail page
                kc = torch.nn.functional.pad(kc, (0, 0, 0, P - tokens))
                vc = torch.nn.functional.pad(vc, (0, 0, 0, P - tokens))
            kd, ks, kz = quantize_page(kc, bits)
            vd, vs, vz = quantize_page(vc, bits)
            slot = self._alloc(bits)
            self._write(self._pools[bits], slot, dict(
                k_data=kd, v_data=vd, k_scale=ks, k_zp=kz, v_scale=vs,
                v_zp=vz))
            handles.append(PageHandle(bits=bits, slot=slot, tokens=tokens))
        return handles

    def append_salient(self, seq_id: str, k: torch.Tensor, v: torch.Tensor,
                       scores: np.ndarray, budget_bits: float,
                       bit_options: Sequence[int] = (8, 4, 2, 1)) -> None:
        """Per-page bit-widths from salience scores under an average-bits
        budget (`allocate_bits`); each page quantized at its own width."""
        S = k.shape[1]
        P = self.page_size
        n_pages = -(-S // P)
        page_scores = np.asarray([
            float(np.max(scores[i * P:(i + 1) * P])) for i in range(n_pages)])
        bits_per_page = allocate_bits(page_scores, budget_bits, bit_options)
        for i in range(n_pages):
            self.append(seq_id, k[:, i * P:(i + 1) * P],
                        v[:, i * P:(i + 1) * P], int(bits_per_page[i]))

    def _chain(self, seq_id: str) -> List[PageHandle]:
        """A sequence's handles, with spilled pages restored."""
        handles = self.page_tables.get(seq_id)
        if not handles:
            raise KeyError(f"unknown sequence {seq_id!r}")
        for i, h in enumerate(handles):
            if h.slot == -1:
                self.restore_page(seq_id, i)
        return handles

    def gather(self, seq_id: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """A sequence's full K/V [BH, S, D], dequantized page by page."""
        ks, vs = [], []
        for h in self._chain(seq_id):
            pool = self._pools[h.bits]
            kd = dequantize_page(pool.k_data[h.slot], pool.k_scale[h.slot],
                                 pool.k_zp[h.slot], h.bits)
            vd = dequantize_page(pool.v_data[h.slot], pool.v_scale[h.slot],
                                 pool.v_zp[h.slot], h.bits)
            ks.append(kd[:, :h.tokens])
            vs.append(vd[:, :h.tokens])
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    def gather_packed(self, seq_id: str) -> Tuple[QuantKV, QuantKV]:
        """A sequence's K/V as contiguous D-packed `QuantKV`s for
        `ops.attention.attention`: the pools' token-block-packed levels
        repacked along D, exactly (nothing is requantized). Needs a
        uniform-width chain whose pages before the last are full."""
        handles = self._chain(seq_id)
        bits = handles[0].bits
        if any(h.bits != bits for h in handles):
            raise ValueError("mixed-precision chain: use gather()")
        # the flatten-and-slice below is dense only if every page before the
        # last is full
        if any(h.tokens != self.page_size for h in handles[:-1]):
            raise ValueError("interior partial page: use gather()")
        pool = self._pools[bits]
        slots = torch.tensor([h.slot for h in handles], dtype=torch.int64,
                             device=self.device)
        vpb = 8 // bits
        D = self.head_dim
        total = sum(h.tokens for h in handles)

        def repacked(arr):  # [n, BH, P/vpb, D] -> [BH, total, D/vpb]
            lv = unpack_levels(arr.index_select(0, slots), bits)
            lv = lv.transpose(0, 1).reshape(self.bh, -1, D)[:, :total]
            Dp = D // vpb
            acc = lv[..., 0:Dp]
            for p in range(1, vpb):
                acc = acc | (lv[..., p * Dp:(p + 1) * Dp] << (p * bits))
            return acc.to(torch.uint8)

        def side(arr):      # [n, BH, P] -> [BH, total]
            return (arr.index_select(0, slots).transpose(0, 1)
                    .reshape(self.bh, -1)[:, :total].contiguous())

        qk = QuantKV(data=repacked(pool.k_data), scale=side(pool.k_scale),
                     zero_point=side(pool.k_zp), bits=bits, D=D)
        qv = QuantKV(data=repacked(pool.v_data), scale=side(pool.v_scale),
                     zero_point=side(pool.v_zp), bits=bits, D=D)
        return qk, qv

    def attend(self, seq_id: str, q: torch.Tensor,
               sm_scale: Optional[float] = None) -> torch.Tensor:
        """Flash attention of q [BH, Sq, D] over the sequence's paged KV:
        one `paged_attention` call per bit-width bucket over that bucket's
        pages, partials merged by log-sum-exp."""
        buckets: Dict[int, List[PageHandle]] = {}
        for h in self._chain(seq_id):
            buckets.setdefault(h.bits, []).append(h)
        parts = []
        for bits, hs in sorted(buckets.items()):
            pool = self._pools[bits]
            pt = torch.tensor([h.slot for h in hs], dtype=torch.int32,
                              device=q.device)
            nt = torch.tensor([h.tokens for h in hs], dtype=torch.int32,
                              device=q.device)
            parts.append(paged_attention(
                q, pt, pool.k_data, pool.k_scale, pool.k_zp, pool.v_data,
                pool.v_scale, pool.v_zp, bits=bits, sm_scale=sm_scale,
                page_tokens=nt, return_lse=True))
        return merge_partials(parts)

    def batched_attend(self, seq_ids: Sequence[Optional[str]],
                       q: torch.Tensor,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
        """Serving-path attention: q [B, H, Sq, D], one sequence per batch
        slot (None = inactive slot -> zeros). Each slot reads its own page
        chain through `batched_paged_attention`; mixed-precision chains
        bucket by bit-width and merge, as in `attend`."""
        B = q.shape[0]
        if len(seq_ids) != B:
            raise ValueError(f"{len(seq_ids)} seq_ids for batch {B}")
        chains = [[] if sid is None else self._chain(sid) for sid in seq_ids]
        all_bits = sorted({h.bits for hs in chains for h in hs})
        if not all_bits:
            return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        parts = []
        for bits in all_bits:
            per_slot = [[h for h in hs if h.bits == bits] for hs in chains]
            n_max = max(1, max(len(hs) for hs in per_slot))
            pt = np.zeros((B, n_max), np.int32)
            nt = np.zeros((B, n_max), np.int32)
            npg = np.zeros((B,), np.int32)
            for b, hs in enumerate(per_slot):
                npg[b] = len(hs)
                for j, h in enumerate(hs):
                    pt[b, j] = h.slot
                    nt[b, j] = h.tokens
            pool = self._pools[bits]
            parts.append(batched_paged_attention(
                q, *(torch.from_numpy(a).to(q.device) for a in (pt, nt, npg)),
                pool.k_data, pool.k_scale, pool.k_zp, pool.v_data,
                pool.v_scale, pool.v_zp, bits=bits, sm_scale=sm_scale,
                return_lse=True))
        return merge_partials(parts)

    def _spill_key(self, seq_id: str, page_idx: int, name: str) -> str:
        return f"kvpage:{seq_id}:{page_idx}:{name}"

    def free(self, seq_id: str) -> int:
        """Release a sequence's pages back to the pools. A spilled page
        (slot -1) holds no slot; its host-tier payload is reclaimed."""
        handles = self.page_tables.pop(seq_id, [])
        for i, h in enumerate(handles):
            if h.slot == -1:
                if self.memory_manager is not None:
                    for name in POOL_FIELDS:
                        key = self._spill_key(seq_id, i, name)
                        if self.memory_manager.contains(key):
                            self.memory_manager.deallocate(key)
                continue
            self._pools[h.bits].free.append(h.slot)
        return len(handles)

    def seq_len(self, seq_id: str) -> int:
        return sum(h.tokens for h in self.page_tables.get(seq_id, []))

    def memory_usage(self) -> int:
        """Bytes held by allocated (non-free) pages, packed + sidecars."""
        total = 0
        for pool in self._pools.values():
            n_alloc = pool.k_data.shape[0] - len(pool.free)
            per_page = (2 * pool.k_data[0].numel() +      # k+v packed
                        4 * pool.k_scale[0].numel() * 4)  # four f32 sidecars
            total += n_alloc * per_page
        return total

    def spill_page(self, seq_id: str, page_idx: int) -> None:
        """Move one page to the MemoryManager's host tier; its slot goes
        back to the pool."""
        if self.memory_manager is None:
            raise RuntimeError("no MemoryManager attached")
        h = self.page_tables[seq_id][page_idx]
        if h.slot == -1:
            return  # already spilled
        pool = self._pools[h.bits]
        for name in POOL_FIELDS:
            self.memory_manager.allocate(
                self._spill_key(seq_id, page_idx, name),
                getattr(pool, name)[h.slot], tier="host")
        pool.free.append(h.slot)
        h.slot = -1

    def restore_page(self, seq_id: str, page_idx: int) -> None:
        h = self.page_tables[seq_id][page_idx]
        if h.slot != -1:
            return
        mm = self.memory_manager
        slot = self._alloc(h.bits)
        values = {}
        for name in POOL_FIELDS:
            key = self._spill_key(seq_id, page_idx, name)
            values[name] = torch.from_numpy(np.asarray(mm.get(key)))
            mm.deallocate(key)
        self._write(self._pools[h.bits], slot, values)
        h.slot = slot
