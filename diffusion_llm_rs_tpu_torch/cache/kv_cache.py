"""Phase-aware quantized KV cache with progressive precision and byte-budget
eviction.

Counterpart of `diffusion_llm_rs_tpu/cache/kv_cache.py`:
  - `QuantizedKVEntry`: a quantized K/V pair,
  - `KVCacheEntry`: the latest full-precision K/V plus lazily built
    quantized copies for the prefill phase (more bits) and the decode phase
    (fewer bits, possibly lowered mid-sampling),
  - `KVCacheManager`: a keyed map of entries with byte accounting; eviction
    frees the largest entries first until the deficit is covered.

K/V layout: [L, B, S, H, Hd] (stacked per layer, as
`models.denoiser.denoiser_forward(..., return_kv=True)` returns them).
Quantization is per token and head: one (scale, zero-point) per
[L, B, S, H] slice, over the trailing feature axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from diffusion_llm_rs_tpu_torch.quant.core import (
    QuantizedTensor,
    dequantize,
    quantize,
    true_div,
)


def _quantize_kv(arr: torch.Tensor, bits: int) -> QuantizedTensor:
    """Per-token-per-head quantization: min/max over the last (feature)
    axis, sidecars kept with that axis at size 1."""
    x = torch.as_tensor(arr).to(torch.float32)
    mn = x.amin(dim=-1, keepdim=True)
    mx = x.amax(dim=-1, keepdim=True)
    qmax = float((1 << bits) - 1)
    rng = mx - mn
    scale = torch.where(rng > 0, true_div(rng, qmax), 1.0)
    zp = -mn / scale
    return quantize(x, bits, granularity="channel", axis=x.ndim - 1,
                    scale=scale, zero_point=zp)


@dataclasses.dataclass
class QuantizedKVEntry:
    """Quantized K/V pair."""

    keys: QuantizedTensor
    values: QuantizedTensor
    seq_len: int

    @classmethod
    def create(cls, keys: torch.Tensor, values: torch.Tensor,
               bits: int) -> "QuantizedKVEntry":
        seq_len = keys.shape[2] if keys.ndim >= 3 else keys.shape[0]
        return cls(keys=_quantize_kv(keys, bits),
                   values=_quantize_kv(values, bits), seq_len=seq_len)

    def dequantize_keys(self) -> torch.Tensor:
        return dequantize(self.keys)

    def dequantize_values(self) -> torch.Tensor:
        return dequantize(self.values)

    def memory_usage(self) -> int:
        return (self.keys.packed_nbytes() + self.keys.sidecar_nbytes() +
                self.values.packed_nbytes() + self.values.sidecar_nbytes())


class KVCacheEntry:
    """Phase-aware dual-precision cache entry.

    Holds the latest full-precision K/V plus lazily-built quantized copies for
    the prefill phase (higher bits) and decode phase (lower bits, possibly
    progressively reduced mid-sampling).
    """

    def __init__(self, keys: torch.Tensor, values: torch.Tensor,
                 prefill_bits: int = 8, decode_bits: int = 4):
        self.keys = keys
        self.values = values
        self.prefill_quant_bits = prefill_bits
        self.decode_quant_bits = decode_bits
        self.is_prefill_phase = True
        self.seq_len = int(keys.shape[2]) if keys.ndim >= 3 else 0
        self._prefill_quantized: Optional[QuantizedKVEntry] = None
        self._decode_quantized: Optional[QuantizedKVEntry] = None
        if prefill_bits > 0 and self.seq_len > 0:
            self._prefill_quantized = QuantizedKVEntry.create(
                keys, values, prefill_bits)

    # -- phase management --------------------------------

    def set_phase(self, is_prefill: bool) -> None:
        self.transition_phase(is_prefill)

    def transition_phase(self, is_prefill: bool) -> None:
        if self.is_prefill_phase == is_prefill:
            return
        self.is_prefill_phase = is_prefill
        if (not is_prefill and self.decode_quant_bits > 0
                and self._decode_quantized is None and self.seq_len > 0):
            self._decode_quantized = QuantizedKVEntry.create(
                self.keys, self.values, self.decode_quant_bits)

    def get_current_quant_bits(self) -> int:
        return (self.prefill_quant_bits if self.is_prefill_phase
                else self.decode_quant_bits)

    def set_decode_bits(self, bits: int) -> None:
        """Progressive-precision hook: changing the decode
        bit-width drops the decode copy; it is rebuilt lazily at the new width."""
        if bits != self.decode_quant_bits:
            self.decode_quant_bits = bits
            self._decode_quantized = None

    # -- access ------------------------------------------

    def _active(self) -> Optional[QuantizedKVEntry]:
        # BOTH phase copies rebuild lazily: a decode-phase update() clears
        # the prefill copy, and without the lazy rebuild here a transition
        # back to prefill silently served full-precision K/V (and
        # get_quantized() returned None) for the rest of the serve
        if self.is_prefill_phase:
            if self._prefill_quantized is None and self.prefill_quant_bits > 0 \
                    and self.seq_len > 0:
                self._prefill_quantized = QuantizedKVEntry.create(
                    self.keys, self.values, self.prefill_quant_bits)
            return self._prefill_quantized
        if self._decode_quantized is None and self.decode_quant_bits > 0 \
                and self.seq_len > 0:
            self._decode_quantized = QuantizedKVEntry.create(
                self.keys, self.values, self.decode_quant_bits)
        return self._decode_quantized

    def get_keys(self) -> torch.Tensor:
        q = self._active()
        return q.dequantize_keys() if q is not None else self.keys

    def get_values(self) -> torch.Tensor:
        q = self._active()
        return q.dequantize_values() if q is not None else self.values

    def get_quantized(self) -> Optional[QuantizedKVEntry]:
        """Packed K/V for kernels that consume quantized pages directly."""
        return self._active()

    # -- update ------------------------------------------

    def update(self, new_keys: torch.Tensor, new_values: torch.Tensor) -> None:
        self.keys = new_keys
        self.values = new_values
        self.seq_len = int(new_keys.shape[2]) if new_keys.ndim >= 3 else 0
        # re-quantize only the active phase copy; the other rebuilds lazily
        # on transition
        if self.is_prefill_phase:
            self._prefill_quantized = (
                QuantizedKVEntry.create(new_keys, new_values, self.prefill_quant_bits)
                if self.prefill_quant_bits > 0 and self.seq_len > 0 else None)
            self._decode_quantized = None
        else:
            self._decode_quantized = (
                QuantizedKVEntry.create(new_keys, new_values, self.decode_quant_bits)
                if self.decode_quant_bits > 0 and self.seq_len > 0 else None)
            self._prefill_quantized = None

    # -- accounting --------------------------------------

    def memory_usage(self) -> int:
        total = 0
        if self._prefill_quantized is not None:
            total += self._prefill_quantized.memory_usage()
        if self._decode_quantized is not None:
            total += self._decode_quantized.memory_usage()
        if total == 0:
            total = (math.prod(self.keys.shape) +
                     math.prod(self.values.shape)) * 4
        return total

    def __len__(self) -> int:
        return self.seq_len

    def is_empty(self) -> bool:
        return self.seq_len == 0


class KVCacheManager:
    """Keyed cache map with a byte budget.

    Eviction frees entries largest-first until the deficit is covered.
    """

    def __init__(self, max_cache_size: int = 2 * 1024 ** 3,
                 prefill_bits: int = 8, decode_bits: int = 4, device="cuda"):
        self.device = torch.device(device)
        self.max_cache_size = max_cache_size
        self.prefill_bits = prefill_bits
        self.decode_bits = decode_bits
        self._entries: Dict[str, KVCacheEntry] = {}
        self._memory_usage = 0

    def get_or_init(self, cache_id: str, num_layers: int, batch: int,
                    num_heads: int, head_dim: int) -> KVCacheEntry:
        if cache_id in self._entries:
            return self._entries[cache_id]
        shape = (num_layers, batch, 0, num_heads, head_dim)
        entry = KVCacheEntry(torch.zeros(shape, device=self.device),
                             torch.zeros(shape, device=self.device),
                             self.prefill_bits, self.decode_bits)
        self._entries[cache_id] = entry
        return entry

    def get(self, cache_id: str) -> Optional[KVCacheEntry]:
        return self._entries.get(cache_id)

    def update(self, cache_id: str, keys: torch.Tensor,
               values: torch.Tensor) -> None:
        entry = self._entries.get(cache_id)
        old = entry.memory_usage() if entry is not None else 0
        entry_size = math.prod(keys.shape) * 4 * 2  # fp32 upper bound
        # credit the entry's current bytes in the projection and NEVER clamp
        # the delta: a shrinking entry (e.g. decode-phase re-quantization at
        # fewer bits) must decrease the accounting, or _memory_usage drifts
        # monotonically upward and evict() fires on phantom pressure
        projected = self._memory_usage - old + entry_size
        if projected > self.max_cache_size:
            self.evict(projected - self.max_cache_size)
            entry = self._entries.get(cache_id)  # eviction may have taken it
            old = entry.memory_usage() if entry is not None else 0
        if entry is not None:
            entry.update(keys, values)
            self._memory_usage += entry.memory_usage() - old
        else:
            entry = KVCacheEntry(keys, values, self.prefill_bits,
                                 self.decode_bits)
            self._entries[cache_id] = entry
            self._memory_usage += entry.memory_usage()
        self._memory_usage = max(self._memory_usage, 0)

    def evict(self, bytes_to_free: int) -> int:
        by_size = sorted(((k, e.memory_usage()) for k, e in self._entries.items()),
                         key=lambda kv: -kv[1])
        freed = 0
        for key, size in by_size:
            if freed >= bytes_to_free:
                break
            del self._entries[key]
            freed += size
        self._memory_usage = max(self._memory_usage - freed, 0)
        return freed

    def clear(self) -> None:
        self._entries.clear()
        self._memory_usage = 0

    def memory_usage(self) -> int:
        return self._memory_usage

    def __len__(self) -> int:
        return len(self._entries)
