"""Salience-driven per-page bit allocation under an average-bits budget.

Counterpart of the part of `diffusion_llm_rs_tpu/cache/salience.py` that
serving calls: `allocate_bits` (numpy, copied verbatim) and
`allocate_bits_torch`, the twin of `allocate_bits_jnp` batched over slots,
which the fused serving chunk runs on the device. Both are the same greedy
with the same f32 budget arithmetic and the same visiting order (stable
descending sort, invalid pages last), so their assignments are identical.
`SalienceEngine` and the scorers above it are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def allocate_bits(scores, budget_bits: float,
                  bit_options: Sequence[int] = (8, 4, 2, 1)) -> np.ndarray:
    scores = np.asarray(scores, np.float32).ravel()
    opts = sorted(set(int(b) for b in bit_options))  # ascending
    n = scores.size
    if n == 0:
        return np.zeros((0,), np.int32)
    bits = np.full(n, opts[0], np.int32)
    # visit blocks most-salient first; give each the highest width the
    # remaining budget affords (later blocks keep at least the floor width).
    # f32 accumulator: bit-for-bit the same arithmetic as the on-device twin
    # `allocate_bits_torch`, so the fused serving chunk routes identically.
    extra = np.float32(np.float32(budget_bits) * n) - np.float32(bits.sum())
    for i in np.argsort(-scores, kind="stable"):
        for level in reversed(opts):
            delta = np.float32(level - bits[i])
            if delta <= extra:
                bits[i] = level
                extra = np.float32(extra - delta)
                break
    return bits


def allocate_bits_torch(scores: torch.Tensor, budget_bits: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        bit_options: Sequence[int] = (8, 4, 2, 1)
                        ) -> torch.Tensor:
    """`allocate_bits` for every row at once, on the scores' device.

    `scores` [B, n] f32; `budget_bits` [B] f32; `valid` optional [B, n]
    bool: invalid blocks sort last, cost nothing and keep the floor width,
    as the host path's slicing to the active page count does. Returns int32
    [B, n]."""
    opts = tuple(sorted(set(int(b) for b in bit_options)))
    B, n = scores.shape
    dev = scores.device
    scores = scores.to(torch.float32)
    if valid is None:
        valid = torch.ones((B, n), dtype=torch.bool, device=dev)
    n_valid = valid.to(torch.int32).sum(dim=1)
    order = torch.argsort(
        torch.where(valid, -scores, torch.full_like(scores, float("inf"))),
        dim=1, stable=True)
    floor = opts[0]
    extra = (budget_bits.to(torch.float32) * n_valid.to(torch.float32)
             - (floor * n_valid).to(torch.float32))
    out = torch.full((B, n), floor, dtype=torch.int32, device=dev)
    for k in range(n):
        idx = order[:, k:k + 1]                            # [B, 1]
        done = ~valid.gather(1, idx)[:, 0]
        level = torch.full((B,), floor, dtype=torch.int32, device=dev)
        taken = torch.zeros((B,), dtype=torch.float32, device=dev)
        for lv in reversed(opts):  # highest affordable width wins
            delta = float(lv - floor)
            afford = ~done & (extra >= delta)
            level = torch.where(afford, lv, level)
            taken = torch.where(afford, delta, taken)
            done = done | afford
        extra = extra - taken
        out.scatter_(1, idx, level[:, None])
    return out
