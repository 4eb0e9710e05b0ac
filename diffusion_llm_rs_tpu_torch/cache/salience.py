"""Salience engine: access-pattern scoring, cache decisions and per-page
bit allocation under an average-bits budget.

Counterpart of `diffusion_llm_rs_tpu/cache/salience.py`: `AccessPattern`,
`ImportanceScorer`, `CacheOptimizer`, `PrefillPredictor` and
`SalienceEngine` (host Python, copied; the methods that read the clock also
take an explicit `now`), `allocate_bits` (numpy, copied verbatim) and
`allocate_bits_torch`, the twin of `allocate_bits_jnp` batched over slots,
which the fused serving chunk runs on the device. The two allocators are the
same greedy with the same f32 budget arithmetic and the same visiting order
(stable descending sort, invalid pages last), so their assignments are
identical.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AccessPattern:
    """How often and how recently a vector was accessed."""

    frequency: int = 0
    recency: float = 0.0  # unix timestamp of last access
    importance_score: float = 0.0


class ImportanceScorer:
    """Access-pattern scorer: frequency times an exponential decay of the
    time since the last access (half-life `half_life_s`)."""

    def __init__(self, half_life_s: float = 300.0):
        self.half_life_s = half_life_s
        self.access_patterns: Dict[str, AccessPattern] = {}
        self.weights: Dict[str, float] = {}

    def update(self, vector_id: str, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        pat = self.access_patterns.setdefault(vector_id, AccessPattern())
        pat.frequency += 1
        pat.recency = now
        pat.importance_score = self.score(vector_id, now)

    def score(self, vector_id: str, now: Optional[float] = None) -> float:
        pat = self.access_patterns.get(vector_id)
        if pat is None:
            return 0.0
        now = time.time() if now is None else now
        age = max(now - pat.recency, 0.0)
        decay = 0.5 ** (age / self.half_life_s)
        return float(pat.frequency) * decay


class CacheOptimizer:
    """Eviction-order selection: the `cache_size` most salient ids."""

    def __init__(self, cache_size: int, eviction_policy: str = "salience"):
        self.cache_size = cache_size
        self.eviction_policy = eviction_policy

    def optimize(self, ids: Sequence[str], scorer: ImportanceScorer,
                 now: Optional[float] = None) -> List[str]:
        ranked = sorted(ids, key=lambda i: -scorer.score(i, now))
        return ranked[: self.cache_size]


class PrefillPredictor:
    """Linear reuse-probability predictor over (frequency, importance)."""

    def __init__(self, feature_dim: int = 2):
        self.weights = np.zeros((feature_dim,), np.float32)
        self.bias = 0.0
        self.accuracy = 0.0

    def predict(self, pattern: Optional[AccessPattern]) -> float:
        if pattern is None:
            return 0.0
        feats = np.array([pattern.frequency,
                          pattern.importance_score], np.float32)
        return float(feats[: self.weights.size] @ self.weights + self.bias)


class SalienceEngine:
    """The scorer, the eviction order and the predictor behind one facade,
    plus a word-frequency scorer over prompts with a bounded cache. The
    methods that read the clock take an optional `now` (seconds since the
    epoch; default `time.time()`)."""

    def __init__(self, cache_size: int = 1 << 20, half_life_s: float = 300.0):
        self.scorer = ImportanceScorer(half_life_s=half_life_s)
        self.cache_optimizer = CacheOptimizer(cache_size)
        self.prefill_predictor = PrefillPredictor()
        self.cache_size = cache_size
        self._word_cache: "OrderedDict[str, float]" = OrderedDict()

    # -- vector-id interface (standalone variant) ---------------------------

    def update(self, vector_id: str, now: Optional[float] = None) -> None:
        self.scorer.update(vector_id, now)

    def optimize(self, ids: Sequence[str],
                 now: Optional[float] = None) -> List[str]:
        return self.cache_optimizer.optimize(ids, self.scorer, now)

    def predict(self, vector_id: str) -> float:
        return self.prefill_predictor.predict(
            self.scorer.access_patterns.get(vector_id))

    def score(self, vector_id: str, now: Optional[float] = None) -> float:
        """0.7 * base + 0.3 * predicted."""
        return (0.7 * self.scorer.score(vector_id, now)
                + 0.3 * self.predict(vector_id))

    # -- text interface -----------------------------------------------------

    def calculate(self, text: str) -> Dict[str, float]:
        """Word-frequency salience with a bounded FIFO cache."""
        scores: Dict[str, float] = {}
        for word in text.split():
            w = word.lower()
            scores[w] = scores.get(w, 0.0) + 1.0
        for word, score in scores.items():
            self._word_cache[word] = score
            self._word_cache.move_to_end(word)
            while len(self._word_cache) > self.cache_size:
                self._word_cache.popitem(last=False)
        return scores

    def get_cached_score(self, word: str) -> Optional[float]:
        return self._word_cache.get(word.lower())

    # -- salience-driven per-block bit allocation --------------------------

    def allocate_bits(
        self,
        scores: np.ndarray,
        budget_bits: float,
        bit_options: Sequence[int] = (8, 4, 2, 1),
    ) -> np.ndarray:
        """Assign a bit-width per block so mean(bits) <= budget_bits, giving
        the most salient blocks the highest precision.

        Greedy: start everything at the lowest width, then upgrade blocks in
        descending-salience order while the budget allows.
        """
        return allocate_bits(scores, budget_bits, bit_options)


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
