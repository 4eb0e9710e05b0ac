"""Calibration: streaming min/max, histogram, per-channel stats, quantile sketch.

Counterpart of `diffusion_llm_rs_tpu/quant/calibrate.py`, with its values:
  - `CalibrationData`: global min/max, a histogram of 2048 bins re-binned
    against the running range at each update (earlier batches keep their
    bins), optional per-channel (min, max).
  - `compute_params`: the scale's range is widened to include zero, so zero
    is exactly representable; the asymmetric zero point is
    round_half_away(-min / scale). 8-bit asymmetric over [1..6] gives
    scale = 6/255 and zero_point = -43 (DESIGN.md, "Behavior defined
    fresh" #1).
  - `QuantileSketch`: a sorted rank-uniform summary of at most 4 *
    ceil(1 / (2 eps)) values, exact at q = 0 and 1.
  - `AdaptiveQuantizer`: (scale, zero point) from the sketch's [q, 1 - q]
    range, and the quantization they define.

Host-side statistics: reductions run in torch on the data's device, the
small streaming state is numpy on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.quant.core import true_div


def _round_half_away(x: float) -> int:
    """Rust's f32::round: half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _f32(data) -> torch.Tensor:
    return torch.as_tensor(data, dtype=torch.float32)


@dataclasses.dataclass
class QuantizationParams:
    """Computed calibration parameters."""

    bits: int
    scale: float
    zero_point: int
    symmetric: bool
    axis: Optional[int] = None


class CalibrationData:
    """Streaming calibration collector (min/max + histogram + per-channel)."""

    def __init__(self, num_bins: int = 2048, per_channel: bool = False):
        self.num_bins = num_bins
        self.min = float("inf")
        self.max = float("-inf")
        self.histogram = np.zeros(num_bins, dtype=np.int64)
        self.total_samples = 0
        self.per_channel_stats: Optional[Dict[int, Tuple[float, float]]] = (
            {} if per_channel else None)

    def update(self, data, channel: Optional[int] = None) -> None:
        arr = _f32(data)
        mn = float(arr.min())
        mx = float(arr.max())
        self.min = min(self.min, mn)
        self.max = max(self.max, mx)
        self.total_samples += int(arr.numel())

        if channel is not None and self.per_channel_stats is not None:
            old = self.per_channel_stats.get(channel,
                                             (float("inf"), float("-inf")))
            self.per_channel_stats[channel] = (min(old[0], mn), max(old[1], mx))

        if self.max > self.min:
            hist, _ = np.histogram(arr.cpu().numpy().ravel(),
                                   bins=self.num_bins,
                                   range=(self.min, self.max))
            self.histogram += hist

    def compute_params(self, bits: int, symmetric: bool) -> QuantizationParams:
        """Quantization parameters from the observed range (see the module
        docstring)."""
        if self.total_samples == 0:
            raise ValueError("calibration requires at least one update()")
        num_levels = float(1 << bits)

        rng_lo = min(self.min, 0.0)
        rng_hi = max(self.max, 0.0)
        if (rng_hi - rng_lo) <= np.finfo(np.float32).eps:
            return QuantizationParams(bits=bits, scale=1.0, zero_point=0,
                                      symmetric=symmetric)

        if symmetric:
            max_abs = max(abs(self.max), abs(self.min))
            scale = max_abs * 2.0 / (num_levels - 1.0)
            zero_point = int(num_levels / 2.0 - 1.0)
        else:
            scale = (rng_hi - rng_lo) / (num_levels - 1.0)
            zero_point = _round_half_away(-self.min / scale)

        return QuantizationParams(bits=bits, scale=float(scale),
                                  zero_point=zero_point, symmetric=symmetric)

    def get_per_channel_stats(self):
        return self.per_channel_stats


class QuantileSketch:
    """Mergeable streaming quantile estimate with rank error <= eps; 0.0 and
    1.0 are exact."""

    def __init__(self, eps: float = 0.01):
        self.eps = eps
        self._k = max(int(math.ceil(1.0 / (2.0 * eps))), 2)
        self._summary: Optional[np.ndarray] = None  # sorted rank-uniform sample
        self.count = 0
        self._exact_min = float("inf")
        self._exact_max = float("-inf")

    def insert(self, data) -> None:
        arr = _f32(data).cpu().numpy().ravel()
        if arr.size == 0:
            return
        self.count += int(arr.size)
        self._exact_min = min(self._exact_min, float(arr.min()))
        self._exact_max = max(self._exact_max, float(arr.max()))
        merged = np.sort(arr if self._summary is None
                         else np.concatenate([self._summary, arr]))
        if merged.size > 4 * self._k:
            idx = np.linspace(0, merged.size - 1,
                              4 * self._k).round().astype(int)
            merged = merged[idx]
        self._summary = merged

    def query(self, q: float) -> float:
        if self._summary is None:
            raise ValueError("sketch is empty")
        if q <= 0.0:
            return self._exact_min
        if q >= 1.0:
            return self._exact_max
        idx = int(round(q * (self._summary.size - 1)))
        return float(self._summary[idx])


class AdaptiveQuantizer:
    """Quantizer whose range follows a streaming quantile sketch, optionally
    clipped to inner quantiles to shed outliers."""

    def __init__(self, bits: int, target_ratio: float = 4.0, eps: float = 0.01,
                 clip_quantile: float = 0.0):
        self.bits = bits
        self.target_ratio = target_ratio
        self.clip_quantile = clip_quantile
        self.stats = QuantileSketch(eps=eps)

    def update_stats(self, data) -> None:
        self.stats.insert(data)

    def compute_params(self) -> Tuple[float, float]:
        try:
            lo = self.stats.query(self.clip_quantile)
            hi = self.stats.query(1.0 - self.clip_quantile)
        except ValueError:
            lo, hi = 0.0, 1.0  # the defaults of an empty sketch
        q_max = float((1 << self.bits) - 1)
        scale = (hi - lo) / q_max
        if scale == 0.0:
            scale = 1.0
        zero_point = float(np.clip(_round_half_away(-lo / scale), 0.0, q_max))
        return scale, zero_point

    def quantize(self, data) -> Tuple[torch.Tensor, float, float]:
        """(uint8 levels clamp(round(x / scale) + zero_point, 0, qmax),
        scale, zero_point); x / scale is the f32 division JAX makes."""
        scale, zero_point = self.compute_params()
        q_max = float((1 << self.bits) - 1)
        x = _f32(data)
        q = torch.clamp(torch.round(true_div(x, scale)) + zero_point, 0.0,
                        q_max).to(torch.uint8)
        return q, scale, zero_point
