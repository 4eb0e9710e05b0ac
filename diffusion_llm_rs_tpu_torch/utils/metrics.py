"""Metrics registry: process-wide counters and gauges with a `snapshot()`
export, and a tokens/s tracker.

A copy of `diffusion_llm_rs_tpu/utils/metrics.py` (which imports no JAX; the
port keeps its own copy so it imports nothing of the JAX package). The
serving batchers count `batcher.*` events here.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Lazily-evaluated gauge (e.g. cache bytes at snapshot time)."""
        with self._lock:
            self._gauge_fns[name] = fn

    def get(self, name: str) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            if name in self._gauges:
                return self._gauges[name]
        fn = self._gauge_fns.get(name)
        return float(fn()) if fn else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            fns = dict(self._gauge_fns)
        for name, fn in fns.items():
            try:
                out[name] = float(fn())
            except Exception:
                pass
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


metrics = MetricsRegistry()


class Throughput:
    """tokens/s tracker: `with Throughput(n_tokens) as tp: ...`."""

    def __init__(self, tokens: int, name: str = "tokens_per_sec",
                 registry: Optional[MetricsRegistry] = None):
        self.tokens = tokens
        self.name = name
        self.registry = registry or metrics
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.elapsed > 0:
            self.registry.set_gauge(self.name, self.tokens / self.elapsed)
        return False
