"""The device trace of a traced run (`--trace 1`), read into intervals.

`torch.profiler` records the card's operations (kernels, copies, sets;
replayed graphs included) over the window; each becomes (name, start ns,
end ns) on the host's wall clock (`time.time_ns()`), the clock of the
window's bounds and of the harness's host spans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int]]     # (name, start ns, end ns), by start

    def within(self, t0: int, t1: int) -> List[Tuple[str, int, int]]:
        """The operations clipped to [t0, t1]."""
        return [(n, max(a, t0), min(b, t1)) for n, a, b in self.ops
                if b > t0 and a < t1]

    def busy(self, t0: int, t1: int) -> List[Tuple[int, int]]:
        """The union of the operations' intervals inside [t0, t1]."""
        merged: List[List[int]] = []
        for _, a, b in self.within(t0, t1):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def family_s(self, t0: int, t1: int, names) -> Optional[float]:
        """Device seconds of the operations whose name holds one of
        `names`; None where there is none."""
        hits = [b - a for n, a, b in self.within(t0, t1)
                if any(k in n for k in names)]
        return sum(hits) / 1e9 if hits else None


def _events(prof) -> List[Tuple[str, int, int]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            a, n = e.start_ns(), e.duration_ns()
        else:
            a, n = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), a, a + n))
    out.sort(key=lambda x: x[1])
    return out


class Recorder:
    """Starts the profiler just before a window opens and reads it just
    after the window closes; `trace` is None when tracing is off."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None
        self._prof = None

    def start(self) -> None:
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self.trace = Trace(_events(self._prof))
            self._prof = None
