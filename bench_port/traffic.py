"""The one generator of requests, driven by a traffic file's parameters.

A traffic file (`traffic/<mix>.json`) names its loop (`backlog`, `open` or
`sampler`), the server's shape (`slots`, `seq_len`, `page_size`, ...) and
the request mix: `request_len` [lo, hi, multiple], `num_steps` with their
`num_steps_weights`, and for an open loop `rate_per_s`.

Each request draws its length uniformly from the multiples in [lo, hi] and
its step count by the weights; an open loop's arrivals are a Poisson
process at `rate_per_s`, independent exponential gaps. Every draw is
independent, from a stream named by its label (`"warm"`, `"measured"`)
and not by the run's seed: every run of a cell serves one realization of
the mix, so runs with different seeds do the same work, and the seed
varies the weights, the noise and the requests the check reads.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from bench_port.seeds import mix


@dataclasses.dataclass(frozen=True)
class Shape:
    seq_len: int
    num_steps: int


def _rng(*labels) -> np.random.Generator:
    return np.random.default_rng(mix(0, "traffic", *labels))


def requests(traffic: dict, stream: str) -> Iterator[Shape]:
    """Endless requests of the mix."""
    rng = _rng(stream, "requests")
    lo, hi, mult = traffic["request_len"]
    steps = traffic["num_steps"]
    w = np.asarray(traffic["num_steps_weights"], dtype=np.float64)
    while True:
        yield Shape(int(rng.integers(lo // mult, hi // mult + 1)) * mult,
                    int(steps[rng.choice(len(steps), p=w / w.sum())]))


def gaps(traffic: dict, stream: str) -> Iterator[float]:
    """Endless seconds between arrivals of a Poisson process at
    `rate_per_s`."""
    rng = _rng(stream, "gaps")
    while True:
        yield float(rng.exponential(1.0 / traffic["rate_per_s"]))


def arrivals(traffic: dict, stream: str, start: float,
             end: float) -> List[Tuple[float, Shape]]:
    """(due time, shape) of every request due in [start, end)."""
    out = []
    due = start
    shapes = requests(traffic, stream)
    for gap in gaps(traffic, stream):
        due += gap
        if due >= end:
            return out
        out.append((due, next(shapes)))
    return out
