"""KV bit-width bucketing of the phase-aware sampler.

Counterpart of the first part of `diffusion_llm_rs_tpu/models/sampler.py`
(`SUPPORTED`, `bucket_bits`, `bucket_bits_up`): fractional bit targets of the
progressive-precision schedule land on the supported power-of-two widths.
The serving routers use them. `plan_segments` and `phase_aware_sample` are
not ported yet.
"""

from __future__ import annotations

SUPPORTED = (8, 4, 2, 1)


def bucket_bits(target: float) -> int:
    """Round a fractional target bit-width down onto a supported width."""
    for b in SUPPORTED:
        if target >= b:
            return b
    return SUPPORTED[-1]


def bucket_bits_up(target: float) -> int:
    """Smallest supported width >= target: the floor of the decode schedule
    (a configured min_decode_bits of 3 floors the schedule at 4, not 2)."""
    for b in reversed(SUPPORTED):
        if b >= target:
            return b
    return SUPPORTED[0]
