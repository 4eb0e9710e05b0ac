"""Runtime sanitizers: a reentrancy guard and the slot state machine's
invariants for the serving scheduler, and a NaN guard.

Counterpart of `diffusion_llm_rs_tpu/utils/sanitize.py` (`SanitizerError`,
`ReentrancyGuard`, `sanitize_enabled`, `check_scheduler_invariants`,
`nan_guard`). The
batcher's host loop is single-threaded by design: the guard turns a second
thread entering `step()` into a loud error, and the invariants (t >= 0 iff a
slot is occupied, timesteps bounded by the request, pool buckets resident or
spilled but never both) are checked between steps when `sanitize` is on (or
`DLM_SANITIZE=1`). `nan_guard` is the counterpart of JAX's scoped
`jax_debug_nans`: within it, an operation whose floating-point output holds
a NaN raises.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class SanitizerError(AssertionError):
    """An invariant the serving scheduler must maintain was violated."""


class ReentrancyGuard:
    """Detects concurrent entry into a single-threaded host loop."""

    def __init__(self, name: str = "scheduler"):
        self._name = name
        self._lock = threading.Lock()
        self._holder: int | None = None

    @contextlib.contextmanager
    def __call__(self):
        me = threading.get_ident()
        if not self._lock.acquire(blocking=False):
            raise SanitizerError(
                f"concurrent {self._name} access: thread {me} entered while "
                f"thread {self._holder} is still stepping — the batcher's "
                f"host loop is single-threaded by design; drive it from one "
                f"thread (or shard requests across batchers)")
        self._holder = me
        try:
            yield
        finally:
            self._holder = None
            self._lock.release()


def sanitize_enabled() -> bool:
    return os.environ.get("DLM_SANITIZE", "0") == "1"


def check_scheduler_invariants(batcher) -> None:
    """Slot state machine invariants for `serving.ContinuousBatcher`."""
    t = np.asarray(batcher.t)
    for slot in range(batcher.num_slots):
        req = batcher.slot_request[slot]
        if (t[slot] >= 0) != (req is not None):
            raise SanitizerError(
                f"slot {slot}: t={t[slot]} but request={'set' if req else 'None'}"
                f" — occupancy and timestep disagree")
        if req is not None:
            if not (0 <= t[slot] < req.num_steps):
                raise SanitizerError(
                    f"slot {slot}: t={t[slot]} outside [0, {req.num_steps})")
            if req.seq_len > batcher.seq_len:
                raise SanitizerError(
                    f"slot {slot}: request seq_len {req.seq_len} exceeds "
                    f"slot capacity {batcher.seq_len}")
    # paged-specific: resident + spilled buckets partition the bucket set
    if hasattr(batcher, "buckets") and hasattr(batcher, "pools"):
        if batcher.attend_mode == "paged":
            resident = set(batcher.pools)
            spilled = set(batcher.spilled_buckets())
            if resident & spilled:
                raise SanitizerError(
                    f"buckets both resident and spilled: {resident & spilled}")
            if resident | spilled != set(batcher.buckets):
                raise SanitizerError(
                    f"bucket accounting lost track: resident {resident} + "
                    f"spilled {spilled} != {set(batcher.buckets)}")
        elif batcher.pools:
            raise SanitizerError(
                f"attend_mode={batcher.attend_mode!r} must hold no pools")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta" and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Scoped numeric sanitizer: any operation under this context whose
    floating-point output holds a NaN raises FloatingPointError; the mode is
    removed on exit. Each operation's output is checked on its device and
    the answer read back, so it syncs once per operation: use it around a
    suspect step, not in production loops."""
    with _NanCheck():
        yield
