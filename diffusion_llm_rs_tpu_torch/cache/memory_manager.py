"""Tiered memory manager: device / host RAM / disk spill with byte budgets.

Counterpart of `diffusion_llm_rs_tpu/cache/memory_manager.py`: three tiers
("hbm" on the device as a torch tensor, "host" as a numpy array, "disk" as an
`.npy` file), LRU demotion under per-tier byte budgets, promotion on access.
The serving batcher's HBM budget spills idle page pools to the host tier
through it.

The device tier defaults to the card (`device="cuda"`); disk spills go to a
directory made on first use under the process's temporary directory unless
`spill_dir` names one.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch


class AlreadyAllocatedError(Exception):
    pass


class NotFoundError(KeyError):
    pass


@dataclass
class MemoryAllocation:
    key: str
    nbytes: int
    tier: str  # "hbm" | "host" | "disk"
    created: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)


class MemoryManager:
    """Tiered allocate/deallocate/get with byte budgets and LRU demotion."""

    TIERS = ("hbm", "host", "disk")

    def __init__(self, hbm_budget: int = 8 << 30, host_budget: int = 16 << 30,
                 spill_dir: Optional[str] = None, device="cuda"):
        self.budgets = {"hbm": hbm_budget, "host": host_budget,
                        "disk": float("inf")}
        self.spill_dir = spill_dir
        self.device = torch.device(device)
        self._store: Dict[str, object] = {}
        self._alloc: "OrderedDict[str, MemoryAllocation]" = OrderedDict()
        self._usage = {"hbm": 0, "host": 0, "disk": 0}

    # -- core API -------------------------------------------------------------

    def allocate(self, key: str, data, tier: str = "hbm") -> MemoryAllocation:
        """Store `data` (tensor, array or bytes) under `key`. Raises
        AlreadyAllocatedError on a duplicate key."""
        if key in self._alloc:
            raise AlreadyAllocatedError(key)
        return self._put(key, data, tier)

    def _put(self, key: str, data, tier: str) -> MemoryAllocation:
        if tier not in self.TIERS:
            raise ValueError(f"tier must be one of {self.TIERS}")
        arr = self._to_array(data)
        nbytes = arr.nbytes
        self._make_room(tier, nbytes)
        self._store[key] = self._place(key, arr, tier)
        alloc = MemoryAllocation(key=key, nbytes=nbytes, tier=tier)
        self._alloc[key] = alloc
        self._alloc.move_to_end(key)
        self._usage[tier] += nbytes
        return alloc

    def get(self, key: str, promote: bool = True):
        """Fetch: a numpy array from the host and disk tiers (a disk entry is
        promoted to the host unless `promote` is False), a tensor from the
        device tier."""
        if key not in self._alloc:
            raise NotFoundError(key)
        alloc = self._alloc[key]
        alloc.last_access = time.time()
        self._alloc.move_to_end(key)
        value = self._store[key]
        if alloc.tier == "disk":
            arr = np.load(value)
            if promote:
                self._move(key, "host")
                return self._store[key]
            return arr
        return value

    def deallocate(self, key: str) -> None:
        if key not in self._alloc:
            raise NotFoundError(key)
        alloc = self._alloc.pop(key)
        value = self._store.pop(key)
        self._usage[alloc.tier] -= alloc.nbytes
        if alloc.tier == "disk" and isinstance(value, str):
            try:
                os.remove(value)
            except OSError:
                pass

    def contains(self, key: str) -> bool:
        return key in self._alloc

    def usage(self, tier: Optional[str] = None) -> int:
        if tier:
            return self._usage[tier]
        return sum(v for k, v in self._usage.items() if k != "disk")

    def tier_of(self, key: str) -> str:
        return self._alloc[key].tier

    def keys(self):
        return list(self._alloc.keys())

    # -- tier mechanics -------------------------------------------------------

    def _to_array(self, data) -> np.ndarray:
        if isinstance(data, (bytes, bytearray)):
            return np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, torch.Tensor):
            # a copy: a CPU tensor's .numpy() would alias memory the owner
            # goes on writing (a page pool reuses its slots)
            return data.detach().to("cpu", copy=True).numpy()
        return np.asarray(data)

    def _place(self, key: str, arr: np.ndarray, tier: str):
        if tier == "hbm":
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if tier == "host":
            return arr
        if self.spill_dir is None:
            self.spill_dir = tempfile.mkdtemp(prefix="dlm_spill_")
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"{abs(hash(key)):x}.npy")
        np.save(path, arr)
        return path

    def _move(self, key: str, tier: str) -> None:
        alloc = self._alloc[key]
        if alloc.tier == tier:
            return
        value = self._store[key]
        arr = (np.load(value) if alloc.tier == "disk"
               else self._to_array(value))
        if alloc.tier == "disk" and isinstance(value, str):
            try:
                os.remove(value)
            except OSError:
                pass
        self._usage[alloc.tier] -= alloc.nbytes
        self._make_room(tier, alloc.nbytes, exclude=key)
        self._store[key] = self._place(key, arr, tier)
        alloc.tier = tier
        self._usage[tier] += alloc.nbytes

    def _make_room(self, tier: str, nbytes: int,
                   exclude: Optional[str] = None) -> None:
        """LRU-demote entries until `nbytes` fits in `tier`'s budget."""
        if tier == "disk":
            return
        next_tier = {"hbm": "host", "host": "disk"}[tier]
        while self._usage[tier] + nbytes > self.budgets[tier]:
            victim = next((k for k, a in self._alloc.items()
                           if a.tier == tier and k != exclude), None)
            if victim is None:
                raise MemoryError(
                    f"{tier} budget {self.budgets[tier]} cannot fit {nbytes}")
            self._move(victim, next_tier)
