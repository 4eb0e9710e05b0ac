"""IO-dedup engine: content-hash-deduplicated, page-addressed vector store.

Counterpart of `diffusion_llm_rs_tpu/storage/dedup.py` (host code, copied):
`content_hash` (64-bit FNV-1a), `IORequest`, `ReadAmplificationMonitor`,
`IOMerger` and `IODedupEngine`, with the same file format and hash, so a
store written by either package reads back in the other. Vectors group by
bit width, duplicates alias the location of the first copy, the rest are
merged into batches, appended and fsync'd; reads are page-aligned and
counted by the monitor. The byte-level paths run in the C++ runtime through
`storage.native` when it builds, else in Python.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffusion_llm_rs_tpu_torch.router.router import SSDLocation
from diffusion_llm_rs_tpu_torch.storage import native

PAGE_SIZE = 4096


def content_hash(data: bytes) -> int:
    """64-bit FNV-1a (the reference uses a weaker 31-multiplier fold,
    `io-dedup/src/lib.rs:161-166`; FNV-1a has the same cost and far better
    dispersion). Dispatches to the C++ runtime when available."""
    return native.fnv1a64(data)


@dataclasses.dataclass
class IORequest:
    """`io-dedup/src/lib.rs:55-60`."""

    id: str
    offset: int
    length: int
    data: bytes


class ReadAmplificationMonitor:
    """`io-dedup/src/lib.rs:62-66` — actually updated here."""

    def __init__(self):
        self.reads_requested = 0
        self.bytes_requested = 0
        self.reads_performed = 0
        self.bytes_read = 0

    @property
    def amplification_ratio(self) -> float:
        if self.bytes_requested == 0:
            return 1.0
        return self.bytes_read / self.bytes_requested


class IOMerger:
    """Merge small writes into batches (`io-dedup/src/lib.rs:180-213`)."""

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size

    def merge_requests(self, chunks: Sequence[Tuple[str, bytes]]) -> List[IORequest]:
        merged: List[IORequest] = []
        batch: List[bytes] = []
        size = 0
        for _, data in chunks:
            batch.append(data)
            size += len(data)
            if len(batch) >= self.batch_size:
                merged.append(IORequest(id=f"batch_{len(merged)}", offset=0,
                                        length=size, data=b"".join(batch)))
                batch, size = [], 0
        if batch:
            merged.append(IORequest(id=f"batch_{len(merged)}", offset=0,
                                    length=size, data=b"".join(batch)))
        return merged


class IODedupEngine:
    """Deduplicated page-addressed vector store on a single backing file."""

    def __init__(self, path: Optional[str] = None,
                 enable_direct_io: bool = False, batch_size: int = 32,
                 dedup_buffer_size_mb: int = 256):
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                "diffusion_llm_rs_tpu_torch_dedup.bin")
        self.path = path
        self.enable_direct_io = enable_direct_io
        self.io_merger = IOMerger(batch_size)
        self.monitor = ReadAmplificationMonitor()
        self.seen_hashes: Dict[int, SSDLocation] = {}
        self.locations: Dict[str, SSDLocation] = {}  # vector id -> location
        self.dedup_buffer_capacity = dedup_buffer_size_mb * 1024 * 1024
        # starts at 0 while the store appends at the file's end: a store
        # opened on a non-empty file records wrong locations (carried over
        # from the JAX package; ROADMAP.md queue C)
        self._write_offset = 0
        self._dedup_hits = 0
        self._file = native.open_store(path, direct_io=enable_direct_io)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- write path (`io-dedup/src/lib.rs:119-177`) -------------------------

    def store_vectors(self, vectors: Sequence) -> int:
        """Group -> dedup -> merge -> sequential write + fsync.

        `vectors` follow the CompressedVector protocol (`.id`, `.data` bytes or
        uint8 array, `.bits`). Returns the number of unique vectors written.
        """
        groups = self.group_similar_vectors(vectors)
        written = 0
        for group in groups:
            unique, aliases = self.deduplicate(group)
            chunks = [(v.id, self._payload(v)) for v in unique]
            # record per-vector locations before batching
            off = self._write_offset
            for vid, data in chunks:
                loc = SSDLocation(page_id=off // PAGE_SIZE,
                                  offset=off % PAGE_SIZE, length=len(data))
                self.locations[vid] = loc
                self.seen_hashes[content_hash(data)] = loc
                off += len(data)
            # in-batch duplicates alias the canonical id's location
            for dup_id, canonical_id in aliases:
                self.locations[dup_id] = self.locations[canonical_id]
            merged = self.io_merger.merge_requests(chunks)
            for req in merged:
                native.append(self._file, req.data)
            self._write_offset = off
            written += len(unique)
        native.fsync(self._file)
        return written

    def group_similar_vectors(self, vectors: Sequence) -> List[List]:
        """Spatial-locality grouping (stub at `io-dedup/src/lib.rs:137-143`):
        bucket by bit-width so same-format pages are contiguous."""
        buckets: Dict[int, List] = {}
        for v in vectors:
            buckets.setdefault(getattr(v, "bits", 8), []).append(v)
        return [buckets[b] for b in sorted(buckets)]

    def deduplicate(self, vectors: Sequence) -> Tuple[List, List[Tuple[str, str]]]:
        """Content-hash dedup (`io-dedup/src/lib.rs:145-166`). Duplicate
        payloads alias the existing SSDLocation instead of being rewritten.

        Returns (unique_vectors, in_batch_aliases) where aliases are
        (duplicate_id, canonical_id) pairs whose locations resolve after the
        unique set is written.
        """
        unique = []
        aliases: List[Tuple[str, str]] = []
        batch_hashes: Dict[int, str] = {}
        for v in vectors:
            h = content_hash(self._payload(v))
            if h in self.seen_hashes:
                self._dedup_hits += 1
                self.locations[v.id] = self.seen_hashes[h]
            elif h in batch_hashes:
                self._dedup_hits += 1
                aliases.append((v.id, batch_hashes[h]))
            else:
                batch_hashes[h] = v.id
                unique.append(v)
        return unique, aliases

    def _payload(self, v) -> bytes:
        data = v.data
        if isinstance(data, (bytes, bytearray)):
            return bytes(data)
        return np.asarray(data, np.uint8).tobytes()

    # -- read path ----------------------------------------------------------

    def read_vector(self, vector_id: str) -> Optional[bytes]:
        loc = self.locations.get(vector_id)
        if loc is None:
            return None
        start = loc.page_id * PAGE_SIZE + loc.offset
        self.monitor.reads_requested += 1
        self.monitor.bytes_requested += loc.length
        # page-aligned read (what direct IO forces; tracked for amplification)
        aligned_start = (start // PAGE_SIZE) * PAGE_SIZE
        aligned_len = -(-(start + loc.length - aligned_start) // PAGE_SIZE) * PAGE_SIZE
        self.monitor.reads_performed += 1
        self.monitor.bytes_read += aligned_len
        blob = native.pread(self._file, aligned_start, aligned_len)
        rel = start - aligned_start
        return blob[rel: rel + loc.length]

    def read_vectors(self, vector_ids: Sequence[str]) -> List[Optional[bytes]]:
        return [self.read_vector(v) for v in vector_ids]

    # -- stats --------------------------------------------------------------

    @property
    def dedup_hits(self) -> int:
        return self._dedup_hits

    def stats(self) -> Dict[str, float]:
        return {
            "vectors": len(self.locations),
            "unique_bytes": self._write_offset,
            "dedup_hits": self._dedup_hits,
            "read_amplification": self.monitor.amplification_ratio,
        }

    def close(self) -> None:
        native.close_store(self._file)
