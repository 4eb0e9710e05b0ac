"""NS-Router: similarity-graph shard placement, rebalancing and store
metadata.

Counterpart of `diffusion_llm_rs_tpu/router/router.py` (numpy on the host,
copied): `SSDLocation`, `CompressionInfo`, `VectorMetadata`, `RoutingNode`
and `NSRouter`. Similarity edges are top-k cosine links, a new node goes to
the nearest shard centroid (round robin while no shard exists), and
`rebalance_shards` moves nodes from overloaded to underloaded shards. Adding
a node compares it with every node already there (`add_similarity_edges`),
so routing N vectors costs O(N^2) host time, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SSDLocation:
    """`ns-router-rs/src/lib.rs:51-57`."""

    page_id: int = 0
    offset: int = 0
    length: int = 0


@dataclasses.dataclass
class CompressionInfo:
    """`ns-router-rs/src/lib.rs:59-64`."""

    algorithm: str = "BitQuantization"
    ratio: float = 1.0
    bits: int = 8


@dataclasses.dataclass
class VectorMetadata:
    """`ns-router-rs/src/lib.rs:42-48`."""

    id: str
    ssd_location: SSDLocation
    compression_info: CompressionInfo
    access_count: int = 0


@dataclasses.dataclass
class RoutingNode:
    """`diffusion_prefill/src/router.rs:26-31`."""

    id: str
    embedding: np.ndarray
    shard_id: int
    metadata: Dict[str, str]


class NSRouter:
    """Shard router with a similarity navigation graph."""

    def __init__(self, num_shards: int = 4, edge_k: int = 4,
                 max_imbalance: float = 1.5):
        self.num_shards = num_shards
        self.edge_k = edge_k
        self.max_imbalance = max_imbalance
        self.nodes: Dict[str, RoutingNode] = {}
        self.edges: Dict[str, List[Tuple[str, float]]] = {}
        self.shard_map: Dict[int, str] = {}
        self.vector_metadata: Dict[str, VectorMetadata] = {}
        self._next_round_robin = 0

    # -- graph building (`router.rs:53-100`, `ns-router-rs:99-128`) ---------

    def update_routing(self, vectors: Sequence) -> None:
        """Add/update nodes for CompressedVectors, then rebalance.

        Accepts any objects with `.id`, `.data`, `.bits`, `.original_shape`
        (the CompressedVector protocol).
        """
        for v in vectors:
            self.add_or_update_node(v)
        self.rebalance_shards()

    def add_or_update_node(self, vector) -> RoutingNode:
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        emb = self._embedding_of(vector)
        if vector.id in self.nodes:
            node = self.nodes[vector.id]
            node.metadata["last_updated"] = now
            node.embedding = emb
            return node
        shard_id = self.find_shard(emb)
        if shard_id is None:
            shard_id = self._next_round_robin % self.num_shards
            self._next_round_robin += 1
        node = RoutingNode(id=vector.id, embedding=emb, shard_id=shard_id,
                           metadata={"last_updated": now})
        self.nodes[vector.id] = node
        self.shard_map.setdefault(shard_id, f"shard_{shard_id}")
        self.add_similarity_edges(vector.id)
        # SSD + compression metadata (`ns-router-rs/src/lib.rs:103-121`)
        n_elems = int(np.prod(vector.original_shape)) or 1
        data_len = int(np.asarray(vector.data).size)
        self.vector_metadata[vector.id] = VectorMetadata(
            id=vector.id,
            ssd_location=SSDLocation(page_id=0, offset=0, length=data_len),
            compression_info=CompressionInfo(
                ratio=n_elems * 4.0 / max(data_len, 1),
                bits=getattr(vector, "bits", 8)),
        )
        return node

    def _embedding_of(self, vector) -> np.ndarray:
        deq = getattr(vector, "dequantize", None)
        if callable(deq):
            return np.asarray(deq(), np.float32).ravel()
        return np.zeros((int(np.prod(vector.original_shape)) or 1,), np.float32)

    def add_similarity_edges(self, node_id: str) -> None:
        """Top-k cosine links (implements the stub at `router.rs:103-107`)."""
        node = self.nodes[node_id]
        sims: List[Tuple[str, float]] = []
        a = node.embedding
        na = np.linalg.norm(a)
        for other_id, other in self.nodes.items():
            if other_id == node_id or other.embedding.size != a.size:
                continue
            nb = np.linalg.norm(other.embedding)
            sim = float(a @ other.embedding / (na * nb)) if na > 0 and nb > 0 else 0.0
            sims.append((other_id, sim))
        sims.sort(key=lambda p: -p[1])
        self.edges[node_id] = sims[: self.edge_k]
        for other_id, sim in sims[: self.edge_k]:
            lst = self.edges.setdefault(other_id, [])
            if all(i != node_id for i, _ in lst):
                lst.append((node_id, sim))
                lst.sort(key=lambda p: -p[1])
                del lst[self.edge_k:]

    # -- shard logic (`router.rs:110-147`) ----------------------------------

    def shard_sizes(self) -> Dict[int, int]:
        sizes = {s: 0 for s in range(self.num_shards)}
        for node in self.nodes.values():
            sizes[node.shard_id] = sizes.get(node.shard_id, 0) + 1
        return sizes

    def shard_centroid(self, shard_id: int) -> Optional[np.ndarray]:
        embs = [n.embedding for n in self.nodes.values()
                if n.shard_id == shard_id]
        if not embs:
            return None
        return np.mean(np.stack(embs), axis=0)

    def rebalance_shards(self) -> int:
        """Move nodes from overloaded to underloaded shards (implements the
        stub at `router.rs:110-117`). Returns the number of moves."""
        sizes = self.shard_sizes()
        n = len(self.nodes)
        if n == 0 or self.num_shards <= 1:
            return 0
        target = n / self.num_shards
        moves = 0
        over = [s for s, c in sizes.items() if c > target * self.max_imbalance]
        under = sorted((s for s, c in sizes.items() if c < target),
                       key=lambda s: sizes[s])
        for src in over:
            members = [nid for nid, node in self.nodes.items()
                       if node.shard_id == src]
            while sizes[src] > target * self.max_imbalance and under and members:
                dst = under[0]
                nid = members.pop()
                self.nodes[nid].shard_id = dst
                self.shard_map.setdefault(dst, f"shard_{dst}")
                sizes[src] -= 1
                sizes[dst] += 1
                moves += 1
                if sizes[dst] >= target:
                    under.pop(0)
        return moves

    def find_shard(self, embedding) -> Optional[int]:
        """Nearest shard centroid (`router.rs:120-126`); None when empty."""
        if not self.shard_map:
            return None
        q = np.asarray(embedding, np.float32).ravel()
        best, best_d = None, float("inf")
        for shard_id in self.shard_map:
            c = self.shard_centroid(shard_id)
            if c is None or c.size != q.size:
                continue
            d = float(((c - q) ** 2).sum())
            if d < best_d:
                best, best_d = shard_id, d
        if best is None:
            best = next(iter(self.shard_map))
        return best

    def route_query(self, query, k: int) -> List[Tuple[str, float]]:
        """Rank shards by centroid similarity (`router.rs:129-139`)."""
        if not self.shard_map:
            return []
        q = np.asarray(query, np.float32).ravel()
        qn = np.linalg.norm(q)
        scored = []
        for shard_id in self.shard_map:
            c = self.shard_centroid(shard_id)
            if c is None or c.size != q.size or qn == 0:
                score = 1.0
            else:
                cn = np.linalg.norm(c)
                score = float(q @ c / (qn * cn)) if cn > 0 else 0.0
            scored.append((str(shard_id), score))
        scored.sort(key=lambda p: -p[1])
        return scored[:k]

    def get_shard_for_vector(self, vector_id: str) -> Optional[int]:
        node = self.nodes.get(vector_id)
        return node.shard_id if node else None
