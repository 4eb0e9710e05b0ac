"""Fusion-ANNS: a quantized-vector similarity index (IVF + batched scans).

Counterpart of `diffusion_llm_rs_tpu/index/anns.py`: `CompressedVector`,
`compress_rows`, `FusionANNS` and `cosine_similarity`.

The indexed vectors live on `device` (the card unless the caller asks for
the CPU) as one quantized matrix, a scale and zero point a row, with their
norms beside it; a query dequantizes the candidate rows and scores them in
one batched product there. The IVF coarse centroids (k-means) and the
inverted lists stay in host numpy, as in the JAX package, and so do the
`CompressedVector`s, whose bytes go to the dedup store and the router.

Two places where the port takes care to give JAX's answers:
  - the top k are taken from a stable descending sort, so among equal
    similarities the lower row comes first, as `jax.lax.top_k` orders them
    (`torch.topk` on CUDA promises no order among ties, and a repeated word
    gives identical rows);
  - `compress_rows` quantizes all rows of one bit width in one per-row
    call and copies them to the host once, where JAX quantizes a row at a
    time; each row's bytes, scale and zero point are those of JAX's per-row
    `quantize`, bit for bit (the same elementwise operations on the same
    values).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor, dequantize,
                                                   quantize)


@dataclasses.dataclass
class CompressedVector:
    """One quantized row, on the host: the type the store, the router and
    the index exchange."""

    id: str
    data: np.ndarray          # packed uint8
    bits: int
    original_shape: Tuple[int, ...]
    quant_scale: float
    quant_zero_point: float   # float zp: (q - zp) * scale

    def to_quantized_tensor(self, device="cpu") -> QuantizedTensor:
        return QuantizedTensor(
            data=torch.from_numpy(np.array(self.data, np.uint8)).to(device),
            scale=torch.tensor(self.quant_scale, dtype=torch.float32,
                               device=device),
            zero_point=torch.tensor(self.quant_zero_point,
                                    dtype=torch.float32, device=device),
            bits=self.bits, shape=tuple(self.original_shape))

    def dequantize(self) -> np.ndarray:
        return dequantize(self.to_quantized_tensor()).numpy()


def compress_rows(vectors, bits_cycle: Sequence[int],
                  ids: Optional[Sequence[str]] = None,
                  device="cuda") -> List[CompressedVector]:
    """Quantize row i of `vectors` [N, D] at bits_cycle[i % len(bits_cycle)]
    (a scale and zero point a row), on `device`; one quantize call and one
    copy to the host a bit width."""
    if isinstance(vectors, torch.Tensor):
        arr = vectors.to(device=device, dtype=torch.float32)
    else:
        arr = torch.from_numpy(np.asarray(vectors, np.float32)).to(device)
    widths = [int(bits_cycle[i % len(bits_cycle)])
              for i in range(arr.shape[0])]
    out: List[Optional[CompressedVector]] = [None] * len(widths)
    for bits in sorted(set(widths)):
        rows = [i for i, b in enumerate(widths) if b == bits]
        sel = torch.tensor(rows, dtype=torch.int64, device=arr.device)
        qt = quantize(arr.index_select(0, sel), bits, granularity="channel",
                      axis=0)
        data = qt.data.cpu().numpy()
        scale = qt.scale.cpu().numpy().reshape(-1)
        zp = qt.zero_point.cpu().numpy().reshape(-1)
        for j, i in enumerate(rows):
            out[i] = CompressedVector(
                id=ids[i] if ids is not None else str(i),
                data=data[j].copy(), bits=bits,
                original_shape=(int(arr.shape[1]),),
                quant_scale=float(scale[j]),
                quant_zero_point=float(zp[j]))
    return out


def _kmeans(x: np.ndarray, k: int, iters: int = 10,
            seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = min(k, x.shape[0])
    centroids = x[rng.choice(x.shape[0], size=k, replace=False)].copy()
    for _ in range(iters):
        d = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            m = assign == j
            if m.any():
                centroids[j] = x[m].mean(0)
    return centroids


class FusionANNS:
    """IVF index over quantized vectors with batched scans on the device."""

    def __init__(self, embedding_dim: int, num_centroids: int = 16,
                 nprobe: int = 4, storage_bits: int = 8, device="cuda"):
        self.embedding_dim = embedding_dim
        self.num_centroids = num_centroids
        self.nprobe = nprobe
        self.storage_bits = storage_bits
        self.device = torch.device(device)
        self._ids: List[str] = []
        self._id_to_row: Dict[str, int] = {}
        self._matrix: Optional[QuantizedTensor] = None  # [N, D] on device
        self._norms: Optional[torch.Tensor] = None      # [N] on device
        self.centroids: Optional[np.ndarray] = None     # [C, D] host
        self.inverted_lists: Dict[int, List[int]] = {}

    def __len__(self) -> int:
        return len(self._ids)

    # -- indexing -----------------------------------------------------------

    def index_vectors(self, ids: Sequence[str], vectors) -> None:
        """Add vectors (float [N, D]); stored quantized at storage_bits. The
        held matrix is dequantized, extended and quantized again, as JAX
        does."""
        arr = np.asarray(vectors, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.embedding_dim:
            raise ValueError(f"expected [N, {self.embedding_dim}], got {arr.shape}")
        existing = (dequantize(self._matrix) if self._matrix is not None else
                    torch.zeros((0, self.embedding_dim), dtype=torch.float32,
                                device=self.device))
        full = torch.cat([existing, torch.from_numpy(arr).to(self.device)], 0)
        for vid in ids:
            if vid in self._id_to_row:
                raise ValueError(f"duplicate vector id {vid!r}")
            self._id_to_row[vid] = len(self._ids)
            self._ids.append(vid)
        # per-channel (per-row) quantization: one scale per vector
        self._matrix = quantize(full, self.storage_bits,
                                granularity="channel", axis=0)
        self._norms = torch.linalg.norm(dequantize(self._matrix), dim=1)
        # (re)build the IVF structure on the host
        full_np = full.cpu().numpy()
        self.centroids = _kmeans(full_np, self.num_centroids)
        d = ((full_np[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        self.inverted_lists = {}
        for row, c in enumerate(assign):
            self.inverted_lists.setdefault(int(c), []).append(row)

    def index_compressed(self, vectors: Sequence[CompressedVector]) -> None:
        """Index pre-compressed vectors."""
        if not vectors:
            return
        arr = np.stack([v.dequantize() for v in vectors])
        self.index_vectors([v.id for v in vectors], arr)

    # -- query --------------------------------------------------------------

    def query(self, query_vector, k: int,
              metric: str = "cosine") -> List[Tuple[str, float]]:
        """Top-k neighbours as (id, similarity), ties in row order. Empty
        index -> []."""
        if self._matrix is None or not self._ids:
            return []
        q_np = np.asarray(query_vector, np.float32)
        cand = self._candidate_rows(q_np)
        q = torch.from_numpy(q_np).to(self.device)
        rows = torch.from_numpy(cand).to(self.device)
        mat = dequantize(self._matrix).index_select(0, rows)   # [M, D]
        # mat @ q as a reduction along each row: identical rows give
        # identical sums on either device, so their tie stays a tie
        sims = (mat * q[None]).sum(dim=1)
        if metric == "cosine":
            denom = self._norms.index_select(0, rows) * torch.linalg.norm(q)
            sims = torch.where(denom > 0, sims / denom,
                               torch.zeros_like(sims))
        elif metric == "l2":
            sims = -((mat - q[None]) ** 2).sum(dim=1)
        k = min(k, cand.size)
        order = torch.sort(sims, descending=True, stable=True).indices[:k]
        vals = sims.index_select(0, order).cpu().numpy()
        idx = order.cpu().numpy()
        return [(self._ids[int(cand[i])], float(v)) for v, i in zip(vals, idx)]

    def search(self, query_vector, k: int) -> List[Tuple[str, float]]:
        """Cosine top-k."""
        return self.query(query_vector, k, metric="cosine")

    def _candidate_rows(self, q: np.ndarray) -> np.ndarray:
        if self.centroids is None or len(self.inverted_lists) <= 1:
            return np.arange(len(self._ids))
        d = ((self.centroids - q[None]) ** 2).sum(-1)
        probe = np.argsort(d)[: self.nprobe]
        rows: List[int] = []
        for c in probe:
            rows.extend(self.inverted_lists.get(int(c), []))
        if not rows:
            return np.arange(len(self._ids))
        return np.asarray(sorted(rows))

    # -- batch quantization with cycling widths -----------------------------

    def quantize(self, vectors, bits: Sequence[int]) -> List[CompressedVector]:
        return compress_rows(vectors, bits, device=self.device)

    def predict_next_token(self, context_vectors, vocab_size: int) -> np.ndarray:
        """Uniform next-token distribution (the mean-pooled context is
        computed and unused, as in the JAX package; the engine's real path
        is `models.denoiser.logits_from_hidden`)."""
        if len(context_vectors):
            _ = np.mean(np.asarray(context_vectors, np.float32), axis=0)
        return np.full((vocab_size,), 1.0 / vocab_size, np.float32)


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na > 0 and nb > 0:
        return float(a @ b / (na * nb))
    return 0.0
