"""Core data types: TokenizedVector, Normalizer, WeightManager, PrefillKVQuant.

Counterpart of `diffusion_llm_rs_tpu/models/types.py`:
  - `TokenizedVector` {id, tokens, embeddings, attention_mask, offset} with
    `apply_mask` and a JSON round trip (host numpy, copied);
  - `Normalizer`: zero-mean / unit-variance normalization fit on data, the
    population standard deviation (`correction=0`, JAX's `jnp.std`);
  - `WeightManager`: named weights and accumulated gradients (bf16 by
    default) with `apply_gradients`; the learning rate is rounded to the
    weights' dtype before the product, as JAX's weakly typed scalar is;
  - `PrefillKVQuant`: a bank of bit widths whose `quantize_vectors` cycles
    them over tokenized vectors and returns `CompressedVector`s.

Tensors are made on `device` (the card unless the caller asks for the CPU)
where the JAX package makes arrays; a Normalizer follows its input's device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.index.anns import CompressedVector
from diffusion_llm_rs_tpu_torch.quant.core import (SUPPORTED_BITS, quantize,
                                                   true_div)


@dataclasses.dataclass
class TokenizedVector:
    """Token ids with their embedding rows [n_tokens, dim] (host numpy), an
    optional attention mask and the offset it was applied at."""

    id: str
    tokens: List[int]
    embeddings: np.ndarray                      # [n_tokens, dim]
    attention_mask: Optional[np.ndarray] = None
    offset: int = 0

    def apply_mask(self, mask: np.ndarray, offset: int) -> None:
        """Elementwise-mask embedding rows [offset, offset+len(mask))."""
        end = min(offset + mask.shape[0], self.embeddings.shape[0])
        self.embeddings = self.embeddings.copy()
        self.embeddings[offset:end] *= mask[: end - offset]
        self.attention_mask = mask
        self.offset = offset

    def to_json(self) -> str:
        return json.dumps({
            "id": self.id, "tokens": list(map(int, self.tokens)),
            "embeddings": self.embeddings.ravel().tolist(),
            "shape": list(self.embeddings.shape),
            "attention_mask": (self.attention_mask.ravel().tolist()
                               if self.attention_mask is not None else None),
            "mask_shape": (list(self.attention_mask.shape)
                           if self.attention_mask is not None else None),
            "offset": self.offset})

    @classmethod
    def from_json(cls, s: str) -> "TokenizedVector":
        d = json.loads(s)
        emb = np.asarray(d["embeddings"], np.float32).reshape(d["shape"])
        mask = None
        if d.get("attention_mask") is not None:
            mask = np.asarray(d["attention_mask"],
                              np.float32).reshape(d["mask_shape"])
        return cls(id=d["id"], tokens=d["tokens"], embeddings=emb,
                   attention_mask=mask, offset=d.get("offset", 0))


class Normalizer:
    """Zero-mean / unit-variance normalization fit on data statistics."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = mean
        self.std = std

    @classmethod
    def fit(cls, data) -> "Normalizer":
        arr = torch.as_tensor(data, dtype=torch.float32)
        std = float(torch.std(arr, correction=0))
        return cls(mean=float(torch.mean(arr)), std=std if std > 0 else 1.0)

    def normalize(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return true_div(x - _scalar(self.mean, x), self.std)

    def denormalize(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return x * _scalar(self.std, x) + _scalar(self.mean, x)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of `like`'s dtype and device: rounded
    once to that dtype, as JAX rounds a weakly typed scalar."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


class WeightManager:
    """Named weight + gradient store with gradient application. Weights are
    tensors on `device` (bf16 by default)."""

    def __init__(self, dtype=torch.bfloat16, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.weights: Dict[str, torch.Tensor] = {}
        self.gradients: Dict[str, torch.Tensor] = {}

    def _cast(self, value) -> torch.Tensor:
        return torch.as_tensor(value).to(device=self.device, dtype=self.dtype)

    def set_weight(self, name: str, value) -> None:
        self.weights[name] = self._cast(value)

    def get_weight(self, name: str) -> Optional[torch.Tensor]:
        return self.weights.get(name)

    def update_gradient(self, name: str, grad) -> None:
        g = self._cast(grad)
        if name in self.gradients:
            self.gradients[name] = self.gradients[name] + g
        else:
            self.gradients[name] = g

    def get_gradient(self, name: str) -> Optional[torch.Tensor]:
        return self.gradients.get(name)

    def apply_gradients(self, lr: float = 1e-3) -> None:
        for name, g in self.gradients.items():
            if name in self.weights:
                w = self.weights[name]
                self.weights[name] = (w - _scalar(lr, g) * g).to(self.dtype)
        self.gradients.clear()


class PrefillKVQuant:
    """Bit-width quantizer bank.

    `quantize_vectors` cycles the requested bit widths over the tokenized
    vectors and returns CompressedVectors; each vector's flattened
    embeddings are quantized on `device` with one scale and zero point."""

    def __init__(self, quantization_bits: Sequence[int] = (8, 4, 2, 1),
                 device="cuda"):
        for b in quantization_bits:
            if b not in SUPPORTED_BITS:
                raise ValueError(f"unsupported bit width {b}")
        self.quantization_bits = tuple(quantization_bits)
        self.compression_ratio = 1.0
        self.device = torch.device(device)

    def quantize_vectors(self, tokens: Sequence[TokenizedVector],
                         bits: Optional[Sequence[int]] = None
                         ) -> List[CompressedVector]:
        bits = tuple(bits) if bits else self.quantization_bits
        out: List[CompressedVector] = []
        orig_bytes = comp_bytes = 0
        for i, tv in enumerate(tokens):
            b = int(bits[i % len(bits)])
            flat = torch.from_numpy(np.asarray(tv.embeddings, np.float32)
                                    .ravel()).to(self.device)
            qt = quantize(flat, b)
            out.append(CompressedVector(
                id=tv.id, data=qt.data.cpu().numpy(), bits=b,
                original_shape=tuple(tv.embeddings.shape),
                quant_scale=float(qt.scale),
                quant_zero_point=float(qt.zero_point)))
            orig_bytes += flat.numel() * 4
            comp_bytes += qt.packed_nbytes()
        if comp_bytes:
            self.compression_ratio = orig_bytes / comp_bytes
        return out
