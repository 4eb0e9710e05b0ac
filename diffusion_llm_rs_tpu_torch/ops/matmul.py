"""Linear-layer dispatch over plain, packed and decoded-int8 weights.

Counterpart of `diffusion_llm_rs_tpu/ops/matmul.py` (`Int8Weight`,
`decode_to_int8`, `int8_linear`, `int8_mlp`, `quantized_matmul`, `linear`).
`linear(x, w, b)` is the entry point the models use; `w` is
  - a plain tensor: f32/bf16 matmul with f32 accumulation,
  - an `Int8Weight`: the W4A8 "decoded" path through the `int8w_matmul` kernel,
  - a `MatmulWeight`: the packed layout through the `packed_matmul.matmul`
    kernel (bias and gelu in its epilogue, the residual added after it),
  - a `QuantizedTensor`: dequantized, then a plain matmul,
  - an `Fp8Tensor`: upcast in the matmul, scaled after it.

The JAX package quantizes activations from f32 on its non-TPU fallback but
from bf16 inside its TPU kernel; this port always follows the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffusion_llm_rs_tpu_torch.ops.int8_matmul import (
    MatmulWeight,
    gelu_tanh,
    int8w_matmul,
    int8w_mlp,
    prepare,
)
from diffusion_llm_rs_tpu_torch.ops import packed_matmul
from diffusion_llm_rs_tpu_torch.quant.core import (
    Fp8Tensor,
    QuantizedTensor,
    true_div,
)


def held_layout(data: torch.Tensor, device=None) -> torch.Tensor:
    """The one copy of an int8 [K, N] weight an `Int8Weight` holds on
    `device` (default: where `data` is). On the card it is K-major, [N, K]
    contiguous, and `data` its transposed view [K, N]: the layout the s8
    kernels read (`int8_matmul._k_major` returns it without a copy). On the
    CPU it is [K, N] contiguous, JAX's layout, which the plain versions
    read. A tensor already in the layout is returned as it is."""
    device = data.device if device is None else torch.device(device)
    if device.type == "cuda":
        if data.t().is_contiguous():
            return data.to(device)  # a dense view keeps its strides
        return data.t().contiguous().to(device).t()
    return data.to(device).contiguous()


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """Decoded int8 weight: the packed sub-byte weight re-gridded once, at load
    time, onto its per-column signed-int8 grid. `data` is [K, N] whatever the
    device; on the card it is the view of a K-major copy (`held_layout`),
    which every constructor and `to` make, so the card holds each weight
    once."""

    data: torch.Tensor        # int8 [K, N]
    col_scale: torch.Tensor   # f32 [1, N]

    def __post_init__(self):
        object.__setattr__(self, "data", held_layout(self.data))

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return 2

    def to(self, device) -> "Int8Weight":
        return Int8Weight(held_layout(self.data, device),
                          self.col_scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.data.to(torch.float32) * self.col_scale).to(dtype)


def decode_to_int8(w) -> Int8Weight:
    """MatmulWeight (or QuantizedTensor) -> Int8Weight, on the same column grid
    as the JAX package's a8 kernel: round((lv - zp) * scale / col_scale)
    clipped to +-127."""
    if isinstance(w, QuantizedTensor):
        w = prepare(w, act_bits=8)
    if not isinstance(w, MatmulWeight):
        raise TypeError(f"cannot decode {type(w).__name__}")
    if w.col_scale is None:
        w = dataclasses.replace(
            w, act_bits=8,
            col_scale=torch.clamp_min(true_div(
                w.dequantize(torch.float32).abs().amax(dim=0, keepdim=True),
                127.0), 1e-12))
    return Int8Weight(data=packed_matmul.regrid_int8(w),
                      col_scale=w.col_scale.contiguous())


def int8_linear(x: torch.Tensor, w: Int8Weight,
                b: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """y = act(quant_act(x) @ w8 * sx * col_scale + b) (+ residual)."""
    return int8w_matmul(x, w.data, w.col_scale, bias=b, activation=activation,
                        residual=residual, out_dtype=out_dtype)


def int8_mlp(x: torch.Tensor, w1: Int8Weight, b1: torch.Tensor,
             w2: Int8Weight, b2: torch.Tensor,
             residual: Optional[torch.Tensor] = None,
             out_dtype=None) -> torch.Tensor:
    """MLP block gelu(x @ w1 + b1) @ w2 + b2 (+ residual) over decoded int8
    weights."""
    return int8w_mlp(x, w1.data, w1.col_scale, b1, w2.data, w2.col_scale, b2,
                     residual=residual, out_dtype=out_dtype or x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, as the JAX package's dot."""
    return x.to(torch.float32) @ w.to(torch.float32)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                     preferred_dtype=torch.float32) -> torch.Tensor:
    """x @ dequant(qt) for a 2-D weight [K, N]: dequantized to x's dtype,
    then a plain matmul (no kernel of the JAX package takes this layout)."""
    if qt.ndim != 2:
        raise ValueError(f"quantized_matmul expects 2-D weights, got {qt.shape}")
    return _dot(x, qt.dequantize(x.dtype)).to(preferred_dtype)


def linear(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    *,
    preferred_dtype=None,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense layer y = act(x @ w + b) (+ residual).

    `w` is a plain tensor, an `Int8Weight`, a `MatmulWeight`, a
    `QuantizedTensor` or an `Fp8Tensor`; `activation` is "gelu" or None.
    """
    out_dtype = preferred_dtype or x.dtype
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if isinstance(w, Int8Weight):
        return int8_linear(x, w, b, activation, residual, out_dtype)
    if isinstance(w, MatmulWeight):
        # the kernel rounds once to out_dtype; the residual is added to that
        y = packed_matmul.matmul(x, w, out_dtype=out_dtype, bias=b,
                                 activation=activation)
        return y if residual is None else y + residual.to(y.dtype)
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w).to(out_dtype)
    elif isinstance(w, Fp8Tensor):
        y = (_dot(x, w.data.to(x.dtype)) * w.scale).to(out_dtype)
    elif isinstance(w, torch.Tensor):
        y = _dot(x, w.to(x.dtype)).to(out_dtype)
    else:
        raise TypeError(f"linear: unsupported weight type {type(w).__name__}")
    if b is not None:
        y = y + b.to(y.dtype)
    if activation == "gelu":
        y = gelu_tanh(y)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y
