"""Core quantization: 1/2/4/8-bit affine quantize/dequantize with bit-packing.

Counterpart of `diffusion_llm_rs_tpu/quant/core.py`; packed bytes, scales and
zero-points match it bit for bit. Scheme:

    q  = clamp(round(x / scale) + zero_point, 0, 2^bits - 1)     # unsigned carrier
    x' = (q - zero_point) * scale

Sub-byte widths are bit-packed little-endian into a uint8 carrier along the
last axis. Scales and zero-points are float32 tensors at per-tensor,
per-channel or per-group granularity. `torch.round`, like `jnp.round`,
rounds half to even. `Fp8Tensor` / `quantize_fp8` store float8_e4m3fn with
a per-tensor scale; the bytes equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence, Tuple

import torch

SUPPORTED_BITS = (1, 2, 4, 8)

Granularity = Literal["tensor", "channel", "group"]


def qmax_for_bits(bits: int) -> int:
    """Max level of the unsigned carrier, 2^bits - 1."""
    return (1 << bits) - 1


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, correctly rounded on every device. PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's rounded reciprocal instead, which
    can differ in the last bit; a 0-d tensor filled on a's device divides
    (and, made without a host copy, can be captured in a CUDA graph)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def div_const(a: torch.Tensor, b: float, reciprocal: bool = False) -> torch.Tensor:
    """a / b for a constant b. With `reciprocal`, a * (1 / b) with the
    reciprocal rounded to f32 first: what XLA makes of a division by a
    constant inside a compiled program (a `jax.jit` or `lax.scan` body),
    which can differ from the division in the last bit."""
    if not reciprocal:
        return true_div(a, b)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    return a * (one / torch.full((), b, dtype=a.dtype, device=a.device))


def packed_last_dim(last: int, bits: int) -> int:
    """Carrier bytes of `last` values packed at `bits`."""
    vpb = 8 // bits
    return -(-last // vpb)  # ceil


def pack_bits(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned levels (values in [0, 2^bits-1]) into a uint8 carrier.

    Packs along the last axis; value i of each byte occupies bits
    [i*bits, (i+1)*bits) (little-endian). 8-bit is the identity (cast).
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    q = q.to(torch.uint8)
    if bits == 8:
        return q
    vpb = 8 // bits
    *lead, last = q.shape
    pad = (-last) % vpb
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    q = q.reshape(*lead, -1, vpb)
    out = q[..., 0].clone()
    for i in range(1, vpb):
        out |= q[..., i] << (i * bits)
    return out


def unpack_bits(packed: torch.Tensor, bits: int, last: int) -> torch.Tensor:
    """Inverse of pack_bits: uint8 carrier -> unsigned levels, last axis = `last`."""
    if bits == 8:
        return packed
    vpb = 8 // bits
    mask = qmax_for_bits(bits)
    *lead, _ = packed.shape
    parts = [(packed >> (i * bits)) & mask for i in range(vpb)]
    vals = torch.stack(parts, dim=-1).reshape(*lead, -1)
    return vals[..., :last]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized tensor: packed uint8 carrier + affine sidecar params.

    data: uint8, shape = shape[:-1] + (ceil(shape[-1] * bits / 8),)
    scale/zero_point: float32, shape per `granularity`:
        tensor  -> ()
        channel -> shape with all axes 1 except `axis`
        group   -> shape with `axis` replaced by n_groups
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int
    shape: Tuple[int, ...]
    granularity: Granularity = "tensor"
    group_size: int = 128
    axis: int = -1
    symmetric: bool = False

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype `dequantize` gives by default, as JAX's `dtype`."""
        return torch.float32

    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    def packed_nbytes(self) -> int:
        return (self.num_elements() * self.bits + 7) // 8

    def sidecar_nbytes(self) -> int:
        return max(self.scale.numel(), 1) * 4 * 2

    def compression_ratio(self, include_sidecar: bool = False) -> float:
        """Original f32 bytes / compressed bytes: the packed data only, or
        with include_sidecar=True the scales and zero points too."""
        original = self.num_elements() * 4
        compressed = self.packed_nbytes()
        if include_sidecar:
            compressed += self.sidecar_nbytes()
        return original / max(compressed, 1)

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device),
                                   zero_point=self.zero_point.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)


def compute_qparams(
    x: torch.Tensor,
    bits: int,
    *,
    symmetric: bool = False,
    granularity: Granularity = "tensor",
    group_size: int = 128,
    axis: int = -1,
    reciprocal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (scale, zero_point) float32 tensors for the given granularity.

    Asymmetric: scale = (max - min) / (2^bits - 1) (1.0 where the range is 0),
    zp = -min / scale, unclamped. Symmetric: scale = max|x| / 2^(bits-1)
    (1.0 where 0), zp = 2^(bits-1). `reciprocal`: see `div_const`.
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    x = x.to(torch.float32)
    qmax = float(qmax_for_bits(bits))

    if granularity == "tensor":
        return _params_from_minmax(x.amin(), x.amax(), qmax, symmetric,
                                   reciprocal)
    if granularity == "channel":
        ax = axis % x.ndim
        dims = tuple(i for i in range(x.ndim) if i != ax)
        return _params_from_minmax(x.amin(dim=dims, keepdim=True),
                                   x.amax(dim=dims, keepdim=True),
                                   qmax, symmetric, reciprocal)
    if granularity == "group":
        ax = axis % x.ndim
        if x.shape[ax] % group_size != 0:
            raise ValueError(
                f"axis {ax} dim {x.shape[ax]} not divisible by group_size {group_size}")
        xg = x.reshape(x.shape[:ax] + (x.shape[ax] // group_size, group_size)
                       + x.shape[ax + 1:])
        return _params_from_minmax(xg.amin(dim=ax + 1), xg.amax(dim=ax + 1),
                                   qmax, symmetric, reciprocal)
    raise ValueError(f"unknown granularity {granularity!r}")


def _params_from_minmax(mn, mx, qmax, symmetric, reciprocal=False):
    if symmetric:
        amax = torch.maximum(mn.abs(), mx.abs())
        half = (qmax + 1.0) / 2.0  # 2^(bits-1)
        scale = torch.where(amax > 0, true_div(amax, half), 1.0)
        zp = torch.full_like(scale, half)
    else:
        rng = mx - mn
        scale = torch.where(rng > 0, div_const(rng, qmax, reciprocal), 1.0)
        zp = -mn / scale
    return scale.to(torch.float32), zp.to(torch.float32)


def quantize(
    x: torch.Tensor,
    bits: int,
    *,
    symmetric: bool = False,
    granularity: Granularity = "tensor",
    group_size: int = 128,
    axis: int = -1,
    scale: Optional[torch.Tensor] = None,
    zero_point: Optional[torch.Tensor] = None,
    reciprocal: bool = False,
) -> QuantizedTensor:
    """Quantize `x` to `bits` with the given granularity; returns QuantizedTensor.

    Pass precomputed (scale, zero_point) to skip the min/max pass.
    `reciprocal`: see `div_const`.
    """
    x = torch.as_tensor(x).to(torch.float32)
    if scale is None or zero_point is None:
        scale, zero_point = compute_qparams(
            x, bits, symmetric=symmetric, granularity=granularity,
            group_size=group_size, axis=axis, reciprocal=reciprocal)
    qmax = float(qmax_for_bits(bits))
    ax = axis % max(x.ndim, 1) if x.ndim else 0

    if granularity == "group":
        n_groups = x.shape[ax] // group_size
        xg = x.reshape(x.shape[:ax] + (n_groups, group_size) + x.shape[ax + 1:])
        s = scale.unsqueeze(ax + 1)
        z = zero_point.unsqueeze(ax + 1)
        q = torch.round(xg / s + z).clamp(0.0, qmax).to(torch.uint8)
        q = q.reshape(x.shape)
    else:
        q = torch.round(x / scale + zero_point).clamp(0.0, qmax).to(torch.uint8)

    return QuantizedTensor(
        data=pack_bits(q, bits), scale=scale, zero_point=zero_point, bits=bits,
        shape=tuple(x.shape), granularity=granularity, group_size=group_size,
        axis=ax if x.ndim else -1, symmetric=symmetric)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize back to floats: (q - zp) * scale."""
    last = qt.shape[-1] if qt.shape else 1
    q = unpack_bits(qt.data, qt.bits, last).to(torch.float32).reshape(qt.shape)
    if qt.granularity == "group":
        ax = qt.axis % len(qt.shape)
        n_groups = qt.shape[ax] // qt.group_size
        qg = q.reshape(qt.shape[:ax] + (n_groups, qt.group_size)
                       + qt.shape[ax + 1:])
        out = (qg - qt.zero_point.unsqueeze(ax + 1)) * qt.scale.unsqueeze(ax + 1)
        out = out.reshape(qt.shape)
    else:
        out = (q - qt.zero_point) * qt.scale
    return out.to(dtype)


@dataclasses.dataclass(frozen=True)
class Fp8Tensor:
    """Per-tensor-scaled float8_e4m3fn storage."""

    data: torch.Tensor   # float8_e4m3fn
    scale: torch.Tensor  # f32 scalar

    @property
    def shape(self):
        return tuple(self.data.shape)

    def to(self, device) -> "Fp8Tensor":
        return Fp8Tensor(self.data.to(device), self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.data.to(dtype) * self.scale.to(dtype)


FP8_MAX = 448.0  # float8_e4m3fn finite max


def quantize_fp8(x: torch.Tensor) -> Fp8Tensor:
    """x -> float8_e4m3fn(x / scale), scale = max|x| / 448 (1.0 where 0). The
    quotient is rounded once, from f32, half to even."""
    x = torch.as_tensor(x).to(torch.float32)
    amax = x.abs().amax()
    scale = torch.where(amax > 0, true_div(amax, FP8_MAX), 1.0).to(torch.float32)
    return Fp8Tensor(data=(x / scale).to(torch.float8_e4m3fn), scale=scale)


def map_leaves(fn, tree, path=()):
    """Apply fn(path, leaf) to every leaf of a nested dict/list; a quantized
    leaf (a dataclass) is one leaf, and `path` is its tuple of keys."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list in the JAX package's flatten order:
    dict keys sorted, lists in order, None skipped; a quantized leaf is one
    leaf."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [] if tree is None else [tree]


def dequantize_tree(params, dtype=torch.float32):
    """Every quantized leaf (QuantizedTensor, Fp8Tensor, MatmulWeight,
    Int8Weight: any non-tensor with `dequantize`) back to a plain tensor."""
    def _d(_, leaf):
        if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "dequantize"):
            return leaf.dequantize(dtype)
        return leaf
    return map_leaves(_d, params)


def quantize_tree(params, bits: int, *, min_size: int = 1024,
                  symmetric: bool = False, granularity: Granularity = "group",
                  group_size: int = 128, axis: int = 0,
                  exclude: Sequence[str] = ("pos_embed",)):
    """Quantize every large >=2D floating leaf of a nested dict/list of tensors.

    Small tensors (biases, layernorm gains) stay in full precision. The group
    axis defaults to 0, the contraction axis of `x @ W`. Leaves whose path
    ("blocks/0/attn/wqkv") contains an `exclude` substring stay unquantized.
    A leaf whose axis is not group-divisible falls back to per-channel
    quantization along axis 1.
    """

    def _q(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf  # already quantized, or not an array
        if any(e in "/".join(path) for e in exclude):
            return leaf
        if (leaf.ndim < 2 or leaf.numel() < min_size
                or not leaf.dtype.is_floating_point):
            return leaf
        if leaf.shape[axis] % group_size != 0:
            return quantize(leaf, bits, symmetric=symmetric,
                            granularity="channel", axis=1)
        return quantize(leaf, bits, symmetric=symmetric, granularity=granularity,
                        group_size=group_size, axis=axis)

    return map_leaves(_q, params)
