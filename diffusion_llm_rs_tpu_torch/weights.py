"""Load parameters exported from the JAX package.

`from_jax_params(tree, device)` takes the JAX denoiser parameter tree with
its leaves already turned into numpy arrays: a plain array, or a dict of
arrays and fields for a quantized leaf, told apart by its keys:
`{"data", "col_scale"}` a decoded `Int8Weight`; `{"data", "scale"}` an
`Fp8Tensor` (data as the uint8 view of the float8 bytes); `{"data", "scale",
"zero_point", "bits", "shape", "granularity", "group_size", "axis",
"symmetric"}` a `QuantizedTensor`; `{"data", "scale", "zero_point",
"col_scale" (or None), "bits", "K", "N", "group_size", "act_bits"}` a
`MatmulWeight`. `from_jax_pools(pools,
device)` takes a serving batcher's page pools as `{bits: {name: array}}`;
the pools' layout is the same in both packages, so it is a plain copy. The
caller does the conversion to numpy, so this package never sees a JAX type.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.ops.matmul import (Int8Weight, MatmulWeight,
                                                   held_layout)
from diffusion_llm_rs_tpu_torch.quant.core import Fp8Tensor, QuantizedTensor

_QUANTIZED_KEYS = {"data", "scale", "zero_point", "bits", "shape",
                   "granularity", "group_size", "axis", "symmetric"}
_MATMUL_KEYS = {"data", "scale", "zero_point", "col_scale", "bits", "K", "N",
                "group_size", "act_bits"}


def _tensor(arr, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=dtype, order="C")).to(device)


def from_jax_params(tree, device="cuda"):
    """Nested dict/list of numpy leaves -> the same nesting of tensors (and
    quantized leaves) on `device`."""
    if isinstance(tree, dict):
        keys = set(tree)
        if keys == {"data", "col_scale"}:
            # laid out on the host, so the card gets its one K-major copy
            return Int8Weight(data=held_layout(_tensor(tree["data"], np.int8,
                                                       "cpu"), device),
                              col_scale=_tensor(tree["col_scale"], np.float32,
                                                device))
        if keys == {"data", "scale"}:
            return Fp8Tensor(
                data=_tensor(tree["data"], np.uint8, device).view(
                    torch.float8_e4m3fn),
                scale=_tensor(tree["scale"], np.float32, device))
        if keys in (_QUANTIZED_KEYS, _MATMUL_KEYS):
            arrays = dict(
                data=_tensor(tree["data"], np.uint8, device),
                scale=_tensor(tree["scale"], np.float32, device),
                zero_point=_tensor(tree["zero_point"], np.float32, device))
            if keys == _QUANTIZED_KEYS:
                return QuantizedTensor(
                    **arrays, bits=int(tree["bits"]),
                    shape=tuple(int(d) for d in tree["shape"]),
                    granularity=tree["granularity"],
                    group_size=int(tree["group_size"]), axis=int(tree["axis"]),
                    symmetric=bool(tree["symmetric"]))
            cs = tree["col_scale"]
            return MatmulWeight(
                **arrays, bits=int(tree["bits"]), K=int(tree["K"]),
                N=int(tree["N"]), group_size=int(tree["group_size"]),
                act_bits=int(tree["act_bits"]),
                col_scale=None if cs is None else _tensor(cs, np.float32,
                                                          device))
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def from_jax_pools(pools, device="cuda"):
    """`{bits: {name: np.ndarray}}` page pools -> the same dict of tensors on
    `device` (uint8 packed pages, f32 sidecars)."""
    return {int(bits): {name: torch.from_numpy(np.array(arr)).to(device)
                        for name, arr in pool.items()}
            for bits, pool in pools.items()}
