"""Load parameters exported from the JAX package.

`from_jax_params(tree, device)` takes the JAX denoiser parameter tree with
its leaves already turned into numpy arrays: a plain array, or a dict
`{"data", "col_scale"}` for a decoded `Int8Weight`. `from_jax_pools(pools,
device)` takes a serving batcher's page pools as `{bits: {name: array}}`;
the pools' layout is the same in both packages, so it is a plain copy. The
caller does the conversion to numpy, so this package never sees a JAX type.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight


def from_jax_params(tree, device="cuda"):
    """Nested dict/list of numpy leaves -> the same nesting of tensors (and
    `Int8Weight`s) on `device`."""
    if isinstance(tree, dict):
        if set(tree) == {"data", "col_scale"}:
            data = np.ascontiguousarray(tree["data"], np.int8)
            col_scale = np.ascontiguousarray(tree["col_scale"], np.float32)
            return Int8Weight(data=torch.from_numpy(data).to(device),
                              col_scale=torch.from_numpy(col_scale).to(device))
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
