"""Checkpoint save/load for parameter trees.

Counterpart of `diffusion_llm_rs_tpu/utils/serialization.py`, with the same
files: `<path>.npz` of flat arrays keyed `"{i}:data"`, `"{i}:scale"`,
`"{i}:zp"`, `"{i}:col_scale"` and `<path>.json` with one manifest entry per
leaf, so a checkpoint written by either package loads in the other. Leaf i
is the i-th leaf in the JAX package's flatten order: dict keys sorted, lists
in order; a `QuantizedTensor`, `MatmulWeight` or `Fp8Tensor` is one leaf,
and an `Int8Weight` two plain arrays, its data [K, N] and its col_scale, as
JAX flattens it (a card weight held K-major is written in JAX's [K, N]
layout). The JAX package also stores its serialized tree structure; this package
writes null there, and neither reads it back.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.ops.int8_matmul import MatmulWeight
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight
from diffusion_llm_rs_tpu_torch.quant.core import (Fp8Tensor, QuantizedTensor,
                                                   tree_leaves)


def _leaves(tree) -> list:
    """`tree_leaves`, with each `Int8Weight` as its two arrays."""
    out = []
    for leaf in tree_leaves(tree):
        out += ([leaf.data, leaf.col_scale] if isinstance(leaf, Int8Weight)
                else [leaf])
    return out


def _unflatten(like, leaves):
    """`like`'s nesting with its leaves replaced, in flatten order, by the
    items of the iterator `leaves`."""
    if isinstance(like, dict):
        new = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, Int8Weight):
        return Int8Weight(next(leaves), next(leaves))
    return None if like is None else next(leaves)


def _np(t: torch.Tensor) -> np.ndarray:
    """The host array in C order (a K-major card weight comes back as a
    transposed view)."""
    return t.detach().cpu().contiguous().numpy()


def save_checkpoint(path: str, params: Any, metadata: Dict = None) -> None:
    """Write `<path>.npz` + `<path>.json`."""
    leaves = _leaves(params)
    arrays: Dict[str, np.ndarray] = {}
    manifest: List[Dict] = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, (QuantizedTensor, MatmulWeight)):
            arrays[f"{i}:data"] = _np(leaf.data)
            arrays[f"{i}:scale"] = _np(leaf.scale)
            arrays[f"{i}:zp"] = _np(leaf.zero_point)
            if isinstance(leaf, QuantizedTensor):
                manifest.append({
                    "kind": "quantized", "bits": leaf.bits,
                    "shape": list(leaf.shape), "granularity": leaf.granularity,
                    "group_size": leaf.group_size, "axis": leaf.axis,
                    "symmetric": leaf.symmetric})
            else:
                if leaf.col_scale is not None:
                    arrays[f"{i}:col_scale"] = _np(leaf.col_scale)
                manifest.append({
                    "kind": "matmul_weight", "bits": leaf.bits, "K": leaf.K,
                    "N": leaf.N, "group_size": leaf.group_size,
                    "act_bits": leaf.act_bits})
        elif isinstance(leaf, Fp8Tensor):
            arrays[f"{i}:data"] = _np(leaf.data.view(torch.uint8))
            arrays[f"{i}:scale"] = _np(leaf.scale)
            manifest.append({"kind": "fp8", "shape": list(leaf.data.shape)})
        elif isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            arrays[f"{i}:data"] = _np(leaf.view(torch.int16)).view(np.uint16)
            manifest.append({"kind": "bf16", "shape": list(leaf.shape)})
        else:
            arrays[f"{i}:data"] = (_np(leaf) if isinstance(leaf, torch.Tensor)
                                   else np.asarray(leaf))
            manifest.append({"kind": "array"})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"treedef": None, "num_leaves": len(leaves),
                   "manifest": manifest, "metadata": metadata or {}}, f)


def load_checkpoint(path: str, like: Any, device="cuda") -> Any:
    """Load into the structure of `like` (same nesting as saved), onto
    `device`."""
    data = np.load(path + ".npz")
    with open(path + ".json") as f:
        manifest = json.load(f)["manifest"]

    def tensor(key):
        return torch.from_numpy(np.array(data[key])).to(device)

    leaves = []
    for i, m in enumerate(manifest):
        kind = m["kind"]
        if kind == "quantized":
            leaves.append(QuantizedTensor(
                data=tensor(f"{i}:data"), scale=tensor(f"{i}:scale"),
                zero_point=tensor(f"{i}:zp"), bits=m["bits"],
                shape=tuple(m["shape"]), granularity=m["granularity"],
                group_size=m["group_size"], axis=m["axis"],
                symmetric=m["symmetric"]))
        elif kind == "matmul_weight":
            cs_key = f"{i}:col_scale"
            leaves.append(MatmulWeight(
                data=tensor(f"{i}:data"), scale=tensor(f"{i}:scale"),
                zero_point=tensor(f"{i}:zp"), bits=m["bits"], K=m["K"],
                N=m["N"], group_size=m["group_size"],
                act_bits=m.get("act_bits", 16),
                col_scale=tensor(cs_key) if cs_key in data.files else None))
        elif kind == "fp8":
            leaves.append(Fp8Tensor(
                data=tensor(f"{i}:data").view(torch.float8_e4m3fn),
                scale=tensor(f"{i}:scale")))
        elif kind == "bf16":
            leaves.append(torch.from_numpy(np.array(
                data[f"{i}:data"]).view(np.int16)).view(torch.bfloat16)
                .to(device))
        else:
            leaves.append(tensor(f"{i}:data"))
    expected = len(_leaves(like))
    if expected != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, `like` has "
                         f"{expected}")
    return _unflatten(like, iter(leaves))


def get_metadata(path: str) -> Dict:
    with open(path + ".json") as f:
        return json.load(f)["metadata"]
