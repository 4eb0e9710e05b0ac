"""GPTQ: error-compensated weight quantization.

Counterpart of `diffusion_llm_rs_tpu/quant/gptq.py`:
  - `HessianCollector`: H = sum x x^T per linear input, through
    `models.denoiser.denoiser_forward(tap=...)`.
  - `gptq_quantize_matrix`: the rows of W [K, N] (the input features of
    `x @ W`) are quantized one at a time; each row's error, scaled by the
    damped inverse Hessian's upper Cholesky factor, is pushed onto the rows
    not yet quantized (blocks of 128 rows, then one product for the rest).
    `desc_act` processes rows in descending diag(H) order with "static
    groups": the grids come from the original contiguous groups, so the
    result has RTN's layout. A Hessian that cannot be inverted falls back
    to diagonal compensation.
  - `gptq_quantize_tree` with `true_sequential` (each stage's Hessians
    recaptured after the stages before it are quantized), and
    `make_calib_batches`.

The arithmetic is float64 torch on the weight's device (the card unless the
caller keeps the weights on the CPU); no kernel of the JAX package exists
for it. Host numpy takes the two steps whose order JAX's numpy fixes: the
descending sort of diag(H) (ties in numpy's order) and the mean of the
diagonal (numpy's pairwise sum). Where JAX draws the forward-process noise
from a key, `make_calib_batches` takes a noise source or a generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor, map_leaves,
                                                   pack_bits, qmax_for_bits,
                                                   true_div)


class HessianCollector:
    """Accumulates H = sum x x^T (float64) per tapped linear input.

    Pass `.tap` as `denoiser_forward(tap=...)`. `names` optionally restricts
    collection (true_sequential recaptures one stage at a time)."""

    def __init__(self, names: Optional[Sequence[str]] = None):
        self.names = set(names) if names is not None else None
        self.h: Dict[str, torch.Tensor] = {}
        self.count: Dict[str, int] = {}

    def tap(self, name: str, x: torch.Tensor) -> None:
        if self.names is not None and name not in self.names:
            return
        x2 = x.to(torch.float64).reshape(-1, x.shape[-1])
        if name not in self.h:
            self.h[name] = torch.zeros((x2.shape[1], x2.shape[1]),
                                       dtype=torch.float64, device=x2.device)
            self.count[name] = 0
        self.h[name] += x2.T @ x2
        self.count[name] += x2.shape[0]


def _group_params(w: torch.Tensor, qmax: float, symmetric: bool):
    """RTN grid of one group slice w [gs, N] -> (scale [N], zp [N]), the
    grid of `quant.core.quantize`: GPTQ differs from RTN only in which level
    each weight lands on."""
    if symmetric:
        amax = w.abs().amax(dim=0)
        half = (qmax + 1.0) / 2.0
        scale = torch.where(amax > 0, true_div(amax, half), 1.0)
        zp = torch.full_like(scale, half)
    else:
        mn, mx = w.amin(dim=0), w.amax(dim=0)
        rng = mx - mn
        scale = torch.where(rng > 0, true_div(rng, qmax), 1.0)
        zp = -mn / scale
    return scale, zp


def gptq_quantize_matrix(
    w: torch.Tensor,
    hessian: torch.Tensor,
    bits: int,
    *,
    group_size: int = 128,
    symmetric: bool = True,
    desc_act: bool = True,
    damp: float = 0.01,
    block_size: int = 128,
) -> QuantizedTensor:
    """GPTQ-quantize one weight W [K, N] (contraction axis K) given its input
    Hessian H [K, K], on W's device. Returns a group-axis-0 QuantizedTensor,
    the layout of `quant.core.quantize(..., granularity="group", axis=0)`."""
    dev = w.device
    W = w.to(torch.float64).clone()
    K, N = W.shape
    H = torch.as_tensor(hessian).to(device=dev, dtype=torch.float64).clone()
    if H.shape != (K, K):
        raise ValueError(f"hessian {tuple(H.shape)} does not match W rows {K}")
    qmax = float(qmax_for_bits(bits))
    gs = group_size if K % group_size == 0 else K
    n_groups = K // gs

    # dead inputs: never activated, so the weight value is irrelevant
    diag = torch.diagonal(H).clone()
    dead = torch.nonzero(diag == 0).flatten()
    H[dead, dead] = 1.0
    W[dead, :] = 0.0

    diag_np = diag.cpu().numpy()
    perm = np.argsort(-diag_np) if desc_act else np.arange(K)
    perm_t = torch.from_numpy(perm).to(dev)
    W = W[perm_t]
    H = H[perm_t][:, perm_t]

    scales = torch.empty((n_groups, N), dtype=torch.float64, device=dev)
    zps = torch.empty((n_groups, N), dtype=torch.float64, device=dev)
    if desc_act:
        # static groups: grids from the original group layout
        W_orig = w.to(torch.float64)
        for g in range(n_groups):
            scales[g], zps[g] = _group_params(W_orig[g * gs:(g + 1) * gs],
                                              qmax, symmetric)

    # damped inverse-Hessian upper Cholesky factor: inv(H) = U^T U
    mean_diag = float(np.mean(torch.diagonal(H).cpu().numpy()))
    H.diagonal().add_(damp * mean_diag)
    try:
        U = torch.linalg.cholesky(torch.linalg.inv(H)).T
    except torch.linalg.LinAlgError:
        # pathological calibration: diagonal compensation
        U = torch.diag(1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H),
                                                        1e-12)))

    levels = torch.empty((K, N), dtype=torch.uint8, device=dev)
    for i0 in range(0, K, block_size):
        i1 = min(i0 + block_size, K)
        Wb = W[i0:i1]
        Err = torch.zeros_like(Wb)
        for j in range(i1 - i0):
            gj = i0 + j
            orig = int(perm[gj])
            g = orig // gs
            if not desc_act and gj % gs == 0:
                # dynamic grid from the error-compensated weights (perm is
                # the identity, so rows gj:gj+gs are the original group)
                scales[g], zps[g] = _group_params(W[gj:gj + gs], qmax,
                                                  symmetric)
            lv = torch.clamp(torch.round(Wb[j] / scales[g] + zps[g]), 0.0, qmax)
            levels[orig] = lv.to(torch.uint8)
            qval = (lv - zps[g]) * scales[g]
            err = (Wb[j] - qval) / U[gj, gj]
            Wb[j + 1:] -= U[gj, gj + 1:i1, None] * err[None, :]
            Err[j] = err
        W[i1:] -= U[i0:i1, i1:].T @ Err

    return QuantizedTensor(
        data=pack_bits(levels, bits), scale=scales.to(torch.float32),
        zero_point=zps.to(torch.float32), bits=bits, shape=(K, N),
        granularity="group", group_size=gs, axis=0, symmetric=symmetric)


def _forward_order_names(params) -> List[List[str]]:
    """Tapped weight names grouped into forward-order stages."""
    stages = [["time_mlp/w1", "time_mlp/w2"]]
    for i in range(len(params["blocks"])):
        stages.append([f"blocks/{i}/attn/wqkv", f"blocks/{i}/attn/wo",
                       f"blocks/{i}/mlp/w1", f"blocks/{i}/mlp/w2"])
    stages.append(["head/w"])
    return stages


def _get_by_path(params, name: str):
    node = params
    for part in name.split("/"):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def _set_by_path(params, name: str, value) -> None:
    parts = name.split("/")
    node = params
    for part in parts[:-1]:
        node = node[int(part)] if part.isdigit() else node[part]
    last = parts[-1]
    if last.isdigit():
        node[int(last)] = value
    else:
        node[last] = value


def gptq_quantize_tree(
    params,
    cfg,
    calib_batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    *,
    bits: Optional[int] = None,
    group_size: Optional[int] = None,
    symmetric: Optional[bool] = None,
    desc_act: Optional[bool] = None,
    true_sequential: Optional[bool] = None,
    damp: float = 0.01,
):
    """GPTQ-quantize the denoiser's linear weights in place of RTN.

    `calib_batches` holds (x [B, S, D] noisy embeddings, t [B]) inputs.
    Settings default to `cfg.weight_quant`. Returns a new tree whose tapped
    2-D weight tensors are QuantizedTensors; the embeddings stay as they
    are. With `true_sequential` each stage's Hessians are recaptured after
    every earlier stage is quantized."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn

    wq = cfg.weight_quant
    bits = wq.bits if bits is None else bits
    group_size = wq.group_size if group_size is None else group_size
    symmetric = wq.sym if symmetric is None else symmetric
    desc_act = wq.desc_act if desc_act is None else desc_act
    true_sequential = (wq.true_sequential if true_sequential is None
                       else true_sequential)

    params = map_leaves(lambda _, leaf: leaf, params)  # new containers
    stages = _forward_order_names(params)
    if not true_sequential:
        stages = [[n for stage in stages for n in stage]]

    def capture(names):
        col = HessianCollector(names)
        for x, t in calib_batches:
            dn.denoiser_forward(params, cfg, x, t, tap=col.tap)
        return col

    for stage_names in stages:
        col = capture(stage_names)
        for name in stage_names:
            leaf = _get_by_path(params, name)
            if not (isinstance(leaf, torch.Tensor) and leaf.ndim == 2):
                continue
            if name not in col.h:
                continue
            qt = gptq_quantize_matrix(
                leaf, col.h[name], bits, group_size=group_size,
                symmetric=symmetric, desc_act=desc_act, damp=damp)
            _set_by_path(params, name, qt)
    return params


def make_calib_batches(params, cfg, schedule, token_batches, noise=None,
                       timesteps: Sequence[int] = (1, 10, 25)):
    """(noisy embedding, t) calibration batches from token-id arrays: the
    forward-process inputs the denoiser sees while sampling, on the
    schedule's device. `noise` gives the forward-process draws, one per
    batch in JAX's key-split order: a noise source (`admission(shape)`, see
    `serving`) or a `torch.Generator` (default: one seeded with 0)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import add_noise

    dev = schedule.sqrt_alpha_bars.device
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(0)

    def draw(shape):
        if isinstance(noise, torch.Generator):
            return torch.randn(shape, generator=noise, dtype=torch.float32,
                               device=noise.device).to(dev)
        return noise.admission(shape).to(dev)

    batches = []
    for ids in token_batches:
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        if ids.ndim == 1:
            ids = ids[None]
        x0 = dn.embed_tokens(params, ids)
        for t in timesteps:
            t = min(t, cfg.num_timesteps - 1)
            t_vec = torch.full((ids.shape[0],), t, dtype=torch.int64,
                               device=dev)
            x_t, _ = add_noise(schedule, x0, t_vec, noise=draw(tuple(x0.shape)))
            batches.append((x_t, t_vec))
    return batches
