"""Process meshes, sharding rules and the sharded infer/sample/train steps.

Counterpart of `diffusion_llm_rs_tpu/parallel/mesh.py`. One process drives
one device. `initialize_distributed` joins the process group (NCCL unless
the caller asks for gloo, the CPU's backend); `make_mesh` lays the
processes out as a ('data', 'model') mesh, a `DeviceMesh` from
`init_device_mesh`, whose groups carry the collectives:

  - Megatron tensor parallelism over 'model' (`parallel/tp.py`): attention
    QKV and MLP up-projections split by columns, output projections by
    rows, one `all_reduce` a sublayer
  - data parallelism over 'data': the batch split, the gradient averaged
    with an `all_reduce`
  - quantized weights split like their fp counterparts: packed data and the
    scale/zero-point sidecars on the same logical axis

Where JAX places a global array (`NamedSharding`), a rank here holds its own
shard: `shard_params` and `shard_batch` return this rank's leaves and rows,
and the steps take and return them. On one process with no group every
collective is the identity; whenever a group exists (a group of one
included) the collective is called.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         p_losses, p_sample,
                                                         respaced_timesteps)
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import MatmulWeight
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight
from diffusion_llm_rs_tpu_torch.parallel import tp as tpm
from diffusion_llm_rs_tpu_torch.quant.core import QuantizedTensor, map_leaves


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> None:
    """Join the process group: `backend` NCCL (the card) unless the caller
    names another (gloo for the CPU). A no-op on one process with nothing to
    join (no `init_method`, `world_size` None or 1), as JAX's single-host
    call; with an `init_method` a group of one is made too. `timeout` bounds
    each collective's wait (torch's default otherwise)."""
    if init_method is None and (world_size is None or world_size <= 1):
        return
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=world_size or 1, rank=rank or 0, **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the processes, this process's device, and the
    `DeviceMesh` whose groups run the collectives (None on one process with
    no group: every collective is then the identity)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    device_mesh: object = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as JAX's `mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    def group(self, axis: str):
        """The process group along `axis` (None without a process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This process's coordinate along `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)


def _rank_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh asks for the card, and torch sees none")
    if dist.is_initialized():
        index = dist.get_rank() % torch.cuda.device_count()
    else:
        index = torch.cuda.current_device() if device.index is None \
            else device.index
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def build_mesh(sizes: Tuple[int, ...], axis_names: Tuple[str, ...],
               device="cuda") -> Mesh:
    """A mesh of `sizes` over every process of the group (one process and
    no group: a mesh of ones)."""
    sizes = tuple(int(s) for s in sizes)
    world = world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh shape {sizes} != {world} processes")
    dev = _rank_device(device)
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(dev.type, sizes,
                                       mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), sizes, dev, device_mesh)


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              device="cuda") -> Mesh:
    """A ('data', 'model') mesh over the processes."""
    n = world_size()
    if shape is None:
        # split the pow-2 factor across both axes so DP and TP are both live
        p2 = _largest_pow2_divisor(n)
        model = 1
        while model * model < p2:
            model *= 2
        shape = (n // model, model)
    return build_mesh(shape, axis_names, device)


def _largest_pow2_divisor(n: int) -> int:
    p = 1
    while n % (p * 2) == 0:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# Sharding rules (name-path driven)
# ---------------------------------------------------------------------------

# (regex over the param path, spec). First match wins. A spec names the mesh
# axis each logical fp weight axis splits over (None: whole); () replicates.
_RULES = [
    (r"tok_embed$", ("model", None)),          # vocab-sharded embedding
    (r"pos_embed$", (None, None)),
    (r"attn/wqkv$", (None, "model")),          # column parallel (fused QKV)
    (r"attn/w[qkv]$", (None, "model")),        # column parallel
    (r"attn/wo$", ("model", None)),            # row parallel
    (r"mlp/w1$", (None, "model")),
    (r"mlp/b1$", ("model",)),
    (r"mlp/w2$", ("model", None)),
    (r"time_mlp/w1$", (None, "model")),
    (r"time_mlp/b1$", ("model",)),
    (r"time_mlp/w2$", ("model", None)),
    (r"head/w$", (None, None)),
    (r"", ()),                                  # default: replicated
]


def spec_for_path(path_str: str) -> tuple:
    for pattern, spec in _RULES:
        if re.search(pattern, path_str):
            return spec
    return ()


def _parts(path_str: str) -> int:
    """The fused QKV splits each of its three column blocks, so that a rank
    holds whole heads (`tp._split_wqkv`); GSPMD computes the global function
    and splits the columns in one block."""
    return 3 if re.search(r"attn/wqkv$", path_str) else 1


def _slice(a: torch.Tensor, spec, mesh: Mesh, parts: int = 1) -> torch.Tensor:
    for axis, name in enumerate(spec[:a.ndim]):
        if name is not None:
            a = tpm._take(a, axis, mesh.shape[name], mesh.index(name),
                          parts if axis == a.ndim - 1 else 1)
    return a


def _quantized_sharding(qt: QuantizedTensor, spec, mesh: Mesh,
                        parts: int = 1) -> QuantizedTensor:
    """This rank's (data, scale, zero_point) of a quantized weight.

    The packed uint8 data has the same rank as the fp weight (packing
    shrinks the last axis but keeps it), so it takes `spec` directly: a
    shard of the last axis is a shard of its bytes. Group sidecars
    [n_groups, N] follow the weight's axes (the group axis replaces the
    quant axis); channel sidecars split only along `qt.axis`; a tensor
    scale is replicated."""
    spec = tuple(spec) + (None,) * (qt.ndim - len(spec))
    if qt.granularity == "tensor":
        side_spec = ()
    elif qt.granularity == "group":
        side_spec = spec
    else:  # channel: keepdims shape, axis `qt.axis` full, others size 1
        side_spec = tuple(spec[i] if i == qt.axis else None
                          for i in range(qt.ndim))
    shape = tuple(d // mesh.shape[name] if name is not None else d
                  for d, name in zip(qt.shape, spec))
    return dataclasses.replace(
        qt, data=_slice(qt.data, spec, mesh, parts),
        scale=_slice(qt.scale, side_spec, mesh, parts),
        zero_point=_slice(qt.zero_point, side_spec, mesh, parts),
        shape=shape)


def shard_params(params, mesh: Mesh):
    """This rank's leaves of a parameter tree under the rules, on its
    device. A packed `MatmulWeight` or decoded `Int8Weight` splits as
    `tp.shard_tp_params` splits it; the rest slice along their spec."""

    def place(path, leaf):
        pstr = "/".join(path)
        spec = spec_for_path(pstr)
        parts = _parts(pstr)
        if isinstance(leaf, QuantizedTensor):
            leaf = _quantized_sharding(leaf, spec, mesh, parts)
        elif isinstance(leaf, (MatmulWeight, Int8Weight)):
            if "model" in spec:
                axis, tp = spec.index("model"), mesh.shape["model"]
                idx = mesh.index("model")
                leaf = (tpm._split_wqkv(leaf, tp, idx) if parts == 3
                        else tpm._split_weight(leaf, axis, tp, idx))
        elif isinstance(leaf, torch.Tensor) and leaf.ndim > 0:
            if leaf.ndim >= len([a for a in spec if a is not None]):
                leaf = _slice(leaf, spec, mesh, parts)
        return leaf.to(mesh.device) if hasattr(leaf, "to") else leaf

    return map_leaves(place, params)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the leading (batch) axis, split over 'data'."""
    return tpm._take(x, 0, mesh.shape["data"], mesh.index("data")).to(
        mesh.device)


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                 dim: int = 0) -> torch.Tensor:
    """Every rank's blocks of a tensor split along `dim` over `axis`,
    joined in rank order (an `all_gather`; the identity without a process
    group)."""
    group = mesh.group(axis)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def _einsum_attend(li, q, k, v, mask):
    del li
    return dn.attention(q, k, v, mask, flash=False)


def _forward(params, cfg: DiffusionConfig, mesh: Mesh, x, t):
    """The TP forward over 'model' on this rank's rows, through the einsum
    attention (JAX's steps run `flash_attn=False` under GSPMD; no kernel)."""
    return tpm.tp_denoiser_forward(params, cfg, x, t, mesh.shape["model"],
                                   mesh.group("model"),
                                   attend_fn=_einsum_attend)


def make_sharded_infer_step(cfg: DiffusionConfig, mesh: Mesh):
    """infer_step(params_local, x, t) -> eps for this rank's rows (x and t
    from `shard_batch`), TP over 'model'."""

    def infer_step(params, x, t):
        with torch.no_grad():
            return _forward(params, cfg, mesh, x, t)

    return infer_step


def make_sharded_sample_step(cfg: DiffusionConfig, mesh: Mesh,
                             schedule: DiffusionSchedule):
    """run(params_local, generator, batch, seq_len, num_steps) -> this
    rank's rows of the sampled x [batch / dp, seq_len, D]. Every rank draws
    the whole batch's start and noise from `generator` and keeps its rows,
    in `diffusion.sample`'s order, so the rows follow the single-process
    sample from the same generator whatever the mesh."""
    dp, d = mesh.shape["data"], mesh.index("data")

    def run(params, generator, batch: int, seq_len: int, num_steps: int):
        if batch % dp:
            raise ValueError(f"batch {batch} not divisible by data axis {dp}")
        shape = (batch, seq_len, cfg.hidden_size)
        rows = slice(d * (batch // dp), (d + 1) * (batch // dp))
        dev = schedule.betas.device

        def draw():
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=dev)[rows]

        with torch.no_grad():
            x = draw()
            for t_scalar in respaced_timesteps(schedule.num_timesteps,
                                               num_steps):
                t_vec = torch.full((x.shape[0],), t_scalar,
                                   dtype=torch.int64, device=dev)
                eps = _forward(params, cfg, mesh, x, t_vec)
                x = p_sample(schedule, x, t_vec, eps, noise=draw())
        return x

    return run


def make_sharded_train_step(cfg: DiffusionConfig, mesh: Mesh,
                            schedule: DiffusionSchedule, lr: float = 1e-4):
    """train_step(params_local, x0, t, noise) -> (new params_local, loss):
    the `p_losses` gradient through the TP forward, averaged over 'data'
    (the batch mean of the global loss), then an SGD step. Leaves that are
    not floating tensors (quantized layouts) and leaves the loss does not
    reach keep their value. `loss` is the global batch mean."""
    dp, group = mesh.shape["data"], mesh.group("data")

    def train_step(params, x0, t, noise):
        leaves, paths = [], []

        def mark(path, leaf):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                leaf = leaf.detach().requires_grad_()
                leaves.append(leaf)
                paths.append(path)
            return leaf

        live = map_leaves(mark, params)
        loss = p_losses(lambda x, tt: _forward(live, cfg, mesh, x, tt),
                        schedule, x0, t, noise).mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        new = {}
        for path, p, g in zip(paths, leaves, grads):
            if g is None:
                continue
            if group is not None:
                dist.all_reduce(g, group=group)
            new[path] = (p.detach() - lr * (g / dp)).to(p.dtype)
        loss = loss.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
        updated = map_leaves(
            lambda path, leaf: new.get(path, leaf.detach()
                                       if isinstance(leaf, torch.Tensor)
                                       else leaf), params)
        return updated, loss / dp

    return train_step

