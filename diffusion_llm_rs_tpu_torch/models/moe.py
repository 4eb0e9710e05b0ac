"""Mixture-of-experts denoiser variant and expert parallelism.

Counterpart of `diffusion_llm_rs_tpu/models/moe.py`. Each block's MLP is a
top-1-routed bank of experts (GShard dispatch): a router picks each token's
expert, the tokens are packed into capacity-bounded slots of an [E, C, D]
buffer, the experts run as batched f32 products over [E, C, .], and the
results go back to their tokens scaled by the router's gate. A token past
its expert's capacity falls through the residual (first come, first kept).

Expert parallelism splits the expert banks' leading E axis over an
'expert' mesh axis and the batch over the same ranks. JAX's GSPMD inserts
the all-to-all pair from the [E, C, D] sharding constraints; here each rank
issues it: its tokens' slots of the [E, C, D] buffer go to the ranks that
own those experts (`all_to_all_single`), the experts run on the rank's own
E/n, and every expert's results come back (`all_to_all_single` again). The
capacity C and the drop order are those of the whole batch: a rank's slot
positions start after the earlier ranks' tokens (an `all_gather` of the
per-expert counts), so the sharded forward drops the tokens the unsharded
one drops.

The expert products are f32 einsums, as in JAX (XLA outside any Pallas
kernel); the attention and the other linears go through `linear` and
`denoiser.attention`, so decoded int8 projections run `int8w_matmul` and
attention at S >= 1024 runs the `dense_attention` kernel. `quantize_tree`
would pack the 3-D expert banks, which `moe_mlp` reads as arrays: quantize
a MoE tree with `exclude=("pos_embed", "moe")`.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.ops.matmul import linear
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import gelu_tanh
from diffusion_llm_rs_tpu_torch.parallel import mesh as pm
from diffusion_llm_rs_tpu_torch.parallel import tp as tpm
from diffusion_llm_rs_tpu_torch.quant.core import map_leaves

Params = Dict[str, Any]

_BANK_KEYS = ("w1", "b1", "w2", "b2")


def init_moe_denoiser_params(generator: torch.Generator, cfg: DiffusionConfig,
                             num_experts: int) -> Params:
    """Denoiser parameters with each block's MLP replaced by an expert bank
    (N(0, 1) draws scaled as in the JAX package, from `generator`)."""
    params = dn.init_denoiser_params(generator, cfg)
    D = cfg.hidden_size
    M = cfg.mlp_ratio * D
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * scale

    for blk in params["blocks"]:
        blk.pop("mlp")
        blk["moe"] = {
            "router": normal((D, num_experts), 0.02),
            "w1": normal((num_experts, D, M), 0.02),
            "b1": torch.zeros((num_experts, M), device=dev),
            "w2": normal((num_experts, M, D), out_scale),
            "b2": torch.zeros((num_experts, D), device=dev),
        }
    return params


def load_balancing_loss(gates: torch.Tensor, expert: torch.Tensor,
                        group=None) -> torch.Tensor:
    """GShard/Switch auxiliary load-balancing loss E * sum_e f_e * P_e: f_e
    the fraction of tokens dispatched to expert e, P_e the mean router
    probability of e; 1 at a uniform assignment. With `group`, the tokens
    are every rank's (sums all-reduced)."""
    E = gates.shape[-1]
    stats = torch.stack([
        torch.nn.functional.one_hot(expert, E).to(torch.float32).sum(0),
        gates.to(torch.float32).sum(0),
        torch.full((E,), float(gates.shape[0]), device=gates.device)])
    if group is not None:
        dist.all_reduce(stats, group=group)
    frac, prob = stats[0] / stats[2], stats[1] / stats[2]
    return E * torch.sum(frac * prob)


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """gelu(xe @ w1 + b1) @ w2 + b2 per expert, in f32; xe [E, C, D]."""
    he = gelu_tanh(torch.einsum("ecd,edm->ecm", xe, p["w1"].to(torch.float32))
                   + p["b1"][:, None, :].to(torch.float32))
    return torch.einsum("ecm,emd->ecd", he, p["w2"].to(torch.float32)) \
        + p["b2"][:, None, :].to(torch.float32)


def _exchange(xe: torch.Tensor, group, n: int) -> torch.Tensor:
    """The all-to-all pair around the expert products: this rank's slots of
    [E, C, D] go to the ranks owning each block of E/n experts; the blocks
    received (disjoint slots) sum to the rank's experts' full [E/n, C, D]."""
    out = torch.empty_like(xe)
    dist.all_to_all_single(out, xe.contiguous(), group=group)
    E, C, D = xe.shape
    return out.reshape(n, E // n, C, D).sum(0)


def _gather_experts(ye: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's [E/n, C, D] results to every rank, as [E, C, D]."""
    out = torch.empty((n,) + tuple(ye.shape), dtype=ye.dtype,
                      device=ye.device)
    dist.all_to_all_single(out, ye.unsqueeze(0).expand(n, *ye.shape)
                           .contiguous(), group=group)
    return out.reshape((-1,) + tuple(ye.shape[1:]))


def moe_mlp(p: Params, h: torch.Tensor, capacity_factor: float = 1.25,
            ep_group=None, return_aux: bool = False,
            dispatch: str = "auto"):
    """Top-1 routed expert MLP over h [B, S, D].

    Two dispatches with the same result (first-come-first-kept drop order):
      - "dense": the GShard one-hot dispatch tensor [T, E, C], two einsums,
        O(T * E*C * D);
      - "sorted": tokens stably sorted by expert, positions within each
        expert from segment offsets, kept rows scattered into an [E*C + 1,
        D] buffer (row E*C takes the dropped ones) and gathered back:
        O(T log T + T D).
    "auto" takes sorted once E*C > 8*D.

    With `ep_group` (the 'expert' group of n ranks, each holding E/n
    experts' banks and its own tokens), the capacity is the whole batch's
    and the [E, C, D] buffer crosses the group around the products. With
    return_aux, also returns `load_balancing_loss`."""
    B, S, D = h.shape
    E = p["router"].shape[1]
    n = 1 if ep_group is None else dist.get_world_size(ep_group)
    T = B * S
    C = max(1, int(math.ceil(capacity_factor * T * n / E)))
    dtype = h.dtype
    x = h.reshape(T, D)

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                  # [T, E]
    gate, expert = torch.max(gates, dim=-1)                # first max wins
    counts = torch.bincount(expert, minlength=E)
    if ep_group is None:
        start = torch.zeros_like(counts)
    else:
        # the earlier ranks' tokens come first in the global order
        every = [torch.empty_like(counts) for _ in range(n)]
        dist.all_gather(every, counts, group=ep_group)
        start = sum(every[:dist.get_rank(ep_group)], torch.zeros_like(counts))

    if dispatch == "auto":
        dispatch = "sorted" if E * C > 8 * D else "dense"

    if dispatch == "sorted":
        order = torch.argsort(expert, stable=True)                # [T]
        sorted_e = expert[order]
        offsets = torch.cumsum(counts, 0) - counts               # exclusive
        seg_pos = (torch.arange(T, device=x.device) - offsets[sorted_e]
                   + start[sorted_e])
        kept = seg_pos < C
        # dropped tokens scatter to a trash row E*C
        dest = torch.where(kept,
                           sorted_e * C + torch.clamp(seg_pos, max=C - 1),
                           E * C)
        xe_flat = torch.zeros((E * C + 1, D), dtype=torch.float32,
                              device=x.device)
        xe_flat[dest] = x[order].to(torch.float32)
        xe = xe_flat[:-1].reshape(E, C, D)
    else:
        onehot = torch.nn.functional.one_hot(expert, E).to(torch.float32)
        pos = torch.cumsum(onehot, dim=0) - 1.0 + start.to(torch.float32)
        keep = (pos < C) * onehot                                 # [T, E]
        slot = torch.clamp(torch.sum(pos * onehot, dim=-1), 0,
                           C - 1).to(torch.int64)
        # dispatch tensor [T, E, C]: token t -> (its expert, its slot)
        de = keep[:, :, None] * torch.nn.functional.one_hot(
            slot, C).to(torch.float32)[:, None, :]
        xe = torch.einsum("tec,td->ecd", de, x.to(torch.float32))

    if ep_group is None:
        ye = _experts(p, xe)
    else:
        ye = _gather_experts(_experts(p, _exchange(xe, ep_group, n)),
                             ep_group, n)

    if dispatch == "sorted":
        ye_flat = torch.cat([ye.reshape(E * C, D),
                             torch.zeros((1, D), dtype=ye.dtype,
                                         device=ye.device)])
        y_sorted = ye_flat[dest]                                  # [T, D]
        inv = torch.argsort(order, stable=True)
        y = y_sorted[inv] * gate[:, None]
    else:
        y = torch.einsum("tec,ecd->td", de, ye) * gate[:, None]
    out = y.reshape(B, S, D).to(dtype)
    if return_aux:
        return out, load_balancing_loss(gates, expert, ep_group)
    return out


def moe_denoiser_forward(params: Params, cfg: DiffusionConfig,
                         x: torch.Tensor, t: torch.Tensor,
                         capacity_factor: float = 1.25, ep_group=None,
                         dispatch: str = "auto") -> torch.Tensor:
    """Transformer denoiser forward with MoE MLPs: `denoiser_forward`'s
    blocks (pre-LN, attention, eps head) with `moe_mlp` in place of the
    MLP. With `ep_group`, x is this rank's rows of the batch."""
    B, S, D = x.shape
    if S > cfg.max_sequence_length:
        raise ValueError(
            f"sequence length {S} exceeds max_sequence_length "
            f"{cfg.max_sequence_length}")
    H = cfg.num_attention_heads
    dtype = x.dtype

    temb = dn.timestep_embedding(t, D)
    tm = params["time_mlp"]
    temb = linear(linear(temb.to(dtype), tm["w1"], tm["b1"],
                         activation="gelu"), tm["w2"], tm["b2"])
    h = x + params["pos_embed"][:S].to(dtype)[None] + temb[:, None, :]

    for blk in params["blocks"]:
        hn = dn.layer_norm(h, blk["ln1"])
        a = blk["attn"]
        qkv = linear(hn, a["wqkv"])
        q = dn._split_heads(qkv[..., :D], H)
        k = dn._split_heads(qkv[..., D:2 * D], H)
        v = dn._split_heads(qkv[..., 2 * D:], H)
        attn_out = dn.attention(q, k, v)
        h = h + linear(attn_out.reshape(B, S, D), a["wo"])

        hn = dn.layer_norm(h, blk["ln2"])
        h = h + moe_mlp(blk["moe"], hn, capacity_factor, ep_group,
                        dispatch=dispatch)

    h = dn.layer_norm(h, params["ln_f"])
    return linear(h, params["head"]["w"])


def make_expert_mesh(n_devices: int = None, axis_name: str = "expert",
                     device="cuda") -> pm.Mesh:
    """1-D mesh over every process (`n_devices` checks its size)."""
    return pm.build_mesh((n_devices or pm.world_size(),), (axis_name,), device)


def place_ep_params(params: Params, mesh: pm.Mesh,
                    axis_name: str = "expert") -> Params:
    """This rank's block of E/n experts of every expert bank, everything
    else whole, on the rank's device."""
    n, i = mesh.shape[axis_name], mesh.index(axis_name)

    def place(path, leaf):
        if "moe" in path and path[-1] in _BANK_KEYS:
            leaf = tpm._take(leaf, 0, n, i)
        return leaf.to(mesh.device) if hasattr(leaf, "to") else leaf

    return map_leaves(place, params)


def make_ep_forward(cfg: DiffusionConfig, mesh: pm.Mesh,
                    axis_name: str = "expert", capacity_factor: float = 1.25,
                    dispatch: str = "auto"):
    """Expert-parallel MoE forward: run(params_local, x, t) with x and t
    replicated; each rank runs its rows of the batch (B divisible by the
    axis), the expert buffers cross the group around the products, and the
    output is gathered back, replicated."""
    n, group = mesh.shape[axis_name], mesh.group(axis_name)
    idx = mesh.index(axis_name)

    def run(params, x, t):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} expert ranks")
        rows = slice(idx * (B // n), (idx + 1) * (B // n))
        with torch.no_grad():
            eps = moe_denoiser_forward(params, cfg, x[rows], t[rows],
                                       capacity_factor, group, dispatch)
            return pm.gather_batch(eps, mesh, axis_name)

    return run
