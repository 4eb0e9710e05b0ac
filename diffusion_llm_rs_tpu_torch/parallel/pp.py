"""Pipeline parallelism: the GPipe ring over a 'stage' mesh axis.

Counterpart of `diffusion_llm_rs_tpu/parallel/pp.py`. The transformer
blocks are split into contiguous stages, one a rank, and microbatch
activations go stage to stage (`batch_isend_irecv`, JAX's `ppermute`), one
hop a tick. With M microbatches and K stages the loop runs M + K - 1 ticks;
stage s works on microbatch (tick - s) when that index exists and idles in
the bubble (JAX computes and masks the idle ticks; a rank here skips them,
with the same result). The embedding and timestep injection run before the
pipeline and the final LN and head after it, on every rank: only the block
stack is staged. The last stage's outputs reach every rank through an
`all_reduce` of the outputs masked to that stage (JAX's psum broadcast).
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.ops.matmul import linear
from diffusion_llm_rs_tpu_torch.parallel import mesh as pm
from diffusion_llm_rs_tpu_torch.parallel.sp import shift
from diffusion_llm_rs_tpu_torch.parallel.tp import to_device


def make_stage_mesh(n_stages: int = None, axis_name: str = "stage",
                    device="cuda") -> pm.Mesh:
    """1-D mesh over every process (`n_stages` checks its size)."""
    return pm.build_mesh((n_stages or pm.world_size(),), (axis_name,), device)


def stack_stage_params(params: Any, n_stages: int) -> List[List[Any]]:
    """`params['blocks']` in `n_stages` contiguous groups, stage by stage
    (JAX stacks each leaf on a leading stage axis; here the groups stay a
    list, one for each rank)."""
    blocks = params["blocks"]
    L = len(blocks)
    if L % n_stages:
        raise ValueError(f"{L} blocks not divisible by {n_stages} stages")
    per = L // n_stages
    return [blocks[s * per:(s + 1) * per] for s in range(n_stages)]


def place_stage_params(stacked: List[List[Any]], mesh: pm.Mesh,
                       axis_name: str = "stage") -> List[Any]:
    """This rank's stage of blocks, on its device."""
    if len(stacked) != mesh.shape[axis_name]:
        raise ValueError(
            f"stage_blocks stacked for {len(stacked)} stages but mesh "
            f"'{axis_name}' has {mesh.shape[axis_name]} ranks")
    return to_device(stacked[mesh.index(axis_name)], mesh.device)


def _apply_blocks(blocks_local, cfg: DiffusionConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """Run this stage's blocks over h [B, S, D]."""
    B, S, D = h.shape
    H = cfg.num_attention_heads
    for blk in blocks_local:
        hn = dn.layer_norm(h, blk["ln1"])
        a = blk["attn"]
        qkv = linear(hn, a["wqkv"])
        q = dn._split_heads(qkv[..., :D], H)
        k = dn._split_heads(qkv[..., D:2 * D], H)
        v = dn._split_heads(qkv[..., 2 * D:], H)
        attn_out = dn.attention(q, k, v)
        h = h + linear(attn_out.reshape(B, S, D), a["wo"])
        hn = dn.layer_norm(h, blk["ln2"])
        m = blk["mlp"]
        h = h + linear(linear(hn, m["w1"], m["b1"], activation="gelu"),
                       m["w2"], m["b2"])
    return h


def pipeline_blocks(stage_blocks, cfg: DiffusionConfig,
                    h_micro: torch.Tensor, group, n_stages: int,
                    stage: int) -> torch.Tensor:
    """The GPipe tick loop on this rank (stage `stage` of `n_stages`).

    h_micro: [n_micro, Bm, S, D] post-embedding activations, whole on every
    rank. Returns every microbatch through all the blocks, on every rank."""
    n_micro = h_micro.shape[0]
    ticks = n_micro + n_stages - 1
    state = torch.zeros_like(h_micro[0])
    outputs = torch.zeros_like(h_micro)
    for tick in range(ticks):
        if stage == 0 and tick < n_micro:
            state = h_micro[tick]          # stage 0 takes in microbatch tick
        mb = tick - stage                  # the microbatch this stage holds
        worked = state
        if 0 <= mb < n_micro:
            worked = _apply_blocks(stage_blocks, cfg, state)
            if stage == n_stages - 1:      # the last stage emits it
                outputs[mb] = worked
        if n_stages > 1:                   # one hop: each stage to the next
            (state,), reqs = shift((worked,), group, n_stages)
            for r in reqs:
                r.wait()
    # the results live on the last stage: broadcast them to every rank
    if stage != n_stages - 1:
        outputs.zero_()
    if group is not None:
        dist.all_reduce(outputs, group=group)
    return outputs


def make_pp_forward(cfg: DiffusionConfig, mesh: pm.Mesh, n_micro: int,
                    axis_name: str = "stage"):
    """Pipeline-parallel denoiser forward: run(params, stage_blocks, x, t)
    with the whole tree (embeddings and head used on every rank; its blocks
    are not read) and this rank's `place_stage_params`; x and t whole on
    every rank. The batch B splits into `n_micro` microbatches."""
    n_stages, group = mesh.shape[axis_name], mesh.group(axis_name)
    stage = mesh.index(axis_name)

    def run(params, stage_blocks, x, t):
        B, S, D = x.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by {n_micro}")
        if S > cfg.max_sequence_length:
            raise ValueError(
                f"sequence length {S} exceeds max_sequence_length "
                f"{cfg.max_sequence_length}")
        dtype = x.dtype
        with torch.no_grad():
            temb = dn.timestep_embedding(t, D)
            tm = params["time_mlp"]
            temb = linear(linear(temb.to(dtype), tm["w1"], tm["b1"],
                                 activation="gelu"), tm["w2"], tm["b2"])
            h = x + params["pos_embed"][:S].to(dtype)[None] \
                + temb[:, None, :]
            out = pipeline_blocks(stage_blocks, cfg,
                                  h.reshape(n_micro, B // n_micro, S, D),
                                  group, n_stages, stage)
            h = dn.layer_norm(out.reshape(B, S, D), params["ln_f"])
            return linear(h, params["head"]["w"])

    return run
