"""Sequence parallelism: ring attention over a 'seq' mesh axis.

Counterpart of `diffusion_llm_rs_tpu/parallel/sp.py`. The sequence axis is
split over the ring; each rank keeps its Q block and accumulates an
online-softmax partial while the K/V blocks travel rank to rank
(`batch_isend_irecv`, JAX's `ppermute`). No rank holds the whole [S, S]
logits or the whole K/V, so the longest sequence grows with the ring.
Diffusion attends bidirectionally over the whole sequence every step, so
every hop carries work.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.ops.matmul import linear
from diffusion_llm_rs_tpu_torch.parallel import mesh as pm
from diffusion_llm_rs_tpu_torch.parallel import tp as tpm


def make_seq_mesh(n_devices: int = None, axis_name: str = "seq",
                  device="cuda") -> pm.Mesh:
    """1-D mesh over every process (`n_devices` checks its size)."""
    return pm.build_mesh((n_devices or pm.world_size(),), (axis_name,), device)


def shift(tensors, group, ring_size: int):
    """Start sending each tensor to the ring's next rank and receiving the
    previous rank's into a fresh buffer (JAX's `ppermute` j -> j + 1).
    Returns (the buffers, the requests to wait on)."""
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % ring_size)
    prv = dist.get_global_rank(group, (me - 1) % ring_size)
    bufs = [torch.empty_like(x) for x in tensors]
    ops = []
    for x, buf in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
    return bufs, dist.batch_isend_irecv(ops)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, ring_size: int) -> torch.Tensor:
    """Bidirectional attention with K/V going round the ring.

    q/k/v are this rank's sequence blocks [B, S_loc, H, Hd]; the result is
    attention over the whole sequence. Online softmax (running max `m`,
    normalizer `l`, weighted accumulator) in f32; each of the `ring_size`
    iterations sends the resident K/V block on before its attention math,
    which does not depend on the transfer, so the hop overlaps the math.
    The last hop is skipped: nothing would read it."""
    Hd = q.shape[-1]
    scale = 1.0 / math.sqrt(Hd)
    qf = q.to(torch.float32)
    B, S_loc, H, _ = q.shape
    acc = torch.zeros((B, S_loc, H, Hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, S_loc, H), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S_loc, H), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(ring_size):
        if step + 1 < ring_size:
            (k_nxt, v_nxt), reqs = shift((k_cur, v_cur), group, ring_size)
        logits = torch.einsum("bshd,bthd->bsht", qf,
                              k_cur.to(torch.float32)) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bsht,bthd->bshd", p, v_cur.to(torch.float32))
        m = m_new
        if step + 1 < ring_size:
            for r in reqs:
                r.wait()
            k_cur, v_cur = k_nxt, v_nxt
    return (acc / l[..., None]).to(q.dtype)


def sp_denoiser_forward(params: Any, cfg: DiffusionConfig, x: torch.Tensor,
                        t: torch.Tensor, group, ring_size: int,
                        ring_index: int) -> torch.Tensor:
    """Denoiser forward on this rank's sequence block x [B, S_loc, D].

    Weights are whole on every rank; every op but attention is per token,
    so only attention needs the ring. The positional embeddings are this
    block's rows (by ring index)."""
    B, S_loc, D = x.shape
    H = cfg.num_attention_heads
    dtype = x.dtype

    pos = params["pos_embed"][ring_index * S_loc:(ring_index + 1) * S_loc]
    temb = dn.timestep_embedding(t, D)
    tm = params["time_mlp"]
    temb = linear(linear(temb.to(dtype), tm["w1"], tm["b1"],
                         activation="gelu"), tm["w2"], tm["b2"])
    h = x + pos.to(dtype)[None] + temb[:, None, :]

    for blk in params["blocks"]:
        hn = dn.layer_norm(h, blk["ln1"])
        a = blk["attn"]
        qkv = linear(hn, a["wqkv"])
        q = dn._split_heads(qkv[..., :D], H)
        k = dn._split_heads(qkv[..., D:2 * D], H)
        v = dn._split_heads(qkv[..., 2 * D:], H)
        attn_out = ring_attention(q, k, v, group, ring_size)
        h = h + linear(attn_out.reshape(B, S_loc, D), a["wo"])

        hn = dn.layer_norm(h, blk["ln2"])
        mlp = blk["mlp"]
        h = h + linear(linear(hn, mlp["w1"], mlp["b1"], activation="gelu"),
                       mlp["w2"], mlp["b2"])

    h = dn.layer_norm(h, params["ln_f"])
    return linear(h, params["head"]["w"])


def make_sp_forward(cfg: DiffusionConfig, mesh: pm.Mesh,
                    axis_name: str = "seq"):
    """SP forward: run(params, x, t) with x [B, S, D] and t whole on every
    rank; each rank runs its block of S / ring positions, and the blocks are
    gathered back into the whole sequence. S must divide by the ring."""
    ring, group = mesh.shape[axis_name], mesh.group(axis_name)
    idx = mesh.index(axis_name)

    def run(params, x, t):
        S = x.shape[1]
        if S % ring:
            raise ValueError(f"seq len {S} not divisible by ring size {ring}")
        if S > cfg.max_sequence_length:
            # beyond max_seq the upper blocks would read positional rows
            # that do not exist
            raise ValueError(
                f"sequence length {S} exceeds max_sequence_length "
                f"{cfg.max_sequence_length}")
        with torch.no_grad():
            out = sp_denoiser_forward(params, cfg, tpm._take(x, 1, ring, idx),
                                      t, group, ring, idx)
            return pm.gather_batch(out, mesh, axis_name, dim=1)

    return run
