"""Megatron tensor parallelism over the mesh's 'model' axis, quantized
weights included.

Counterpart of `diffusion_llm_rs_tpu/parallel/tp.py`. Each rank of the
'model' group holds its own shard of every weight and runs the denoiser on
it:

  - wqkv / mlp.w1 / time_mlp.w1 split by columns (a rank owns H/tp heads and
    M/tp MLP features): a local matmul, no collective
  - attention is head-local
  - wo / mlp.w2 / time_mlp.w2 split by rows: a local matmul, then an
    `all_reduce` over the group (JAX's `psum`)
  - layer norms, embeddings and the head replicated

`shard_tp_params` splits a parameter tree into the ranks' local trees. A
packed `MatmulWeight` splits its packed data and its scale, zero-point and
column-scale sidecars on the same logical axis; a row split that cuts a
quantization group requantizes the rank's rows at the largest group size
that divides them. A decoded `Int8Weight` splits its data and keeps (rows)
or splits (columns) its column scales. Each rank's shards run the same
kernels as the unsharded model: `linear` sends a `MatmulWeight` shard to
the packed GEMM (or `matmul_a8` at act_bits=8) and an `Int8Weight` shard to
`int8w_matmul`.

The backward of the forward is Megatron's: the input of each column-split
region passes through `_CopyToModel` (identity forward, `all_reduce`
backward), the output of each row-split one through `_ReduceFromModel`
(`all_reduce` forward, identity backward). A replicated loss then gives
every rank the full gradient of its shards and of the replicated leaves,
once.
"""

from __future__ import annotations

import math
from typing import Any, List

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import MatmulWeight, prepare
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight, linear
from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                   map_leaves, quantize)


def _take(a: torch.Tensor, axis: int, n: int, i: int,
          parts: int = 1) -> torch.Tensor:
    """Shard i of n along `axis`, taken from each of `parts` equal blocks of
    the axis (the [Q | K | V] thirds of a fused projection) and joined."""
    size = a.shape[axis]
    if size % (parts * n):
        raise ValueError(f"axis {axis} of size {size} does not split into "
                         f"{parts} x {n} shards")
    block, loc = size // parts, size // (parts * n)
    pieces = [a.narrow(axis, p * block + i * loc, loc) for p in range(parts)]
    return (pieces[0] if parts == 1 else torch.cat(pieces, dim=axis)
            ).contiguous()


def _repack_levels(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """[K, N] uint8 levels -> block-packed data (the inverse of
    `MatmulWeight.levels()`, JAX's `_unpack_levels`)."""
    vpb = 8 // bits
    lp = levels.reshape(vpb, levels.shape[0] // vpb, levels.shape[1])
    acc = lp[0].to(torch.int32)
    for s in range(1, vpb):
        acc = acc | (lp[s].to(torch.int32) << (s * bits))
    return acc.to(torch.uint8)


def _split_weight(w, axis: int, tp: int, idx: int):
    """Shard `idx` of a weight along `axis` (tensor, MatmulWeight or
    Int8Weight)."""
    if isinstance(w, Int8Weight):
        if axis == 1:
            return Int8Weight(_take(w.data, 1, tp, idx),
                              _take(w.col_scale, 1, tp, idx))
        # a K shard keeps the full-column grid, as a MatmulWeight's does
        return Int8Weight(_take(w.data, 0, tp, idx), w.col_scale)
    if not isinstance(w, MatmulWeight):
        return _take(w, axis, tp, idx)
    if axis == 1:  # column shard: N of the data and of every sidecar
        def cols(a):
            return None if a is None else _take(a, 1, tp, idx)
        return MatmulWeight(data=cols(w.data), scale=cols(w.scale),
                            zero_point=cols(w.zero_point), bits=w.bits,
                            K=w.K, N=w.N // tp, group_size=w.group_size,
                            act_bits=w.act_bits, col_scale=cols(w.col_scale))
    # row shard (split K): the data is block-packed along K, so take the
    # levels' rows and pack them again
    k_loc = w.K // tp
    if k_loc % (8 // w.bits):
        raise ValueError(f"local K {k_loc} not packable at {w.bits} bits")
    if k_loc % w.group_size == 0:
        # groups align with the shard boundary: the sidecars slice exactly;
        # a K shard keeps the full-column grid (the global col_scale still
        # bounds |levels| <= 127)
        return MatmulWeight(
            data=_repack_levels(_take(w.levels(), 0, tp, idx), w.bits),
            scale=_take(w.scale, 0, tp, idx),
            zero_point=_take(w.zero_point, 0, tp, idx), bits=w.bits,
            K=k_loc, N=w.N, group_size=w.group_size, act_bits=w.act_bits,
            col_scale=w.col_scale)
    # groups straddle the boundary: requantize the local rows with a group
    # size that divides them (values unchanged up to re-rounding)
    g_new = math.gcd(w.group_size, k_loc)
    local_fp = _take(w.dequantize(), 0, tp, idx)
    qt = quantize(local_fp, w.bits, granularity="group", group_size=g_new,
                  axis=0)
    return prepare(qt, act_bits=w.act_bits)


def _split_wqkv(w, tp: int, idx: int):
    """The fused QKV [K, 3D] columns are [Q | K | V]: a rank's heads need
    its columns of each third, split apart and joined again."""
    if isinstance(w, Int8Weight):
        return Int8Weight(_take(w.data, 1, tp, idx, 3),
                          _take(w.col_scale, 1, tp, idx, 3))
    if not isinstance(w, MatmulWeight):
        return _take(w, 1, tp, idx, 3)

    def cols(a):
        return None if a is None else _take(a, 1, tp, idx, 3)
    return MatmulWeight(data=cols(w.data), scale=cols(w.scale),
                        zero_point=cols(w.zero_point), bits=w.bits, K=w.K,
                        N=w.N // tp, group_size=w.group_size,
                        act_bits=w.act_bits, col_scale=cols(w.col_scale))


_COLUMN = ("mlp/w1", "time_mlp/w1")
_COLUMN_BIAS = ("mlp/b1", "time_mlp/b1")
_ROW = ("attn/wo", "mlp/w2", "time_mlp/w2")


def local_tp_params(params, tp: int, idx: int):
    """Rank `idx`'s tree of a `tp`-way Megatron split."""

    def go(path, leaf):
        # a raw QuantizedTensor is packed along N: slicing its bytes as
        # columns (and keeping its global shape) would corrupt the shard
        if isinstance(leaf, QuantizedTensor):
            raise TypeError(
                "shard_tp_params cannot split a raw QuantizedTensor — "
                "run int8_matmul.prepare() (or decode_to_int8) on the tree "
                "first so packed data + sidecars split together")
        pstr = "/".join(path)
        if "attn/wqkv" in pstr:
            return _split_wqkv(leaf, tp, idx)
        if any(s in pstr for s in _COLUMN):
            return _split_weight(leaf, 1, tp, idx)
        if any(s in pstr for s in _COLUMN_BIAS + _ROW):
            return _split_weight(leaf, 0, tp, idx)
        return leaf

    return map_leaves(go, params)


def shard_tp_params(params, tp: int) -> List[Any]:
    """The `tp` local parameter trees (Megatron split; quantized-aware)."""
    return [local_tp_params(params, tp, i) for i in range(tp)]


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all_reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all_reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _LeadBias(torch.autograd.Function):
    """A row-split layer's bias on model rank 0, zeros elsewhere; the
    gradient passes through on every rank (each rank's upstream gradient is
    the whole one), so every copy of the replicated bias gets all of it."""

    @staticmethod
    def forward(ctx, b, lead):
        return b.view_as(b) if lead else torch.zeros_like(b)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _row_bias(b, lead: bool):
    if b is None:
        return None
    if torch.is_grad_enabled() and b.requires_grad:
        return _LeadBias.apply(b, lead)
    return b if lead else None


def _copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, group)


def _reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def tp_denoiser_forward(params_local, cfg: DiffusionConfig, x: torch.Tensor,
                        t: torch.Tensor, tp: int, group=None, attend_fn=None):
    """Megatron-TP forward on this rank's shards; `all_reduce` over `group`
    (the 'model' group; None on one process: the identity) after each
    row-split matmul.

    Mirrors `models.denoiser.denoiser_forward` with H/tp local heads. A
    row-split layer's bias (b2 of the MLP and of the time MLP) is added
    once, by model rank 0's matmul before the reduce (the other ranks'
    zero bias carries its gradient), where JAX adds it after the psum
    (`tp.py:223`): the sum is the same, and on a group of one the forward
    is `denoiser_forward`'s, bit for bit, over plain and packed weights.

    `attend_fn(layer_idx, q, k, v, mask)` (all [B, S, H_local, Hd]) takes
    the place of attention: the sharded paged batcher runs the paged-KV
    kernel there on the rank's own heads."""
    B, S, D = x.shape
    if cfg.num_attention_heads % tp:
        # a non-dividing tp would regroup head boundaries (each shard's
        # D//tp columns mixing fractions of heads under a wrong softmax
        # scale) and give a wrong output with no error
        raise ValueError(f"num_attention_heads {cfg.num_attention_heads} "
                         f"not divisible by tp {tp}")
    if S > cfg.max_sequence_length:
        raise ValueError(
            f"sequence length {S} exceeds max_sequence_length "
            f"{cfg.max_sequence_length}")
    H_local = cfg.num_attention_heads // tp
    dtype = x.dtype
    lead = group is None or dist.get_rank(group) == 0

    temb = dn.timestep_embedding(t, D)
    tm = params_local["time_mlp"]
    t_in = linear(_copy_to(temb.to(dtype), group), tm["w1"], tm["b1"],
                  activation="gelu")
    temb = _reduce_from(linear(t_in, tm["w2"], _row_bias(tm["b2"], lead)),
                        group)
    h = x + params_local["pos_embed"][:S].to(dtype)[None] + temb[:, None, :]

    for li, blk in enumerate(params_local["blocks"]):
        hn = _copy_to(dn.layer_norm(h, blk["ln1"]), group)
        a = blk["attn"]
        qkv = linear(hn, a["wqkv"])  # [B, S, 3*D/tp]: the local heads
        d_loc = qkv.shape[-1] // 3
        q = dn._split_heads(qkv[..., :d_loc], H_local)
        k = dn._split_heads(qkv[..., d_loc:2 * d_loc], H_local)
        v = dn._split_heads(qkv[..., 2 * d_loc:], H_local)
        if attend_fn is not None:
            attn_out = attend_fn(li, q, k, v, None).to(dtype)
        else:
            attn_out = dn.attention(q, k, v)
        h = h + _reduce_from(linear(attn_out.reshape(B, S, d_loc), a["wo"]),
                             group)

        hn = _copy_to(dn.layer_norm(h, blk["ln2"]), group)
        m = blk["mlp"]
        inner = linear(hn, m["w1"], m["b1"], activation="gelu")
        h = h + _reduce_from(linear(inner, m["w2"], _row_bias(m["b2"], lead)),
                             group)

    h = dn.layer_norm(h, params_local["ln_f"])
    return linear(h, params_local["head"]["w"])


def to_device(tree, device):
    """Every leaf of a parameter tree (tensor or quantized layout) moved to
    `device`."""
    return map_leaves(lambda _, l: l.to(device) if hasattr(l, "to") else l,
                      tree)


def place_tp_params(params, mesh):
    """This rank's Megatron shard of `params` on its device (JAX stacks
    every shard on a leading 'model' axis; here each rank holds its own)."""
    tp = mesh.shape["model"]
    return to_device(local_tp_params(params, tp, mesh.index("model")),
                     mesh.device)


def make_tp_forward(cfg: DiffusionConfig, mesh, axis_name: str = "model"):
    """TP forward over `axis_name`: run(params_local, x, t) with x and t
    replicated (split the batch over 'data' outside for DP x TP); the
    output is replicated over the group."""
    tp = mesh.shape[axis_name]
    group = mesh.group(axis_name)

    def run(params_local, x, t):
        with torch.no_grad():
            return tp_denoiser_forward(params_local, cfg, x, t, tp, group)

    return run
