"""Attention kernels of the denoiser: dense bf16 flash attention, and flash
attention that reads per-token-quantized K/V without dequantizing it.

Counterpart of `diffusion_llm_rs_tpu/ops/pallas_attention.py`:
  - `dense_attention` (TPU kernel `_dense_kernel`): q/k/v [BH, S, D] -> [BH,
    Sq, D], online softmax over KV tiles, bf16 operands, P rounded to bf16
    before P.V, f32 accumulation. Kernel: `csrc/dense_attention.cu`.
    `flash_fold` wraps it in `DenseAttention`, an autograd Function whose
    backward is JAX's `_flash_fold` VJP (f32 softmax-attention gradients).
  - `QuantKV`, `quantize_kv` and `attention` (TPU kernel `_attn_kernel`): K
    and V [BH, S, D] quantized per token at 8/4/2/1 bits, block-packed along
    D; the affine terms fold into row corrections, so both products run on
    the integer levels. Kernel: `csrc/quant_flash_contig.cu` (the design
    is `csrc/quant_flash.cuh`, shared with the single-sequence paged
    kernel). The phase-aware sampler carries its KV cache between steps in
    this form.
  - `fused_qkv_attention` (TPU kernel `_qkv_kernel`): every head straight
    from the fused [B, S, 3D] projection -> [B, S, D], the full softmax row
    normalised before P is rounded to bf16. Kernel:
    `csrc/fused_qkv_attention.cu`: its `wgmma` design at heads of up to 256
    (instances of 32, 64, 128, 192 and 256, `fused_qkv_head_width`); past
    256 the same two passes over a cluster, the logits kept between them in
    an f32 scratch (`csrc/fused_qkv_attention_wide.cu`, `fused_qkv_instance`,
    a block one 256-column slice of the head up to 2048 and several past
    it, `cluster_plan`).
    Like JAX's, the denoiser does not call it; a caller reaches it through
    `denoiser_forward(attend_fn=...)`.
On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version (`*_plain`), which repeats the TPU kernel's tile
loop at the same rounding points. The kernels take every head width D that is
a multiple of 8, with no upper limit (`head_dim_fits`), as JAX's take every
such width its VMEM holds. Up to 256 a head of D runs in the instance of the
smallest `KERNEL_WIDTHS` entry that holds it, zero past D; past 256 it runs
in the wide instance of its design (D a runtime argument, `instance`): from
264 to 2048 in a cluster of ceil(D / 256) blocks, each 256 columns of the
head, the partial S summed across the cluster (`csrc/wide_cluster_flash.cuh`,
`cluster_blocks`; quantized-KV attention's chain of KV tiles split over
clusters, `quant_cluster_splits`); past 2048 quantized-KV attention in
`csrc/wide_flash.cuh` (the output columns split over blocks of 128, S
summed over chunks of 64 head columns in each), dense, fused-QKV and
single-sequence paged attention in the cluster design with blocks of
several 256-column slices (`cluster_plan`; `dense_instance`).
Where D % 8 != 0 the JAX package runs no Pallas kernel
but XLA, and so does the port, on either device: `flash_fold` takes
`dense_attention_einsum` (the einsum branch of JAX's `_flash_fold`),
`attention` takes `attention_fallback` (JAX's `_attention_fallback`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.quant.core import div_const

NEG_INF = -1e30
# the head widths the attention kernels are instantiated at; a head of D runs
# in the smallest that holds it, or past them in the wide instance
KERNEL_WIDTHS = (16, 32, 64, 128, 192, 256)
WIDE_CHUNK = 64       # head columns a chunk of the wide instance's S
CLUSTER_COLUMNS = 256  # head columns a block of the cluster kernels owns
CLUSTER_MAX = 8        # blocks a cluster at most (the portable size)
# heads past CLUSTER_COLUMNS * CLUSTER_MAX run blocks of several slices of
# CLUSTER_COLUMNS columns (`cluster_plan`)
CLUSTER_ROWS = 128     # query rows a cluster
# bytes of pass 1's S that one launch of dense attention's k-slice kernel
# keeps (at most; one head's at least)
DENSE_SCRATCH = 256 * 2**20
CLUSTER_KV_TILE = 32   # tokens a KV tile of the cluster kernels
KERNEL_KV_TILE = 64   # tokens per online-softmax step of `csrc/quant_flash_contig.cu`
KERNEL_BITS = (1, 2, 4, 8)


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain twin of `dense_attention`, with the TPU kernel's KV tile width
    (the first of 512, 256, 128 that divides Skv; one tile otherwise)."""
    D = q.shape[-1]
    Skv = k.shape[1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    TK = next((t for t in (512, 256, 128) if Skv % t == 0), Skv)
    qf = q.to(torch.bfloat16).to(torch.float32)
    kf = k.to(torch.bfloat16).to(torch.float32)
    vf = v.to(torch.bfloat16).to(torch.float32)
    m = torch.full(q.shape[:2] + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, Skv, TK):
        logits = (qf @ kf[:, j:j + TK].transpose(1, 2)) * sm_scale
        m_new = torch.maximum(m, logits.amax(dim=2, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=2, keepdim=True)
        pv = p.to(torch.bfloat16).to(torch.float32) @ vf[:, j:j + TK]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).to(out_dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense flash attention: q [BH, Sq, D], k/v [BH, Skv, D] -> [BH, Sq, D].

    Inputs are cast to bf16, as on the TPU. CPU tensors take the plain twin;
    CUDA tensors launch the kernel (`head_dim_fits`; past 256 its cluster
    instance, `dense_instance`; bf16 or f32 out). Past 2048 its blocks take
    several slices, and pass 1 keeps S for pass 2 in f32 scratch of Sq *
    ceil(Skv / 8) * 8 * 4 bytes a head; the heads run in launches of as
    many as keep it within `DENSE_SCRATCH` (at least one), each counted
    (at BH = 16, S = 4096: 1 GiB in 4 launches of 4 heads). No gradient
    flows through the kernel: `flash_fold` gives one."""
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, sm_scale, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"dense_attention: unsupported device {q.device}")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if k.shape != (BH, Skv, D) or v.shape != k.shape or Skv == 0:
        raise ValueError(f"dense_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not head_dim_fits(D):
        raise _head_dim_error("dense_attention", D)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dense_attention: out_dtype {out_dtype}, the kernel "
                         "writes bf16 or f32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("dense_attention: q, k, v on different devices")
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (qb, kb, vb)):
        raise ValueError("dense_attention: q, k, v must be 16-byte aligned "
                         "(the kernel reads them by TMA)")
    out = torch.empty((BH, Sq, D), dtype=out_dtype, device=q.device)
    suffix = dense_instance(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.function(f"dlm_dense_attention{suffix}")
    keep, step = None, BH
    if cluster_plan(D)[1] > 1:  # past 2048, pass 1's S for pass 2
        row = Sq * -(-Skv // 8) * 8
        step = max(1, min(BH, DENSE_SCRATCH // (row * 4)))
        keep = torch.empty((step * row,), dtype=torch.float32,
                           device=q.device)
    for z0 in range(0, BH, step):
        z = min(step, BH - z0)
        args = (qb[z0].data_ptr(), kb[z0].data_ptr(), vb[z0].data_ptr(),
                out[z0].data_ptr(), int(out_dtype == torch.bfloat16), z, Sq,
                Skv, D, float(sm_scale), stream)
        if suffix == "_cluster":
            args += (None if keep is None else keep.data_ptr(),)
        _build.check(fn(*args), "dense_attention")
        _build.launch_counts["dense_attention"] += 1
    return out


def dense_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, sm_scale: float):
    """JAX's `_flash_fold_bwd`: standard softmax-attention gradients in f32
    from q, k, v [BH, S, D] and the output's gradient g, each cast back to its
    input's dtype. It materializes the [BH, Sq, Skv] probabilities, as JAX
    does; the forward stays flash."""
    q32, k32, v32, g32 = (t.to(torch.float32) for t in (q, k, v, g))
    logits = torch.einsum("bsd,btd->bst", q32, k32) * sm_scale
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bst,bsd->btd", p, g32)
    dp = torch.einsum("bsd,btd->bst", g32, v32)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bst,btd->bsd", dl, k32) * sm_scale
    dk = torch.einsum("bst,bsd->btd", dl, q32) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dense_attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """The einsum branch of JAX's `_flash_fold`, taken where its
    `dense_attention` returns None: f32 logits from the operands, f32
    softmax, probabilities cast to v's dtype, f32 accumulation, out in q's
    dtype."""
    logits = torch.einsum("bsd,btd->bst", q.to(torch.float32),
                          k.to(torch.float32)) * sm_scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bst,btd->bsd", p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


class DenseAttention(torch.autograd.Function):
    """`dense_attention` with JAX's `_flash_fold` VJP: the forward launches
    the kernel (the plain twin on the CPU), or where the head width is not a
    multiple of 8, on which JAX's `dense_attention` returns None, runs JAX's
    einsum branch (`dense_attention_einsum`); the backward recomputes the
    softmax in f32 (`dense_attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, out_dtype):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        if q.shape[-1] % 8:
            return dense_attention_einsum(q, k, v, sm_scale).to(out_dtype)
        return dense_attention(q, k, v, sm_scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = dense_attention_bwd(q, k, v, g, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               sm_scale: float) -> torch.Tensor:
    """JAX's `_flash_fold`: folded [BH, S, Hd] flash attention in q's dtype,
    differentiable with respect to q, k and v."""
    return DenseAttention.apply(q, k, v, sm_scale, q.dtype)


# ------------------------------------------------------- quantized K/V


@dataclasses.dataclass(frozen=True)
class QuantKV:
    """Block-packed per-token-quantized K or V tensor [BH, S, D]: byte
    (s, c) of `data` holds the level of channel c + p*(D/vpb) in bit field p
    (vpb = 8 / bits)."""

    data: torch.Tensor        # uint8 [BH, S, D/vpb]
    scale: torch.Tensor       # f32 [BH, S]
    zero_point: torch.Tensor  # f32 [BH, S]
    bits: int
    D: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.data.shape[0], self.data.shape[1], self.D)

    def levels(self) -> torch.Tensor:
        """Unpacked levels, int32 [BH, S, D]."""
        vpb = 8 // self.bits
        mask = (1 << self.bits) - 1
        d32 = self.data.to(torch.int32)
        return torch.cat([(d32 >> (p * self.bits)) & mask for p in range(vpb)],
                         dim=-1)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        out = ((self.levels().to(torch.float32) - self.zero_point[..., None])
               * self.scale[..., None])
        return out.to(dtype)


def quantize_kv(x: torch.Tensor, bits: int,
                reciprocal: bool = False) -> QuantKV:
    """Quantize [BH, S, D] per token into the kernel's block-packed layout.
    Bytes, scales and zero-points equal the JAX function's bit for bit: called
    eagerly by default, and with `reciprocal` as compiled inside `jax.jit` or
    `lax.scan`, where XLA divides the range by the constant qmax through its
    f32 reciprocal (`quant.core.div_const`)."""
    BH, S, D = x.shape
    vpb = 8 // bits
    if D % vpb != 0:
        raise ValueError(f"D={D} not divisible by {vpb}")
    x = x.to(torch.float32)
    qmax = float((1 << bits) - 1)
    mn = x.amin(dim=-1)
    rng = x.amax(dim=-1) - mn
    scale = torch.where(rng > 0, div_const(rng, qmax, reciprocal),
                        torch.ones_like(rng))
    zp = -mn / scale
    lv = torch.clamp(torch.round(x / scale[..., None] + zp[..., None]),
                     0.0, qmax).to(torch.uint8)
    if bits == 8:
        packed = lv
    else:
        Dp = D // vpb
        acc = lv[..., 0:Dp].to(torch.int32)
        for p in range(1, vpb):
            acc = acc | (lv[..., p * Dp:(p + 1) * Dp].to(torch.int32)
                         << (p * bits))
        packed = acc.to(torch.uint8)
    return QuantKV(data=packed, scale=scale, zero_point=zp, bits=bits, D=D)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def attention_plain(q: torch.Tensor, k: QuantKV, v: QuantKV,
                    sm_scale: Optional[float] = None,
                    tile: Optional[int] = None,
                    splits: int = 1) -> torch.Tensor:
    """Plain version of `attention`, the TPU `_attn_kernel`'s arithmetic:
    bf16 q with its f32 channel sum qsum; logits = (q.lv_k * ks - qsum *
    (ks*kz)) * sm_scale; the V scale folds into P (bf16(p * vs) times the raw
    levels) with the zero-point as a row correction sum(p * vs * vz); out =
    acc / l, f32. `tile` is the online softmax's step in tokens: by default
    the TPU kernel's (the first of 512, 256, 128 that divides Skv), else the
    CUDA kernels' 64 or 32; a ragged last tile is simply shorter. `splits`
    runs the chain of tiles as the cluster kernel splits it over clusters:
    runs of ceil(tiles / splits) tiles, each its own online softmax, merged
    by (m, l): M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / sum
    w_s l_s. bf16(p * vs) then rounds against each run's own running max, so
    the output moves by up to about 4e-3 from the chain in one run (N(0, 1)
    keys and values, 4 and 8 bits), as the choice of tile moves it (ROADMAP
    C19, C44)."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if tile is None:
        tile = next((t for t in (512, 256, 128) if Skv % t == 0),
                    KERNEL_KV_TILE)
    qb = _bf16(q)
    qsum = qb.sum(dim=-1, keepdim=True)                       # [BH, Sq, 1]
    k_lv, v_lv = k.levels().float(), v.levels().float()

    def run(j0, j1):  # the online softmax over tokens [j0, j1)
        m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)
        for j in range(j0, j1, tile):
            e = min(j + tile, j1)
            ks, kz, vs, vz = (a[:, None, j:e] for a in (
                k.scale, k.zero_point, v.scale, v.zero_point))
            raw = qb @ k_lv[:, j:e].transpose(1, 2)           # [BH, Sq, TK]
            logits = (raw * ks - qsum * (ks * kz)) * sm
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = _bf16(p * vs) @ v_lv[:, j:e]
            corr = (p * vs * vz).sum(dim=-1, keepdim=True)
            acc = acc * alpha + pv - corr
            m = m_new
        return m, l, acc

    if splits == 1:
        m, l, acc = run(0, Skv)
        return acc / l
    tiles = -(-Skv // tile)
    per = -(-tiles // splits) * tile  # tokens a run
    parts = [run(j, min(j + per, Skv)) for j in range(0, Skv, per)]
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    wl = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return sum(wi * acc for wi, (_, _, acc) in zip(w, parts)) / wl


def attention_fallback(q: torch.Tensor, k: QuantKV, v: QuantKV,
                       sm_scale: float) -> torch.Tensor:
    """JAX's `_attention_fallback`, the XLA path of its `attention`: K and V
    dequantized to bf16, bf16 q, f32 logits and softmax, P rounded to bf16,
    f32 out."""
    kd = k.dequantize(torch.bfloat16).to(torch.float32)
    vd = v.dequantize(torch.bfloat16).to(torch.float32)
    logits = torch.einsum("bqd,bkd->bqk", _bf16(q), kd) * sm_scale
    p = _bf16(torch.softmax(logits, dim=-1))
    return torch.einsum("bqk,bkd->bqd", p, vd)


def attention(q: torch.Tensor, k: QuantKV, v: QuantKV,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over quantized KV: q [BH, Sq, D] (batch and heads
    folded outside) -> f32 [BH, Sq, D].

    Where D % 8 != 0, JAX's wrapper takes its XLA path, and so does this one
    on either device (`attention_fallback`). Else CPU tensors take the plain
    version, and CUDA tensors launch the kernel, which serves every Sq and
    Skv >= 1 at 1/2/4/8 bits and every head width (`head_dim_fits`; the TPU
    wrapper hands shapes off its tiling to an XLA path with other
    roundings): up to 256 `csrc/quant_flash_contig.cu`, from 264 to 2048
    its cluster instance (the chain of 32-token KV tiles split over
    `quant_cluster_splits` clusters and merged in the launch), past 2048
    its wide
    instance."""
    if k.bits != v.bits or k.shape != v.shape:
        raise ValueError(f"attention: K {k.shape} at {k.bits} bits, "
                         f"V {v.shape} at {v.bits} bits")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if k.shape != (BH, Skv, D) or Skv == 0:
        raise ValueError(f"attention: q {tuple(q.shape)} over K/V {k.shape}")
    if D % 8:
        sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
        return attention_fallback(q, k, v, sm)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if not head_dim_fits(D):
        raise _head_dim_error("attention", D)
    if k.bits not in KERNEL_BITS:
        raise ValueError(f"attention: bits {k.bits}, the kernel takes "
                         f"{KERNEL_BITS}")
    Dp = D // (8 // k.bits)
    sides = (k.scale, k.zero_point, v.scale, v.zero_point)
    if any(t.dtype != torch.uint8 or t.shape != (BH, Skv, Dp)
           for t in (k.data, v.data)):
        raise ValueError(f"attention: packed K/V must be uint8 {(BH, Skv, Dp)}")
    if any(t.dtype != torch.float32 or t.shape != (BH, Skv) for t in sides):
        raise ValueError(f"attention: scales and zero-points must be f32 "
                         f"{(BH, Skv)}")
    if any(t.device != q.device for t in (k.data, v.data) + sides):
        raise ValueError("attention: inputs on different devices")
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qb = q.to(torch.bfloat16).contiguous()
    kd, ks, kz, vd, vs, vz = (t.contiguous() for t in (
        k.data, k.scale, k.zero_point, v.data, v.scale, v.zero_point))
    # bytes the kernel's loader reads from a packed row at once (the cluster
    # and wide instances take any alignment)
    row = 1 if D > KERNEL_WIDTHS[-1] else math.gcd(Dp, 8)
    if qb.data_ptr() % 16 or kd.data_ptr() % row or vd.data_ptr() % row:
        raise ValueError(f"attention: q must be 16-byte and the packed K/V "
                         f"{row}-byte aligned")
    out = torch.empty((BH, Sq, D), dtype=torch.float32, device=q.device)
    suffix = instance(D)
    args = (qb.data_ptr(), kd.data_ptr(), ks.data_ptr(), kz.data_ptr(),
            vd.data_ptr(), vs.data_ptr(), vz.data_ptr(), out.data_ptr(),
            BH, Sq, Skv, D, k.bits, float(sm),
            torch.cuda.current_stream(q.device).cuda_stream)
    if suffix == "_cluster":  # the chain split over clusters, merged in-launch
        n = quant_cluster_splits(BH, Sq, Skv, D, k.bits)
        scratch = split_scratch(q.device, n, BH, Sq, D)
        args += (n, *(None if t is None else t.data_ptr() for t in scratch))
    _build.check(_build.function(f"dlm_quant_attention{suffix}")(*args),
                 "quant_attention")
    _build.launch_counts["quant_attention"] += 1
    return out


def quant_cluster_splits(BH: int, Sq: int, Skv: int, D: int,
                         bits: int) -> int:
    """The splits over which `attention`'s cluster instance (heads of 264 to
    2048 on the card) runs the chain of ceil(Skv / 32) KV tiles of each of
    its ceil(Sq / 128) x BH clusters: enough to fill the card, at least 4
    tiles a split, at most 8, and no split empty
    (`dlm_quant_attention_cluster_splits`)."""
    n = _build.function("dlm_quant_attention_cluster_splits")(
        BH, Sq, Skv, D, bits)
    if n < 0:
        _build.check(-n, "quant_attention")
    return n


# the zeroed counters of the cluster kernels' splits, by device, the last the
# largest; the kernels leave them zero (so calls that split share them one
# stream at a time). None is freed when a larger one is made: a CUDA graph
# captured at a smaller shape replays with the counters it was captured with.
_split_counters = {}


def split_scratch(device, n: int, BH: int, Sq: int, D: int):
    """What a cluster kernel whose chain runs in `n` splits takes beside
    its arguments (`csrc/wide_cluster_flash.cuh: merge_splits`): where n >
    1, scratch for the splits' partial o and (m, l) and the counters by
    which the last block of each column slice merges them; (None, None,
    None) where n == 1 (tensors: the caller holds them until the launch)."""
    if n == 1:
        return (None, None, None)
    C = cluster_plan(D)[0]
    part_o = torch.empty((n, BH, Sq, D), dtype=torch.float32, device=device)
    part_ml = torch.empty((n, C, BH, Sq, 2), dtype=torch.float32,
                          device=device)
    need = -(-Sq // CLUSTER_ROWS) * BH * C
    held = _split_counters.setdefault(device, [])
    if not held or held[-1].numel() < need:
        held.append(torch.zeros(need, dtype=torch.int32, device=device))
    return (part_o, part_ml, held[-1])


# ------------------------------- the head widths the kernels take; fused-QKV

def head_dim_fits(D: int) -> bool:
    """Whether the attention kernels take heads of D: a multiple of 8 (JAX's
    own condition for its dense kernel, and TMA's 16-byte row stride), with
    no upper limit."""
    return D % 8 == 0 and D >= 8


def kernel_width(D: int) -> int:
    """The width a head of D runs at: the smallest `KERNEL_WIDTHS` entry that
    holds it; past them, D rounded up to the wide instance's chunk of
    `WIDE_CHUNK` columns (the rows of the batched paged path's scratch)."""
    return next((w for w in KERNEL_WIDTHS if D <= w),
                -(-D // WIDE_CHUNK) * WIDE_CHUNK)


def cluster_blocks(D: int) -> int:
    """The blocks of a cluster that serve heads of D in the cluster design
    of every attention kernel (`csrc/wide_cluster_flash.cuh`,
    `csrc/fused_qkv_attention_wide.cu`: each block `CLUSTER_COLUMNS`
    columns of the head): ceil(D / 256) from 264 to 2048, where a cluster
    has at most `CLUSTER_MAX` blocks, else 0. Past 2048 fused-QKV and
    single-sequence paged attention give a block several slices
    (`cluster_plan`)."""
    if not head_dim_fits(D) or not (
            KERNEL_WIDTHS[-1] < D <= CLUSTER_COLUMNS * CLUSTER_MAX):
        return 0
    return -(-D // CLUSTER_COLUMNS)


def cluster_plan(D: int) -> Tuple[int, int]:
    """The cluster that serves heads of D past 256 in the cluster design
    (`csrc/wide_cluster_flash.cuh: cluster_plan`): (C, k), C blocks of k
    slices of `CLUSTER_COLUMNS` columns each. The head is n = ceil(D / 256)
    slices, k = ceil(n / 8) a block, C = ceil(n / k): (ceil(D / 256), 1)
    from 264 to 2048 (`cluster_blocks`), (5, 2) at 2056 and 2560, (6, 3) at
    4104, (8, 5) at 10240. Block j owns slices [jk, jk + k), the last block
    fewer. (0, 0) where D is not a multiple of 8 past 256."""
    if not head_dim_fits(D) or D <= KERNEL_WIDTHS[-1]:
        return (0, 0)
    n = -(-D // CLUSTER_COLUMNS)
    k = -(-n // CLUSTER_MAX)
    return (-(-n // k), k)


def instance(D: int) -> str:
    """The suffix of the C entry point a head of D launches in quantized-KV
    attention: "" at a `KERNEL_WIDTHS` entry, "_padded" between them (a
    source of its own), and past them "_cluster" where `cluster_blocks(D)`
    takes D (`csrc/wide_cluster_flash.cuh`), else "_wide"
    (`csrc/wide_flash.cuh`). Dense and single-sequence paged attention
    launch "_cluster" past 256 at every width (`dense_instance`,
    `ops/paged_attention.py: paged_instance`)."""
    if D > KERNEL_WIDTHS[-1]:
        return "_cluster" if cluster_blocks(D) else "_wide"
    return "" if D == kernel_width(D) else "_padded"


def dense_instance(D: int) -> str:
    """The suffix of the C entry point `dense_attention` launches for heads
    of D: "" up to 256 (`csrc/dense_attention.cu` holds every width there),
    and past it "_cluster" at every width (`dlm_dense_attention_cluster`: a
    block one 256-column slice of the head up to 2048, several past it,
    `cluster_plan`)."""
    return "_cluster" if D > KERNEL_WIDTHS[-1] else ""


def replay_scratch(device, D: int, Z: int, Sq: int, tiles: int,
                   words: int = 3):
    """Past 2048 (`cluster_plan(D)[1] > 1`), what a k-slice cluster kernel of
    paged attention keeps in pass 1 for its pass 2: for each of the Z heads'
    ceil(Sq / 128) clusters, each of its `tiles` tiles and each thread of
    its 256, `words` 16-byte words (single-sequence paged attention:
    bf16(p * vs), alpha and csum of a 32-key tile; the batched int8 path: a
    page's wi, alpha, sw and csum), Z * ceil(Sq / 128) * tiles * words *
    4096 bytes, in `torch.empty` so that a CUDA graph keeps it in its pool;
    None at 264 to 2048, where the kernels run one pass."""
    if cluster_plan(D)[1] == 1:
        return None
    clusters = Z * -(-Sq // CLUSTER_ROWS)
    return torch.empty((clusters * tiles * words * 256 * 16,),
                       dtype=torch.uint8, device=device)


def _head_dim_error(name: str, D: int) -> ValueError:
    return ValueError(f"{name}: head dim {D}, the kernels take multiples of "
                      "8")


FUSED_QKV_VMEM = 8 * 1024 * 1024  # the TPU kernel's whole-row budget
FUSED_QKV_WIDTHS = (32, 64, 128, 192, 256)  # the wgmma design's instances


def fused_qkv_head_width(Hd: int) -> int:
    """The instance of the fused-QKV `wgmma` design that runs heads of Hd
    (`csrc/fused_qkv_attention.cu: head_width`): the smallest of
    `FUSED_QKV_WIDTHS` that holds it, zero past Hd; 0 past 256, where the
    cluster kernel serves."""
    return next((w for w in FUSED_QKV_WIDTHS if Hd <= w), 0)


def fused_qkv_instance(Hd: int) -> str:
    """The suffix of the C entry point fused-QKV attention launches for
    heads of Hd: "_cluster" past 256 (`cluster_plan`,
    `csrc/fused_qkv_attention_wide.cu`), else "" (`csrc/fused_qkv_attention
    .cu`: its `wgmma` instances up to 256)."""
    return "_cluster" if cluster_plan(Hd)[0] else ""


def fused_qkv_fits(qkv_shape, num_heads: int) -> bool:
    """Where JAX's `fused_qkv_attention` runs its kernel (it returns None
    elsewhere): 3D splits into heads of a multiple of 8, S % 8 == 0, and
    the whole [S, 3D] row, the [S, S] f32 logits and the output within
    8 MiB."""
    _, S, threeD = qkv_shape
    D = threeD // 3
    if threeD % 3 or D % num_heads or (D // num_heads) % 8:
        return False
    return not (S % 8 or S * threeD * 2 + S * S * 4 + S * D * 2 > FUSED_QKV_VMEM)


def fused_qkv_attention_plain(qkv: torch.Tensor, num_heads: int,
                              sm_scale: Optional[float] = None,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of `fused_qkv_attention`, in the TPU kernel's order:
    bf16 operands, f32 logits times sm_scale, the row max over all keys,
    exp, division by the row sum, bf16(p) @ v with f32 accumulation."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    Hd = D // num_heads
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Hd)
    x = qkv.to(torch.bfloat16).to(torch.float32)
    q, k, v = (x[..., i * D:(i + 1) * D].reshape(B, S, num_heads, Hd)
               .transpose(1, 2) for i in range(3))
    logits = (q @ k.transpose(-1, -2)) * sm_scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = _bf16(p) @ v
    return out.transpose(1, 2).reshape(B, S, D).to(out_dtype)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        sm_scale: Optional[float] = None,
                        out_dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """Full-sequence bidirectional attention off the fused projection:
    qkv [B, S, 3D] -> [B, S, D] (heads concatenated), or None where JAX's
    wrapper returns None (`fused_qkv_fits`).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16 or f32 out), which serves every shape the predicate admits: heads
    of up to 256 in its `wgmma` design (`fused_qkv_head_width`), wider ones
    in its cluster design (`fused_qkv_instance`, `cluster_plan`; the logits
    of pass 1 kept for pass 2 in an f32 scratch of B * H * S * S)."""
    if qkv.ndim != 3:
        raise ValueError(f"fused_qkv_attention: qkv must be [B, S, 3D], got "
                         f"{tuple(qkv.shape)}")
    if not fused_qkv_fits(qkv.shape, num_heads):
        return None
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, sm_scale, out_dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_qkv_attention: out_dtype {out_dtype}, the "
                         "kernel writes bf16 or f32")
    B, S, threeD = qkv.shape
    D = threeD // 3
    Hd = D // num_heads
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Hd)
    xb = qkv.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        raise ValueError("fused_qkv_attention: qkv must be 16-byte aligned "
                         "(the kernel reads rows 16 bytes at a time)")
    out = torch.empty((B, S, D), dtype=out_dtype, device=qkv.device)
    suffix = fused_qkv_instance(Hd)
    args = (xb.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            B, S, num_heads, Hd, float(sm_scale),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if suffix == "_cluster":  # pass 1's logits, read back by pass 2
        logits = torch.empty((B * num_heads, S, S), dtype=torch.float32,
                             device=qkv.device)
        args += (logits.data_ptr(),)
    _build.check(_build.function(f"dlm_fused_qkv_attention{suffix}")(*args),
                 "fused_qkv_attention")
    _build.launch_counts["fused_qkv_attention"] += 1
    return out
