"""Decoded-int8 linear kernels and the block-packed weight layout.

Counterpart of `diffusion_llm_rs_tpu/ops/pallas_matmul.py`:
  - `MatmulWeight` and `prepare`: W [K, N] quantized at `bits` with groups of
    `group_size` along K, *block-packed* along K (byte (k, n) holds the
    levels of W[s*Kp + k, n] in bit-field s, Kp = K/vpb), with the exact
    per-column `col_scale` (max |dequantized| / 127) when `act_bits=8`.
  - `int8w_matmul` (TPU kernel `_kernel_i8w`) and `int8w_mlp`
    (`_kernel_i8_mlp`): per-row int8 activation quantization, int8 x int8
    -> int32 dot, f32 epilogue `*sx[m]*col_scale[n] + bias -> gelu ->
    +residual`. On a CUDA tensor `int8w_matmul` launches the kernels of
    `csrc/int8_gemm.cu` (the row quantization, then an s8 `wgmma` core over
    the weight read K-major, `_k_major`, run as `gemm_plan` says), and
    `int8w_mlp` the fused kernel of `csrc/int8_mlp.cu`, which keeps the
    inner activation of 64 rows in the shared memory of a cluster of 3 or 4
    blocks (`mlp_plan`; over the same K-major weights); widths too large for it (`mlp_fits`) take
    `int8w_mlp_chained`, the same arithmetic as four launches of
    `csrc/int8_gemm.cu`, counted and logged under its own name. On a CPU
    tensor they run their plain twins `int8w_matmul_plain` /
    `int8w_mlp_plain`, which repeat the kernels' arithmetic in the same
    order. As in JAX, the residual may be bf16 or f32, added in f32 before
    the output's rounding. The kernels read K in 16-byte rows and write N 4
    columns at a time; at other widths the wrappers pad x's K with zeros a
    call and hold a zero-padded K-major copy of the weight (`_padded`),
    where JAX's wrappers answer through XLA: zero rows add exact zeros to
    the int32 sums and leave every row's amax alone, so the result is the
    plain version's bit for bit.

The integer product of the twins is taken in float64, which is exact here
(|sum| <= K * 127^2 < 2^53): torch has no integer matmul on CUDA, and on the
CPU an int8 matmul returns int8 and overflows.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import weakref
from typing import Optional

import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.quant.core import (
    QuantizedTensor,
    true_div,
    unpack_bits,
)

# jax.nn.gelu(approximate=True) takes sqrt(2/pi) in the input's dtype
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MatmulWeight:
    """Kernel-ready quantized weight (see module docstring for the layout)."""

    data: torch.Tensor         # uint8 [Kp, N]
    scale: torch.Tensor        # f32 [K/G, N]
    zero_point: torch.Tensor   # f32 [K/G, N]
    bits: int
    K: int
    N: int
    group_size: int            # effective group size along K
    act_bits: int = 16         # 16 = bf16 activations; 8 = int8 activations
    col_scale: Optional[torch.Tensor] = None  # f32 [1, N] (act_bits=8 only)

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def ndim(self):
        return 2

    def to(self, device) -> "MatmulWeight":
        return dataclasses.replace(
            self, data=self.data.to(device), scale=self.scale.to(device),
            zero_point=self.zero_point.to(device),
            col_scale=(None if self.col_scale is None
                       else self.col_scale.to(device)))

    def levels(self) -> torch.Tensor:
        """Unsigned levels [K, N] in natural K order."""
        mask = (1 << self.bits) - 1
        parts = [(self.data >> (s * self.bits)) & mask
                 for s in range(8 // self.bits)]
        return torch.cat(parts, dim=0)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        G = self.group_size
        lv = self.levels().to(torch.float32).reshape(self.K // G, G, self.N)
        out = (lv - self.zero_point[:, None, :]) * self.scale[:, None, :]
        return out.reshape(self.K, self.N).to(dtype)


def prepare(qt: QuantizedTensor, act_bits: int = 16) -> MatmulWeight:
    """One-time repack of a QuantizedTensor (packed along N) into the
    block-packed-along-K layout. act_bits=8 also computes the exact
    per-column max |dequantized weight| / 127 for the int8 column grid."""
    if qt.ndim != 2:
        raise ValueError(f"expected 2-D weight, got {qt.shape}")
    K, N = qt.shape
    bits = qt.bits
    vpb = 8 // bits
    if K % vpb != 0:
        raise ValueError(f"K={K} not divisible by values-per-byte {vpb}")
    levels = unpack_bits(qt.data, bits, N)  # [K, N] uint8

    if qt.granularity == "group":
        if qt.axis != 0:
            raise ValueError("matmul weights must be grouped along K (axis 0)")
        G = qt.group_size
        scale = qt.scale.to(torch.float32)
        zp = qt.zero_point.to(torch.float32)
    elif qt.granularity == "channel":
        G = K
        scale = qt.scale.reshape(1, -1).to(torch.float32)
        zp = qt.zero_point.reshape(1, -1).to(torch.float32)
        if scale.shape[1] == 1:
            raise ValueError("per-K-channel weights unsupported; use group")
    else:  # tensor
        G = K
        scale = qt.scale.reshape(1, 1).expand(1, N).to(torch.float32)
        zp = qt.zero_point.reshape(1, 1).expand(1, N).to(torch.float32)

    Kp = K // vpb
    packed = levels.reshape(vpb, Kp, N)[0].clone()
    for s in range(1, vpb):
        packed |= levels.reshape(vpb, Kp, N)[s] << (s * bits)
    col_scale = None
    if act_bits == 8:
        lv = levels.to(torch.float32).reshape(K // G, G, N)
        wabs = ((lv - zp[:, None, :]) * scale[:, None, :]).abs()
        col_scale = torch.clamp_min(
            true_div(wabs.amax(dim=(0, 1)).reshape(1, N), 127.0), 1e-12)
    elif act_bits != 16:
        raise ValueError(f"act_bits must be 8 or 16, got {act_bits}")
    return MatmulWeight(data=packed, scale=scale.contiguous(),
                        zero_point=zp.contiguous(), bits=bits, K=K, N=N,
                        group_size=G, act_bits=act_bits, col_scale=col_scale)


# ------------------------------------------------------------ plain twins ---


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), operation for operation."""
    inner = _SQRT_2_OVER_PI * (y + 0.044715 * (y * y * y))
    return y * (0.5 * (1.0 + torch.tanh(inner)))


def quant_rows_plain(xf: torch.Tensor):
    """Per-row symmetric int8 quantization of an f32 [M, K] matrix
    (`_quant_rows`): (int8 levels, f32 scales [M, 1])."""
    amax = xf.abs().amax(dim=1, keepdim=True)
    sx = torch.where(amax > 0, true_div(amax, 127.0), 1.0)
    return torch.round(xf / sx).to(torch.int8), sx


def _int_dot(xi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, through float64."""
    return (xi.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def int8w_matmul_plain(x, data, col_scale, bias=None, activation=None,
                       residual=None, out_dtype=torch.float32):
    """Plain twin of `int8w_matmul`: x [..., K] @ int8 [K, N] -> [..., N]."""
    K, N = data.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, K).to(torch.bfloat16).to(torch.float32)
    xi, sx = quant_rows_plain(xf)
    y = _int_dot(xi, data).to(torch.float32) * sx * col_scale.reshape(1, N).float()
    if bias is not None:
        y = y + bias.reshape(1, N).to(torch.float32)
    if activation == "gelu":
        y = gelu_tanh(y)
    if residual is not None:
        y = y + residual.reshape(-1, N).to(torch.float32)
    return y.to(out_dtype).reshape(*lead, N)


def int8w_mlp_plain(x, w1_data, cs1, b1, w2_data, cs2, b2, residual=None,
                    out_dtype=torch.bfloat16):
    """Plain twin of `int8w_mlp`: quant -> dot w1 -> bias, gelu (f32 inner)
    -> requant -> dot w2 -> bias (+ residual)."""
    K, N1 = w1_data.shape
    N2 = w2_data.shape[1]
    lead = x.shape[:-1]
    xi, sx = quant_rows_plain(x.reshape(-1, K).to(torch.bfloat16).to(torch.float32))
    y1 = (_int_dot(xi, w1_data).to(torch.float32) * sx * cs1.reshape(1, N1).float()
          + b1.reshape(1, N1).to(torch.float32))
    yi, sy = quant_rows_plain(gelu_tanh(y1))
    y2 = (_int_dot(yi, w2_data).to(torch.float32) * sy * cs2.reshape(1, N2).float()
          + b2.reshape(1, N2).to(torch.float32))
    if residual is not None:
        y2 = y2 + residual.reshape(-1, N2).to(torch.float32)
    return y2.to(out_dtype).reshape(*lead, N2)


# ----------------------------------------------------------- the kernels ---

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _quant_rows(x2: torch.Tensor):
    """Kernel: per-row int8 quantization of a bf16 or f32 [M, K] matrix."""
    M, K = x2.shape
    xi = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    _build.check(_build.function("dlm_quant_rows")(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), xi.data_ptr(),
        sx.data_ptr(), M, K, _stream(x2.device)), "quant_rows")
    return xi, sx


# The s8 wgmma core's plan (csrc/int8_gemm.cu: gemm_plan, the same
# arithmetic): a block owns 128 rows of the A operand (two consumer
# warpgroups) and `tile` rows of the B operand, over K in steps of 128 bytes
# through a ring of TMA stages. Tokens on the wgmma M side (swap False) make
# tiles of 128 tokens x 64/96/128 weight columns; on its N side (swap True,
# up to 32 tokens) 128 weight columns x 8/16/32 tokens. Where the tiles do
# not fill the card the K steps split over up to 16 blocks, whose int32
# partials a second kernel sums. Cost, fitted to the kernel's times on an
# H100 over 44 shapes (M = 1-8192, N and K of the model's linears): waves of
# two blocks an SM, each wave its blocks' k steps (a share of a 128 x 128
# step: `GEMM_NORMAL_TILES`, `GEMM_SWAP_STEP`) plus 1.5 for the ring's fill
# and the epilogue; a split adds 3 for its second launch and its partials'
# bytes at 1 MB a unit.
GEMM_A_ROWS = 128
GEMM_K_BYTES = 128
GEMM_NORMAL_TILES = ((128, 1.0), (96, 0.7), (64, 0.65))  # (tile, step cost)
GEMM_SWAP_TILES = (8, 16, 32)
GEMM_SWAP_STEP = 0.4
GEMM_SPLIT_COST = 3.0
GEMM_MAX_SPLITS = 16
GEMM_RING = 96 * 1024        # ring bytes a block: two blocks an SM
GEMM_MAX_STAGES = 6


def gemm_smem(swap: bool, tile: int):
    """(ring stages, dynamic shared memory in bytes) of the core's instance:
    the ring, or where that is larger the epilogue's int32 tile with the
    tile's row scales, column scales and biases; 1024 bytes of alignment
    and the stages' two mbarriers."""
    stage = (GEMM_A_ROWS + tile) * GEMM_K_BYTES
    stages = min(GEMM_MAX_STAGES, GEMM_RING // stage)
    tm, tn = (tile, GEMM_A_ROWS) if swap else (GEMM_A_ROWS, tile)
    epilogue = tm * (tn + (4 if swap else 8)) * 4 + (tm + 2 * tn) * 4
    return stages, 1024 + max(stages * stage, epilogue) + 2 * stages * 8


def gemm_plan(M: int, N: int, K: int, sms: int = 132) -> dict:
    """How the s8 wgmma core runs xi [M, K] @ wt [N, K]^T on a card of `sms`
    SMs: the orientation (`swap`: tokens on the wgmma N side), the B rows a
    block (`tile`), the blocks along K (`splits`), the grid (A tiles, B
    tiles, splits), the ring's stages and the shared memory."""
    ksteps = -(-K // GEMM_K_BYTES)
    slots = 2 * sms
    cands = []
    if M <= GEMM_SWAP_TILES[-1]:
        bt = next(t for t in GEMM_SWAP_TILES if t >= M)
        cands.append((True, bt, -(-N // GEMM_A_ROWS) * -(-M // bt),
                      GEMM_SWAP_STEP))
    for bn, step in GEMM_NORMAL_TILES:
        cands.append((False, bn, -(-M // GEMM_A_ROWS) * -(-N // bn), step))
    best = None
    for swap, tile, tiles, step in cands:
        s = 1
        while s <= GEMM_MAX_SPLITS and s <= ksteps:
            waves = -(-tiles * s // slots)
            cost = waves * (-(-ksteps // s) * step + 1.5)
            if s > 1:
                cost += GEMM_SPLIT_COST + M * N * 4 * (s + 1) / 1e6
            if best is None or cost < best[0]:
                best = (cost, swap, tile, s)
            s *= 2
    _, swap, tile, splits = best
    rows_a, rows_b = (N, M) if swap else (M, N)
    stages, smem = gemm_smem(swap, tile)
    return dict(swap=swap, tile=tile, splits=splits,
                grid=(-(-rows_a // GEMM_A_ROWS), -(-rows_b // tile), splits),
                stages=stages, smem=smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemm(xi, sx, wt, cs, bias, residual, gelu: bool, out_dtype, plan=None):
    """Kernel: out = epilogue(xi @ wt^T) over the K-major weight wt [N, K]
    (see csrc/int8_gemm.cu), run as `plan` says (default: `gemm_plan`)."""
    M, K = xi.shape
    N = wt.shape[0]
    if plan is None:
        plan = gemm_plan(M, N, K, _sm_count(xi.device.index or 0))
    if residual is not None and residual.data_ptr() % (
            16 if residual.dtype == torch.float32 else 8):
        residual = residual.clone()  # the epilogue reads 4 values at a time
    out = torch.empty((M, N), dtype=out_dtype, device=xi.device)
    splits = plan["splits"]
    ws = (torch.empty((splits, M, N), dtype=torch.int32, device=xi.device)
          if splits > 1 else None)
    _build.check(_build.function("dlm_int8_gemm")(
        xi.data_ptr(), wt.data_ptr(), sx.data_ptr(), cs.data_ptr(),
        _ptr(bias), _ptr(residual), int(gelu), out.data_ptr(),
        int(out_dtype == torch.bfloat16), M, N, K, int(plan["swap"]),
        plan["tile"], splits, _ptr(ws), _stream(xi.device),
        int(residual is not None and residual.dtype == torch.float32)),
        "int8_gemm")
    return out


# The kernels read K in 16-byte rows and write N 4 columns at a time; other
# widths run padded with zeros (`_padded`), which add exact zeros to the
# int32 sums and leave every row's amax as it is.
K_ALIGN, N_ALIGN = 16, 4


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def _check_weight(name, data, col_scale, K):
    if data.dtype != torch.int8 or data.ndim != 2 or data.shape[0] != K:
        raise ValueError(f"{name}: weight must be int8 [{K}, N], got "
                         f"{data.dtype} {tuple(data.shape)}")
    if col_scale.dtype != torch.float32 or col_scale.numel() != data.shape[1]:
        raise ValueError(f"{name}: col_scale must be f32 with N entries")
    if data.data_ptr() % 4:
        raise ValueError(f"{name}: weight must be 4-byte aligned")


def _epilogue_vec(v, N, name):
    if v is None:
        return None
    if v.numel() != N:
        raise ValueError(f"{name}: bias has {v.numel()} entries, expected {N}")
    return v.reshape(N).to(torch.float32).contiguous()


def _residual(r, M, N, name):
    """The kernels add a bf16 residual (the sampler's activations) or an f32
    one (the phase-aware sampler's), in f32 before the output's rounding."""
    if r is None:
        return None
    if r.dtype not in (torch.bfloat16, torch.float32) or r.numel() != M * N:
        raise ValueError(f"{name}: residual must be bf16 or f32 with {M}x{N} "
                         f"entries, got {r.dtype} {tuple(r.shape)}")
    return r.reshape(M, N).contiguous()


def _pad_cols(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """t [..., N] with zero columns up to n (t itself where N == n)."""
    if t is None or t.shape[-1] == n:
        return t
    return torch.nn.functional.pad(t, (0, n - t.shape[-1])).contiguous()


def int8w_matmul(x: torch.Tensor, data: torch.Tensor, col_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """x [..., K] @ decoded int8 weight [K, N] with the fused epilogue.

    x is rounded to bf16 before its per-row quantization, as on the TPU.
    CPU tensors take the plain twin; CUDA tensors launch the kernels, at
    any K and N (padded to the kernels' alignment) and with a bf16 or f32
    residual."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return int8w_matmul_plain(x, data, col_scale, bias, activation,
                                  residual, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8w_matmul: unsupported device {x.device}")
    K = x.shape[-1]
    N = data.shape[1]
    _check_weight("int8w_matmul", data, col_scale, K)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"int8w_matmul: out_dtype {out_dtype} not f32/bf16")
    lead = x.shape[:-1]
    Kp, Np = _round_up(K, K_ALIGN), _round_up(N, N_ALIGN)
    x2 = _pad_cols(x.reshape(-1, K).to(torch.bfloat16).contiguous(), Kp)
    M = x2.shape[0]
    bias = _pad_cols(_epilogue_vec(bias, N, "int8w_matmul"), Np)
    residual = _pad_cols(_residual(residual, M, N, "int8w_matmul"), Np)
    cs = _pad_cols(col_scale.reshape(1, N), Np)
    wt = _k_major(data) if (Kp, Np) == (K, N) else _padded(data, Kp, Np)
    _check_cuda("int8w_matmul", x2.device, data=wt, col_scale=cs,
                bias=bias, residual=residual)
    xi, sx = _quant_rows(x2)
    out = _gemm(xi, sx, wt, cs, bias, residual, activation == "gelu",
                out_dtype)
    _build.launch_counts["int8w_matmul"] += 1
    return _unpad(out, N, lead)


# The fused MLP kernel's plan (csrc/int8_mlp.cu): a cluster of 3 or 4 blocks
# owns 64 rows; each block keeps the rows' int8 x tile (K padded to 128
# bytes), a ring of 4 weight stages of 16 KB and two round buffers of 4 x 8
# KB in shared memory, and up to 4 output tiles of 64 columns in registers.
MLP_CLUSTERS = (4, 3)
MLP_ROWS = 64
MLP_CHUNK = 128              # inner columns a block a round
MLP_MAX_INNER = 3072
MLP_MAX_K = 1536
MLP_MAX_OUT_TILES = 4
SMEM_LIMIT = 232448          # dynamic shared memory of one sm_90 block


def _mlp_takes(K: int, F: int, N: int, cluster: int) -> Optional[int]:
    """The fused kernel's shared memory at these widths and cluster size,
    or None where it does not take them (as `dlm_int8_mlp_smem`)."""
    if min(K, F, N) <= 0 or F > MLP_MAX_INNER or K > MLP_MAX_K:
        return None
    if -(-(-(-N // 64)) // cluster) > MLP_MAX_OUT_TILES:
        return None
    smem = (1024 + MLP_ROWS * (-(-K // 128) * 128) + 4 * 16384
            + 2 * 4 * 8192 + 2 * 4 * MLP_ROWS * 4 + MLP_ROWS * 4 + 16 * 8)
    return smem if smem <= SMEM_LIMIT else None


def mlp_plan(M: int, K: int, F: int, N: int,
             active: Optional[dict] = None) -> Optional[dict]:
    """How the fused MLP kernel runs x [M, K] -> [M, F] -> [M, N], or None
    where it does not take the widths.

    `active` maps a cluster size (3, 4) to the clusters of it the card runs
    at once (`dlm_int8_mlp_active_clusters`; without it, clusters of 4).
    The plan takes the size whose waves of row tiles cost least, a block of
    a 3-cluster doing 4/3 of the work of one of a 4-cluster. It gives the
    cluster size, the grid (cluster blocks along x, 64-row tiles along y),
    the rounds of 128 * cluster inner columns, each block's 64-column output
    tiles and its shared memory in bytes."""
    tiles = -(-M // MLP_ROWS)
    active = {4: 1} if active is None else active
    best = None
    for cl in MLP_CLUSTERS:
        smem = _mlp_takes(K, F, N, cl)
        if smem is None or active.get(cl, 0) <= 0:
            continue
        cost = -(-tiles // active[cl]) * 4 / cl
        if best is None or cost < best[0]:
            best = (cost, dict(cluster=cl, grid=(cl, tiles),
                               rounds=-(-F // (MLP_CHUNK * cl)),
                               out_tiles=-(-(-(-N // 64)) // cl), smem=smem))
    return None if best is None else best[1]


def mlp_fits(K: int, F: int, N: Optional[int] = None) -> bool:
    """Whether the fused MLP kernel takes widths K -> F -> N (N defaults to
    K): inner rows up to 3072, x rows up to 1408, output rows up to 1024.
    Wider ones run `int8w_mlp_chained`."""
    return _mlp_takes(K, F, K if N is None else N, 4) is not None


@functools.lru_cache(maxsize=None)
def _active_clusters(K: int, N: int) -> dict:
    """Clusters of 3 and of 4 blocks of the fused kernel the card runs at
    once at widths K -> N (asked of the CUDA runtime once a shape)."""
    fn = _build.function("dlm_int8_mlp_active_clusters")
    return {cl: fn(K, N, cl) for cl in MLP_CLUSTERS}


# K-major copies of int8 weights that are not held K-major already, made
# once per weight tensor: the s8 tensor-core products read both operands
# K-major. A card `Int8Weight` holds its one copy K-major (`ops/matmul.py`),
# so it never lands here. id(weight) -> (weakref, version, copy).
_k_major_copies: dict = {}


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """w^T [N, K], contiguous: the view itself where w is the transposed
    view of a K-major tensor, else a copy from a cache that drops the copy
    with the weight and remakes it after an in-place change."""
    if w.t().is_contiguous():
        return w.t()
    key = id(w)
    hit = _k_major_copies.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wt = w.t().contiguous()
    _k_major_copies[key] = (
        weakref.ref(w, lambda _, k=key: _k_major_copies.pop(k, None)),
        w._version, wt)
    return wt


# Zero-padded K-major copies of int8 weights whose K or N is off the
# kernels' alignment, made once per weight tensor and width, as
# `_k_major_copies`: (id(weight), K, N) -> (weakref, version, copy).
_padded_copies: dict = {}


def _padded(w: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """w^T [N, K] with zeros past w's [N0, K0]: the K-major operand of a
    weight off the kernels' alignment, padded to it."""
    key = (id(w), K, N)
    hit = _padded_copies.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wt = torch.zeros((N, K), dtype=w.dtype, device=w.device)
    wt[:w.shape[1], :w.shape[0]] = w.t()
    _padded_copies[key] = (
        weakref.ref(w, lambda _, k=key: _padded_copies.pop(k, None)),
        w._version, wt)
    return wt


def _mlp_args(name, x, w1_data, cs1, b1, w2_data, cs2, b2, residual,
              out_dtype):
    """Checked, contiguous kernel operands of an MLP call on the card, the
    weights K-major; widths off the kernels' alignment padded with zeros
    (x's K, the inner F, the output's N; the inner columns past F come out
    gelu(0) = 0). Returns them with the unpadded N."""
    K = x.shape[-1]
    N1, N2 = w1_data.shape[1], w2_data.shape[1]
    _check_weight(name, w1_data, cs1, K)
    _check_weight(name, w2_data, cs2, N1)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not f32/bf16")
    Kp, Fp, Np = (_round_up(K, K_ALIGN), _round_up(N1, K_ALIGN),
                  _round_up(N2, N_ALIGN))
    x2 = _pad_cols(x.reshape(-1, K).to(torch.bfloat16).contiguous(), Kp)
    M = x2.shape[0]
    b1 = _pad_cols(_epilogue_vec(b1, N1, name), Fp)
    b2 = _pad_cols(_epilogue_vec(b2, N2, name), Np)
    cs1 = _pad_cols(cs1.reshape(1, N1), Fp)
    cs2 = _pad_cols(cs2.reshape(1, N2), Np)
    residual = _pad_cols(_residual(residual, M, N2, name), Np)
    if residual is not None and residual.data_ptr() % 8:
        residual = residual.clone()  # read 2 values at a time
    w1t = _k_major(w1_data) if (Kp, Fp) == (K, N1) else \
        _padded(w1_data, Kp, Fp)
    w2t = _k_major(w2_data) if (Fp, Np) == (N1, N2) else \
        _padded(w2_data, Fp, Np)
    _check_cuda(name, x2.device, w1_data=w1t, cs1=cs1, b1=b1, w2_data=w2t,
                cs2=cs2, b2=b2, residual=residual)
    return x2, w1t, w2t, cs1, b1, cs2, b2, residual, N2


def _unpad(out: torch.Tensor, N: int, lead) -> torch.Tensor:
    """A kernel's output [M, Np] sliced back to N columns, as [*lead, N]."""
    if out.shape[1] != N:
        out = out[:, :N].contiguous()
    return out.reshape(*lead, N)


def int8w_mlp_chained(x: torch.Tensor, w1_data: torch.Tensor,
                      cs1: torch.Tensor, b1: torch.Tensor,
                      w2_data: torch.Tensor, cs2: torch.Tensor,
                      b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """`int8w_mlp` as four kernels on the card (quantize, GEMM with an f32
    inner output, quantize, GEMM): JAX's two-linear fall-back, for widths
    the fused kernel does not take. Bit for bit the fused result."""
    if x.device.type != "cuda":
        raise ValueError(f"int8w_mlp_chained: unsupported device {x.device}")
    x2, w1t, w2t, cs1, b1, cs2, b2, residual, N2 = _mlp_args(
        "int8w_mlp_chained", x, w1_data, cs1, b1, w2_data, cs2, b2, residual,
        out_dtype)
    xi, sx = _quant_rows(x2)
    inner = _gemm(xi, sx, w1t, cs1, b1, None, True, torch.float32)
    yi, sy = _quant_rows(inner)
    out = _gemm(yi, sy, w2t, cs2, b2, residual, False, out_dtype)
    _build.launch_counts["int8w_mlp_chained"] += 1
    return _unpad(out, N2, x.shape[:-1])


def int8w_mlp(x: torch.Tensor, w1_data: torch.Tensor, cs1: torch.Tensor,
              b1: torch.Tensor, w2_data: torch.Tensor, cs2: torch.Tensor,
              b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """MLP block x @ w1 -> +b1, gelu -> @ w2 -> +b2 (+ residual) over decoded
    int8 weights; the inner activation is requantized from f32, as in the TPU
    kernel. CPU tensors take the plain twin; CUDA tensors launch the fused
    kernel, or, for widths it does not take (`mlp_fits`),
    `int8w_mlp_chained`."""
    if x.device.type == "cpu":
        return int8w_mlp_plain(x, w1_data, cs1, b1, w2_data, cs2, b2,
                               residual, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8w_mlp: unsupported device {x.device}")
    K = x.shape[-1]
    N1, N2 = w1_data.shape[1], w2_data.shape[1]
    if not mlp_fits(_round_up(K, K_ALIGN), _round_up(N1, K_ALIGN),
                    _round_up(N2, N_ALIGN)):
        if (K, N1, N2) not in _chained_shapes:
            _chained_shapes.add((K, N1, N2))
            _log.warning("int8w_mlp: widths %d -> %d -> %d do not fit the "
                         "fused kernel; running int8w_mlp_chained", K, N1, N2)
        return int8w_mlp_chained(x, w1_data, cs1, b1, w2_data, cs2, b2,
                                 residual, out_dtype)
    x2, w1t, w2t, cs1, b1, cs2, b2, residual, N2 = _mlp_args(
        "int8w_mlp", x, w1_data, cs1, b1, w2_data, cs2, b2, residual,
        out_dtype)
    (M, K), F, N = x2.shape, w1t.shape[0], w2t.shape[0]
    plan = mlp_plan(M, K, F, N, _active_clusters(K, N))
    if plan is None:
        raise RuntimeError(f"int8w_mlp: the card runs no cluster of the fused "
                           f"kernel at {K} -> {F} -> {N}")
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    _build.check(_build.function("dlm_int8_mlp")(
        x2.data_ptr(), w1t.data_ptr(), cs1.data_ptr(), _ptr(b1),
        w2t.data_ptr(), cs2.data_ptr(), _ptr(b2), _ptr(residual),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, K, F, N,
        plan["cluster"], _stream(x2.device),
        int(residual is not None and residual.dtype == torch.float32)),
        "int8_mlp")
    _build.launch_counts["int8w_mlp"] += 1
    return _unpad(out, N2, x.shape[:-1])


_chained_shapes: set = set()  # (K, F, N) already logged by int8w_mlp
