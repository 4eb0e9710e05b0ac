"""Linear layer over packed 1/2/4/8-bit weights, dequantized inside the kernel.

Counterpart of the packed half of `diffusion_llm_rs_tpu/ops/pallas_matmul.py`:
`matmul(x, w)` over a `MatmulWeight` (defined, with `prepare`, in
`ops/int8_matmul.py` and re-exported here), dispatching on `w.act_bits`:

  - 16 (TPU kernels `_kernel_full` / `_kernel` / `_kernel_bias`): x rounded to
    bf16, W unpacked to `bf16((lv - zp) * scale)`, bf16 x bf16 products summed
    in f32, then `+ bias -> gelu` in f32 and one rounding to `out_dtype`.
  - 8 (TPU kernel `_kernel_i8`): activations quantized per token to int8 by
    `quantize_act_i8` (from x as f32, not rounded to bf16), W unpacked onto
    its per-column int8 grid `clip(round((lv - zp) * (scale * (1 / cs))),
    +-127)`, int8 x int8 -> int32, then `* sx[m] * cs[n] + bias -> gelu`.

On a CUDA tensor the weight stays packed in device memory. act_bits 16
launches the wgmma kernel of `csrc/packed_gemm.cu`, whose A operand is the
weight dequantized in registers tile by tile in the K loop. act_bits 8
launches three kernels, as the TPU kernel fills its int8 scratch once a
call: the row quantization, `unpack_i8` (the packed weight onto its int8
column grid, K-major, into a per-call scratch of K * N bytes) and the s8
`wgmma` core of `csrc/int8_gemm.cu` that `int8w_matmul` runs on. On a CPU
tensor they run the plain versions `matmul_plain` / `a8_matmul_reference`,
which repeat the kernels' roundings in their order. The kernels serve any M
(the ragged edge is masked); they take N % 4 == 0 and K * bits / 8 a
multiple of 8 (act_bits 16) or 16 (act_bits 8). A weight off that alignment
runs padded, as JAX's wrapper answers at every K and N: `_aligned` holds,
once a weight, a copy with zero levels in the rows and columns past it (a
new group of scale 1 where K's groups need one), and x's K is padded with
zeros per call; zeros in x meet the padded rows, so the sums are those of
the weight itself, and the output is sliced back to N. The residual of a
layer is not part of these functions: `ops.matmul.linear` adds it
afterwards, in `out_dtype`.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import (  # noqa: F401
    MatmulWeight,
    _check_cuda,
    _epilogue_vec,
    _gemm,
    _int_dot,
    _OUT_DTYPES,
    _ptr,
    _quant_rows,
    _stream,
    gelu_tanh,
    prepare,
    quant_rows_plain,
)


def quantize_act_i8(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8 activation quantization:
    [M, K] -> (int8 levels [M, K], f32 scales [M, 1]). bf16 and f32 rows are
    quantized as given (other types through f32); on the card by the
    `dlm_quant_rows` kernel, on the CPU by its plain version."""
    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.to(torch.float32)
    if x2.device.type == "cuda":
        xi, sx = _quant_rows(x2.contiguous())
        return xi, sx.reshape(-1, 1)
    return quant_rows_plain(x2.to(torch.float32))


def regrid_int8(w: MatmulWeight) -> torch.Tensor:
    """The int8 [K, N] matrix the act_bits=8 kernel multiplies by: the packed
    levels on the weight's per-column grid."""
    lv = w.levels().to(torch.float32)
    G = w.K // w.scale.shape[0]
    lv = lv.reshape(-1, G, w.N)
    inv_cs = 1.0 / w.col_scale
    val = (lv - w.zero_point[:, None, :]) * (w.scale[:, None, :] *
                                             inv_cs[:, None, :])
    return (torch.round(val).clamp(-127.0, 127.0)
            .to(torch.int32).to(torch.int8).reshape(w.K, w.N))


def unpack_i8(w: MatmulWeight) -> torch.Tensor:
    """`regrid_int8(w)` K-major: the int8 [N, K] operand of the act_bits=8
    product. On the card the `dlm_packed_unpack_i8` kernel writes it into a
    fresh scratch (a launch of `matmul_a8`, not counted apart); on the CPU
    its plain version."""
    if w.data.device.type != "cuda":
        return regrid_int8(w).t().contiguous()
    wt = torch.empty((w.N, w.K), dtype=torch.int8, device=w.data.device)
    _build.check(_build.function("dlm_packed_unpack_i8")(
        w.data.data_ptr(), w.scale.data_ptr(), w.zero_point.data_ptr(),
        w.col_scale.data_ptr(), wt.data_ptr(), w.N, w.K, w.bits,
        w.group_size, _stream(w.data.device)), "packed_unpack_i8")
    return wt


def _epilogue(y, N, bias, activation, out_dtype):
    if bias is not None:
        y = y + bias.reshape(1, N).to(torch.float32)
    if activation == "gelu":
        y = gelu_tanh(y)
    return y.to(out_dtype)


def a8_matmul_reference(x2: torch.Tensor, w: MatmulWeight,
                        bias: Optional[torch.Tensor] = None,
                        activation: Optional[str] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the act_bits=8 kernel: x2 [M, K] -> [M, N]."""
    xi, sx = quantize_act_i8(x2)
    y = _int_dot(xi, regrid_int8(w)).to(torch.float32) * sx * w.col_scale
    return _epilogue(y, w.N, bias, activation, out_dtype)


def matmul_plain(x2: torch.Tensor, w: MatmulWeight,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the act_bits=16 kernel: x2 [M, K] -> [M, N]. The
    product of the bf16-rounded operands is taken in f32."""
    xf = x2.to(torch.bfloat16).to(torch.float32)
    y = xf @ w.dequantize(torch.bfloat16).to(torch.float32)
    return _epilogue(y, w.N, bias, activation, out_dtype)


def _check_weight(w: MatmulWeight) -> None:
    Kp = w.K * w.bits // 8
    rows = w.K // w.group_size
    if (w.K % w.group_size or w.data.dtype != torch.uint8
            or tuple(w.data.shape) != (Kp, w.N)
            or tuple(w.scale.shape) != (rows, w.N)
            or tuple(w.zero_point.shape) != (rows, w.N)
            or w.scale.dtype != torch.float32
            or w.zero_point.dtype != torch.float32):
        raise ValueError("packed matmul: MatmulWeight fields do not match "
                         f"K={w.K} N={w.N} bits={w.bits} G={w.group_size}")
    if w.act_bits == 8 and (w.col_scale is None
                            or w.col_scale.dtype != torch.float32
                            or w.col_scale.numel() != w.N):
        raise ValueError("packed matmul: act_bits=8 needs an f32 col_scale "
                         "with N entries")


def _alignment(w: MatmulWeight) -> Tuple[int, int]:
    """(K, N) of the kernels' layout that holds w: N a multiple of 4; K a
    multiple of the values that fill 8 bytes of a packed column (16 at
    act_bits 8) and, where K is split into groups, of the group size."""
    step = (16 if w.act_bits == 8 else 8) * (8 // w.bits)
    if w.group_size < w.K:
        step = step * w.group_size // math.gcd(step, w.group_size)
    return -(-w.K // step) * step, -(-w.N // 4) * 4


# Padded copies of weights off the kernels' alignment, made once a weight:
# id(w.data) -> (weakref, version, padded MatmulWeight).
_aligned_copies: dict = {}


def _aligned(w: MatmulWeight) -> MatmulWeight:
    """w in the kernels' layout (`_alignment`): w itself where it fits, else
    a copy with zero levels in the rows and columns past it, scale 1 and
    zero point 0 in the scale rows and columns past it (and col_scale 1),
    block-packed along the padded K."""
    K, N = _alignment(w)
    if (K, N) == (w.K, w.N):
        return w
    key = id(w.data)
    hit = _aligned_copies.get(key)
    if hit is not None and hit[0]() is w.data and hit[1] == w.data._version:
        return hit[2]
    dev, vpb = w.data.device, 8 // w.bits
    G = w.group_size if w.group_size < w.K else K
    lv = torch.zeros((K, N), dtype=torch.uint8, device=dev)
    lv[:w.K, :w.N] = w.levels()
    scale = torch.ones((K // G, N), dtype=torch.float32, device=dev)
    zp = torch.zeros_like(scale)
    scale[:w.scale.shape[0], :w.N] = w.scale
    zp[:w.scale.shape[0], :w.N] = w.zero_point
    blocks = lv.reshape(vpb, K // vpb, N)
    packed = blocks[0].clone()
    for b in range(1, vpb):
        packed |= blocks[b] << (b * w.bits)
    col_scale = None
    if w.col_scale is not None:
        col_scale = torch.ones((1, N), dtype=torch.float32, device=dev)
        col_scale[:, :w.N] = w.col_scale.reshape(1, w.N)
    out = MatmulWeight(data=packed, scale=scale, zero_point=zp, bits=w.bits,
                       K=K, N=N, group_size=G, act_bits=w.act_bits,
                       col_scale=col_scale)
    _aligned_copies[key] = (
        weakref.ref(w.data, lambda _, k=key: _aligned_copies.pop(k, None)),
        w.data._version, out)
    return out


def _check_operands(name, device, w: MatmulWeight, bias, **x):
    tensors = dict(x, data=w.data, scale=w.scale, zero_point=w.zero_point,
                   col_scale=w.col_scale, bias=bias)
    _check_cuda(name, device, **tensors)
    for arg, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _launch16(x2, w: MatmulWeight, bias, gelu: bool, out_dtype):
    M = x2.shape[0]
    out = torch.empty((M, w.N), dtype=out_dtype, device=x2.device)
    _check_operands("matmul", x2.device, w, bias, x=x2)
    # the K loop splits over blocks where the output tiles alone do not fill
    # the card; a second kernel sums the f32 partials in order
    splits = _build.function("dlm_packed_gemm_splits")(M, w.N, w.K, w.bits)
    ws = (torch.empty((splits, M, w.N), dtype=torch.float32, device=x2.device)
          if splits > 1 else None)
    _build.check(_build.function("dlm_packed_gemm")(
        x2.data_ptr(), w.data.data_ptr(), w.scale.data_ptr(),
        w.zero_point.data_ptr(), _ptr(bias), int(gelu), out.data_ptr(),
        int(out_dtype == torch.bfloat16), M, w.N, w.K, w.bits, w.group_size,
        _ptr(ws), splits, _stream(x2.device)), "matmul")
    _build.launch_counts["matmul"] += 1
    return out


def _launch8(x2, w: MatmulWeight, bias, gelu: bool, out_dtype):
    _check_operands("matmul_a8", x2.device, w, bias)
    xi, sx = quantize_act_i8(x2)  # x unchecked: this reads a contiguous copy
    out = _gemm(xi, sx.reshape(-1), unpack_i8(w), w.col_scale, bias, None,
                gelu, out_dtype)
    _build.launch_counts["matmul_a8"] += 1
    return out


def matmul(x: torch.Tensor, w: MatmulWeight, out_dtype=torch.float32,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None) -> torch.Tensor:
    """x [..., K] @ W (+ bias, + activation) -> [..., N] in `out_dtype`, the
    weight dequantized inside the kernel. CPU tensors take the plain
    versions; CUDA tensors launch the kernel."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if w.act_bits not in (8, 16):
        raise ValueError(f"act_bits must be 8 or 16, got {w.act_bits}")
    lead = x.shape[:-1]
    K = x.shape[-1]
    if K != w.K:
        raise ValueError(f"contraction mismatch: x K={K}, w K={w.K}")
    x2 = x.reshape(-1, K)
    if x.device.type == "cpu":
        plain = a8_matmul_reference if w.act_bits == 8 else matmul_plain
        return plain(x2, w, bias, activation, out_dtype).reshape(*lead, w.N)
    if x.device.type != "cuda":
        raise ValueError(f"packed matmul: unsupported device {x.device}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"packed matmul: out_dtype {out_dtype} not f32/bf16")
    _check_weight(w)
    bias = _epilogue_vec(bias, w.N, "packed matmul")
    gelu = activation == "gelu"
    N = w.N
    w = _aligned(w)
    if w.N != N and bias is not None:
        bias = torch.nn.functional.pad(bias, (0, w.N - N))
    if w.K != K:
        x2 = torch.nn.functional.pad(x2, (0, w.K - K))
    if w.act_bits == 8:
        out = _launch8(x2, w, bias, gelu, out_dtype)
    else:
        out = _launch16(x2.to(torch.bfloat16).contiguous(), w, bias, gelu,
                        out_dtype)
    if w.N != N:
        out = out[:, :N].contiguous()
    return out.reshape(*lead, N)
