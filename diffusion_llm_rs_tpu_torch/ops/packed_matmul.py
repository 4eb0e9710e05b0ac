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
multiple of 8 (act_bits 16) or 16 (act_bits 8), and the wrapper raises on
anything else. The residual of a layer is not part of these functions:
`ops.matmul.linear` adds it afterwards, in `out_dtype`.
"""

from __future__ import annotations

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
    need = 16 if w.act_bits == 8 else 8
    if w.N % 4 or Kp % need:
        raise ValueError(
            f"packed matmul (act_bits={w.act_bits}): needs N % 4 == 0 and "
            f"K * bits / 8 a multiple of {need}, got K={w.K} N={w.N} "
            f"bits={w.bits}")
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
    if w.act_bits == 8:
        out = _launch8(x2, w, bias, gelu, out_dtype)
    else:
        out = _launch16(x2.to(torch.bfloat16).contiguous(), w, bias, gelu,
                        out_dtype)
    return out.reshape(*lead, w.N)
