"""Quantization library: 1/2/4/8-bit affine quantization with bit packing,
fp8, and calibration (counterpart of `diffusion_llm_rs_tpu/quant`)."""

from diffusion_llm_rs_tpu_torch.quant.core import (
    SUPPORTED_BITS,
    Fp8Tensor,
    QuantizedTensor,
    compute_qparams,
    dequantize,
    dequantize_tree,
    pack_bits,
    packed_last_dim,
    qmax_for_bits,
    quantize,
    quantize_fp8,
    quantize_tree,
    unpack_bits,
)
from diffusion_llm_rs_tpu_torch.quant.calibrate import (
    AdaptiveQuantizer,
    CalibrationData,
    QuantizationParams,
    QuantileSketch,
)

__all__ = [
    "SUPPORTED_BITS",
    "Fp8Tensor",
    "QuantizedTensor",
    "compute_qparams",
    "dequantize",
    "dequantize_tree",
    "pack_bits",
    "packed_last_dim",
    "qmax_for_bits",
    "quantize",
    "quantize_fp8",
    "quantize_tree",
    "unpack_bits",
    "AdaptiveQuantizer",
    "CalibrationData",
    "QuantizationParams",
    "QuantileSketch",
]
