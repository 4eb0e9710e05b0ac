// Flash attention over contiguous per-token-quantized K/V, for Hopper
// (sm_90a): the kernel of the phase-aware cached sampler.
//
// Replaces the TPU kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py:99, behind `attention`, :155): q [BH, Sq, D] bf16
// attends over K and V stored as packed 8/4/2/1-bit levels, [BH, Skv, D/vpb]
// packed along D, with one f32 scale and zero-point per (bh, token); the
// packed bytes are never dequantized into device memory. The kernel, its
// design and its arithmetic are `quant_flash_kernel<Contig<BITS, D>, D>`
// in csrc/quant_flash.cuh; heads of D = 16, 32, 64, 128, 192 and 256 at
// 1/2/4/8 bits are its 24 instances (the other multiples of 8 up to 256
// run padded to those widths, csrc/quant_flash_contig_padded.cu). Every
// Sq >= 1 and Skv >= 1 runs it (the TPU wrapper leaves ragged shapes to
// XLA).
//
// What bounds it on an H100: at the scan sampler's shape (BH = 96, Sq = Skv
// = 256, D = 64, 4 bits) the call moves about 11 MB (q, packed K and V, four
// sidecars, the f32 output) for 1.6 GFLOP, so bytes bound it (0.0034 ms); at
// BH = 24, S = 1024 the bf16 tensor cores do (0.0065 ms). Both are far below
// what a block spends outside its tile loop (launch, q, the first tile's
// load and unpack, the epilogue), so the design unpacks each KV tile once a
// 128-query block, not once per 64 queries, and keeps two blocks on an SM
// at D <= 64: the 192 blocks of both sampler shapes run in one wave. At
// heads of 16 this design still takes each logit's exp on the MUFU ex2 unit
// (16 a clock an SM): at BH = 128, S = 1024 that is 0.032 ms, above the
// tensor cores' 0.0087 ms, a floor of this design and not of the card (exp2
// can also run as a polynomial on the FMA pipes).

#include "quant_flash.cuh"

extern "C" {

// q [BH, Sq, D] bf16 (16-byte aligned); k_data, v_data uint8 [BH, Skv,
// D * bits / 8] (aligned to 8 bytes, or to the row where a row is 4 or 2
// bytes); k_scale, k_zp, v_scale, v_zp f32 [BH, Skv]; D = 16, 32, 64, 128,
// 192 or 256 (other multiples of 8 up to 256:
// csrc/quant_flash_contig_padded.cu); bits 1, 2, 4 or 8; Sq, Skv >= 1.
// Writes out f32 [BH, Sq, D]. Returns cudaErrorInvalidValue for a shape it
// was not built for.
int dlm_quant_attention(const void* q, const void* k_data, const void* k_scale,
                        const void* k_zp, const void* v_data,
                        const void* v_scale, const void* v_zp, void* out,
                        int BH, int Sq, int Skv, int D, int bits,
                        float sm_scale, void* stream) {
  return quant_flash::quant_attention<false>(q, k_data, k_scale, k_zp, v_data,
                                             v_scale, v_zp, out, BH, Sq, Skv,
                                             D, bits, sm_scale, stream);
}

}  // extern "C"
