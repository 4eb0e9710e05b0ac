// Flash attention over contiguous per-token-quantized K/V, for Hopper
// (sm_90a): the kernel of the phase-aware cached sampler.
//
// Replaces the TPU kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py:99, behind `attention`, :155): q [BH, Sq, D] bf16
// attends over K and V stored as packed 8/4/2/1-bit levels, [BH, Skv, D/vpb]
// packed along D, with one f32 scale and zero-point per (bh, token); the
// packed bytes are never dequantized into device memory. The kernel, its
// design and its arithmetic are `quant_flash_kernel<Contig<BITS, D>, D>`
// in csrc/quant_flash.cuh; heads of D = 16, 32, 64 and 128 at 1/2/4/8 bits
// are its sixteen instances. Every Sq >= 1 and Skv >= 1 runs it (the TPU
// wrapper leaves ragged shapes to XLA).
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

namespace {

using namespace quant_flash;

template <int D>
int launch_bits(const ContigArgs& la, const Out& oa, int BH, int bits,
                cudaStream_t st) {
  switch (bits) {
    case 1: return launch<Contig<1, D>, D>(la, oa, BH, st);
    case 2: return launch<Contig<2, D>, D>(la, oa, BH, st);
    case 4: return launch<Contig<4, D>, D>(la, oa, BH, st);
    case 8: return launch<Contig<8, D>, D>(la, oa, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [BH, Sq, D] bf16 (16-byte aligned); k_data, v_data uint8 [BH, Skv,
// D * bits / 8] (aligned to 8 bytes, or to the row where a row is 4 or 2
// bytes); k_scale, k_zp, v_scale, v_zp f32 [BH, Skv]; D = 16, 32, 64 or 128;
// bits 1, 2, 4 or 8; Sq, Skv >= 1. Writes out f32 [BH, Sq, D]. Returns
// cudaErrorInvalidValue for a shape it was not built for.
int dlm_quant_attention(const void* q, const void* k_data, const void* k_scale,
                        const void* k_zp, const void* v_data,
                        const void* v_scale, const void* v_zp, void* out,
                        int BH, int Sq, int Skv, int D, int bits,
                        float sm_scale, void* stream) {
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  const ContigArgs la{static_cast<const uint8_t*>(k_data),
                      static_cast<const float*>(k_scale),
                      static_cast<const float*>(k_zp),
                      static_cast<const uint8_t*>(v_data),
                      static_cast<const float*>(v_scale),
                      static_cast<const float*>(v_zp), Skv};
  const Out oa{static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out),
               nullptr, Sq, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bits<16>(la, oa, BH, bits, st);
    case 32: return launch_bits<32>(la, oa, BH, bits, st);
    case 64: return launch_bits<64>(la, oa, BH, bits, st);
    case 128: return launch_bits<128>(la, oa, BH, bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
