// Flash attention over contiguous per-token-quantized K/V at head widths
// past 256, for Hopper (sm_90a): the scan sampler's kernel at wide heads.
//
// With csrc/quant_flash_contig.cu (heads of 8 to 256) it replaces the TPU
// kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:99,
// behind `attention`, :155), which takes D % (8 * vpb) == 0 within its VMEM
// budget (:165-176). The design is mode kContig of csrc/wide_flash.cuh: D a
// runtime argument, one instance a bit width (1, 2, 4, 8), KV tiles of 64
// tokens, each packed row of D/vpb bytes read a byte an element (a row of
// 33 bytes at 1 bit and D = 264 needs no alignment).

#include "wide_flash.cuh"

extern "C" {

// dlm_quant_attention's arguments (csrc/quant_flash_contig.cu) for any D
// that is a multiple of 8; the packed K/V need no alignment.
int dlm_quant_attention_wide(const void* q, const void* k_data,
                             const void* k_scale, const void* k_zp,
                             const void* v_data, const void* v_scale,
                             const void* v_zp, void* out, int BH, int Sq,
                             int Skv, int D, int bits, float sm_scale,
                             void* stream) {
  if (D < 8 || D % 8 || Skv < 1) return (int)cudaErrorInvalidValue;
  wide_flash::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_data = static_cast<const uint8_t*>(k_data);
  a.k_scale = static_cast<const float*>(k_scale);
  a.k_zp = static_cast<const float*>(k_zp);
  a.v_data = static_cast<const uint8_t*>(v_data);
  a.v_scale = static_cast<const float*>(v_scale);
  a.v_zp = static_cast<const float*>(v_zp);
  a.out = out;
  a.Z = BH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.sm = sm_scale;
  return wide_flash::launch_bits<wide_flash::kContig>(
      a, bits, 64, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
