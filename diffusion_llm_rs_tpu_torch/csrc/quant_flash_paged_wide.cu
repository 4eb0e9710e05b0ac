// Flash attention over one paged, quantized KV sequence at head widths past
// 256, for Hopper (sm_90a): `PagedKVCache.attend` at wide heads.
//
// With csrc/quant_flash_paged.cu (heads of 8 to 256) it replaces the TPU
// kernel `_kernel` (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:34,
// behind `paged_attention`, :140), which takes D % 128 == 0 (:174; JAX's
// XLA `_fallback` serves the other widths). The design is mode kPaged of
// csrc/wide_flash.cuh: D a runtime argument, one instance a bit width and
// page tile (32, 64 or 128 tokens), one page a step of the online softmax,
// the lse written beside the output.

#include "wide_flash.cuh"

extern "C" {

// dlm_paged_attention's arguments (csrc/quant_flash_paged.cu) for any D
// that is a multiple of 8. A slot outside the pool traps.
int dlm_paged_attention_wide(const void* q, const void* page_table,
                             const void* page_tokens, const void* k_data,
                             const void* k_scale, const void* k_zp,
                             const void* v_data, const void* v_scale,
                             const void* v_zp, void* out, void* lse, int BH,
                             int Sq, int D, int n_pages, int n_slots, int P,
                             int bits, float sm_scale, void* stream) {
  if (D < 8 || D % 8 || n_pages < 1 || P < 8 || P > 128 || P % 8)
    return (int)cudaErrorInvalidValue;
  wide_flash::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.page_table = static_cast<const int*>(page_table);
  a.page_tokens = static_cast<const int*>(page_tokens);
  a.k_data = static_cast<const uint8_t*>(k_data);
  a.k_scale = static_cast<const float*>(k_scale);
  a.k_zp = static_cast<const float*>(k_zp);
  a.v_data = static_cast<const uint8_t*>(v_data);
  a.v_scale = static_cast<const float*>(v_scale);
  a.v_zp = static_cast<const float*>(v_zp);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.Z = BH;
  a.Sq = Sq;
  a.D = D;
  a.n_pages = n_pages;
  a.n_slots = n_slots;
  a.P = P;
  a.sm = sm_scale;
  const int PT = P <= 32 ? 32 : P <= 64 ? 64 : 128;
  return wide_flash::launch_bits<wide_flash::kPaged>(
      a, bits, PT, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
