// Flash attention over one paged, quantized KV sequence at the head widths
// between the instances of csrc/quant_flash_paged.cu, for Hopper (sm_90a).
//
// Replaces, with that source, the TPU kernel `_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:34, behind
// `paged_attention`, :140): here any head width D that is a multiple of 8
// up to 256 and not one of 16, 32, 64, 128, 192 and 256 (JAX serves those
// through its XLA `_fallback`: its kernel needs D % 128 == 0). The design is
// that source's (`quant_flash_kernel` in csrc/quant_flash.cuh); a head of D
// runs in the instance of the smallest of those widths DK that holds it,
// its tiles zero in the columns past D (the loader `Paged<BITS, DK, PT,
// true>` reads pool rows of D bytes 8 at a time), so the work, and the
// bound, are DK's. A source of its own keeps the exact widths' instances
// free of this loader's code, and builds beside them: run at D = DK on an
// H100, this loader took 0.83-1.30x the exact one's time (faster at pages
// of 32 and at 1 bit, slower at 8 bits and at DK = 128, 192 and 256;
// PERF.md), so neither serves every width.

#include "quant_flash.cuh"

extern "C" {

// dlm_paged_attention's arguments, for D a multiple of 8 up to 256.
int dlm_paged_attention_padded(const void* q, const void* page_table,
                               const void* page_tokens, const void* k_data,
                               const void* k_scale, const void* k_zp,
                               const void* v_data, const void* v_scale,
                               const void* v_zp, void* out, void* lse, int BH,
                               int Sq, int D, int n_pages, int n_slots, int P,
                               int bits, float sm_scale, void* stream) {
  return quant_flash::paged_attention<true>(
      q, page_table, page_tokens, k_data, k_scale, k_zp, v_data, v_scale,
      v_zp, out, lse, BH, Sq, D, n_pages, n_slots, P, bits, sm_scale, stream);
}

}  // extern "C"
