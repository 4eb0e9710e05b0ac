// Flash attention over contiguous per-token-quantized K/V at the head widths
// between the instances of csrc/quant_flash_contig.cu, for Hopper (sm_90a).
//
// Replaces, with that source, the TPU kernel `_attn_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_attention.py:99, behind `attention`,
// :155), which JAX runs at every D % (8 * vpb) == 0: here any D that is a
// multiple of 8 up to 256 and not one of 16, 32, 64, 128, 192 and 256. The
// design is that source's (`quant_flash_kernel` in csrc/quant_flash.cuh);
// a head of D runs in the instance of the smallest of those widths DK that
// holds it, its tiles zero in the columns past D (the loader `Contig<BITS,
// DK, true>` reads packed rows of D/vpb bytes, the largest power of two up
// to 8 that divides a row at a time), so the work, and the bound, are DK's:
// the tensor cores multiply DK columns and the ex2 unit takes the same exp
// a logit. A source of its own keeps the exact widths' instances free of
// this loader's code, and builds beside them.

#include "quant_flash.cuh"

extern "C" {

// dlm_quant_attention's arguments, for D a multiple of 8 up to 256; the
// packed K/V aligned to the largest power of two up to 8 that divides
// D * bits / 8.
int dlm_quant_attention_padded(const void* q, const void* k_data,
                               const void* k_scale, const void* k_zp,
                               const void* v_data, const void* v_scale,
                               const void* v_zp, void* out, int BH, int Sq,
                               int Skv, int D, int bits, float sm_scale,
                               void* stream) {
  return quant_flash::quant_attention<true>(q, k_data, k_scale, k_zp, v_data,
                                            v_scale, v_zp, out, BH, Sq, Skv,
                                            D, bits, sm_scale, stream);
}

}  // extern "C"
