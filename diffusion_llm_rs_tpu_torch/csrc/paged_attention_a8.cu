// Batched paged attention with int8 activations, for Hopper (sm_90a).
//
// Replaces the `act_bits=8` path of the TPU kernel `_batched_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:288 and :520-653,
// behind `batched_paged_attention(act_bits=8)`, :686): both products of
// attention on the int8 tensor cores. q is quantized per (head, row) once, at
// load; the centered K/V levels are unpacked once per call by
// csrc/paged_unpack.cu (K [token][d], V^T [d][token]: int8 wgmma wants both
// operands K-major); the softmax weights folded with the V scale are
// quantized per (page, query). The kernel, its design and its arithmetic are
// `paged_flash_kernel<true, D, PT>` in csrc/paged_flash.cuh.
//
// What bounds it on an H100: at serve_paged (B = 2, H = 12, Sq = Skv = 4096,
// D = 64, 4-bit pages of 128) the dots are 103 G int8 operations, 0.052 ms on
// the int8 tensor cores. It cannot come near that: each of the 402.7 M logits
// costs the CUDA cores the logit epilogue (the int32 sum as a float, * sq,
// * ka', kb' * qsum), max, exp, row sum, w = p * vs, the page maximum of w,
// the correction sum, the IEEE quotient w / sw that the contract asks for,
// its rounding to an int and its share of the byte packing, of folding the
// page's int32 P.V sum into o and of the loop: 34.2 instructions a logit in
// this instance's page loop (scripts/paged_sass.py), an issue floor of 0.41
// ms at 1,980 MHz. The design keeps that floor low: no conversion-unit
// instruction is left in the loop (ints and floats cross by exact 1.5 * 2^23
// arithmetic), the quotient is three fma-class instructions after one
// correctly rounded reciprocal of sw a row (instead of a full division a
// weight), the sidecars are float2 loads, and only a page whose tile is not
// full is masked.

#include "paged_flash.cuh"

extern "C" {

// q [B, H, Sq, D] bf16; page_tokens int32 [B, n_max]; n_pages int32 [B]; k,
// vt, side: the int8-mode scratch of dlm_paged_unpack with tiles of PT = 32,
// 64 or 128 tokens; D = 16, 32, 64 or 128. Writes out f32 [B, H, Sq, D]
// and lse f32 [B, H, Sq]. Returns cudaErrorInvalidValue for a shape it
// was not built for.
int dlm_batched_paged_attention_a8(const void* q, const void* page_tokens,
                                   const void* n_pages, const void* k,
                                   const void* vt, const void* side, void* out,
                                   void* lse, int B, int H, int Sq, int D,
                                   int n_max, int PT, void* stream) {
  return paged_flash::run<true>(q, page_tokens, n_pages, k, vt, side, out, lse,
                                B, H, Sq, D, n_max, PT, stream);
}

}  // extern "C"
