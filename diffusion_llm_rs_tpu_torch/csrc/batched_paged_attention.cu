// Batched paged attention with bf16 activations, for Hopper (sm_90a).
//
// Replaces the bf16 path of the TPU kernel `_batched_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:288, behind
// `batched_paged_attention`, :686): B slots, each with its own page table and
// page count, over one pool of quantized pages. The pages are unpacked once
// per call by csrc/paged_unpack.cu; the kernel itself, its design and its
// arithmetic are `paged_flash_kernel<false, D, PT>` in csrc/paged_flash.cuh.
//
// What bounds it on an H100: at serve_paged (B = 2, H = 12, Sq = Skv = 4096,
// D = 64, pages of 128) the two dots are 4*B*H*Sq*Skv*D = 103 GFLOP, 0.104 ms
// on the bf16 tensor cores; the bytes (the unpacked pages, read from L2 by
// each query tile) do not bound it. Every one of the B*H*Sq*Skv = 402.7 M
// logits also costs the CUDA cores the sidecar epilogue raw * ka' - kb *
// qsum, the running max, exp, the row sum, the correction sum and its share
// of the bf16 packing, of rescaling o and of the loop: 15.6 instructions a
// logit in this instance's page loop (scripts/paged_sass.py), an issue floor
// of 0.188 ms at 1,980 MHz, above the tensor cores' bound. So the design
// keeps that count small: the epilogue reads its sidecars as float2 pairs,
// the mask is compiled only into tiles that are not full, the exp is one fma
// and one ex2, and the P.V product of one page runs under the S of the next.
// Heads and tiles of up to 64 run three consumer warpgroups (160 registers),
// larger ones two (232).

#include "paged_flash.cuh"

extern "C" {

// q [B, H, Sq, D] bf16; page_tokens int32 [B, n_max]; n_pages int32 [B]; k,
// v, side: the bf16-mode scratch of dlm_paged_unpack with tiles of PT = 32,
// 64 or 128 tokens; D = 16, 32, 64 or 128. Writes out f32 [B, H, Sq, D]
// and lse f32 [B, H, Sq]. Returns cudaErrorInvalidValue for a shape it
// was not built for.
int dlm_batched_paged_attention(const void* q, const void* page_tokens,
                                const void* n_pages, const void* k,
                                const void* v, const void* side, void* out,
                                void* lse, int B, int H, int Sq, int D,
                                int n_max, int PT, void* stream) {
  return paged_flash::run<false>(q, page_tokens, n_pages, k, v, side, out, lse,
                                 B, H, Sq, D, n_max, PT, stream);
}

}  // extern "C"
