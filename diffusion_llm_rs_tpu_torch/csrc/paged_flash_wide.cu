// Batched paged attention at head widths past 2048, bf16 activations, for
// Hopper (sm_90a).
//
// With csrc/batched_paged_attention.cu (heads of 8 to 256) and
// csrc/paged_flash_cluster.cu (264 to 2048, and the int8 path at every width
// past 256) it replaces the bf16 path of the TPU kernel `_batched_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:288, behind
// `batched_paged_attention`, :686), which takes G*D % 128 == 0 (:757; its
// XLA `_batched_fallback` serves the other widths). As at the other widths,
// csrc/paged_unpack.cu first unpacks every live page into a scratch, here of
// rows of DK = D rounded up to 64, zero past D; the attention over it is
// mode kScratch16 of csrc/wide_flash.cuh: D a runtime argument, one
// instance a page tile (32, 64 or 128 tokens). From 264 to 2048 the cluster
// design of csrc/wide_cluster_flash.cuh serves (it issues S once), so this
// entry point refuses those widths.

#include "wide_cluster_flash.cuh"
#include "wide_flash.cuh"

extern "C" {

// q [B, H, Sq, D] bf16 (16-byte aligned), D a multiple of 8 past 2048;
// page_tokens int32 [B, n_max]; n_pages int32 [B]; k, v, side:
// dlm_paged_unpack's bf16 scratch of pages of P tokens in tiles of PT = 32,
// 64 or 128, rows of DK (a multiple of 64, at least D). Writes out f32 [B,
// H, Sq, D] and lse f32 [B, H, Sq]. Returns cudaErrorInvalidValue for a
// shape it does not take.
int dlm_batched_paged_attention_wide(const void* q, const void* page_tokens,
                                     const void* n_pages, const void* k,
                                     const void* v, const void* side,
                                     void* out, void* lse, int B, int H,
                                     int Sq, int D, int n_max, int PT, int DK,
                                     int P, void* stream) {
  if (D <= wide_cluster::kMaxD || D % 8 || DK % 64 || DK < D || P < 8 ||
      P > PT || P % 8 || (PT != 32 && PT != 64 && PT != 128))
    return (int)cudaErrorInvalidValue;
  wide_flash::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.page_tokens = static_cast<const int*>(page_tokens);
  a.slot_pages = static_cast<const int*>(n_pages);
  a.sk = static_cast<const __nv_bfloat16*>(k);
  a.sv = static_cast<const __nv_bfloat16*>(v);
  a.side = static_cast<const float*>(side);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.Z = B * H;
  a.H = H;
  a.Sq = Sq;
  a.D = D;
  a.n_max = n_max;
  a.DK = DK;
  a.P = P;
  return wide_flash::launch_scratch<wide_flash::kScratch16>(
      a, PT, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
