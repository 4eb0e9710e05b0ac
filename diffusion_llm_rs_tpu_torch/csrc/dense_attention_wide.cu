// Dense bf16 flash attention at head widths past 256, for Hopper (sm_90a).
//
// With csrc/dense_attention.cu (heads of 8 to 256) it replaces the TPU
// kernel `_dense_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:213,
// behind `dense_attention`, :247), which takes any head width D % 8 == 0
// whose K and V fit its VMEM budget (:262-269): at S = 1024 up to about
// 1400, at S = 128 about 8000. The design, mode kDense of
// csrc/wide_flash.cuh, takes D as a runtime argument: one instance serves
// every width, bf16 or f32 out.
//
// What bounds it on an H100: at heads of 768 and the work of the sampler's
// heads of 128 (BH = 8, S = 1024) the dots are 4*BH*S^2*D = 25.8 GFLOP, so
// the bf16 tensor cores bound it (0.026 ms); this design computes S once
// for each of its ceil(D / 128) column blocks, so it does 3.5x that work at
// D = 768, on mma.sync (PERF.md gives its time).

#include "wide_flash.cuh"

extern "C" {

// q [BH, Sq, D], k, v [BH, Skv, D] bf16 (16-byte aligned), D a multiple of
// 8; writes out [BH, Sq, D] (bf16 where out_bf16, else f32). Returns
// cudaErrorInvalidValue for a shape it does not take.
int dlm_dense_attention_wide(const void* q, const void* k, const void* v,
                             void* out, int out_bf16, int BH, int Sq, int Skv,
                             int D, float sm_scale, void* stream) {
  if (D < 8 || D % 8 || Skv < 1) return (int)cudaErrorInvalidValue;
  wide_flash::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.Z = BH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.sm = sm_scale;
  return wide_flash::launch<wide_flash::kDense, 8, 64>(
      a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
