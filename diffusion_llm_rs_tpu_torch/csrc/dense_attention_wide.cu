// Dense bf16 flash attention at head widths past 256, for Hopper (sm_90a).
//
// With csrc/dense_attention.cu (heads of 8 to 256) it replaces the TPU
// kernel `_dense_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:213,
// behind `dense_attention`, :247), which takes any head width D % 8 == 0
// whose K and V fit its VMEM budget (:262-269): at S = 1024 up to about
// 1400, at S = 128 about 8000. One entry point, dlm_dense_attention_cluster,
// takes every multiple of 8 past 256 (D a runtime argument, bf16 or f32
// out): mode kDense of csrc/wide_cluster_flash.cuh, a cluster of blocks a
// 128-query tile, each block k slices of 256 columns of the head
// (`cluster_plan`), the partial S summed in rank order through distributed
// shared memory, S and P.V on wgmma fed by TMA:
//   - heads of 264 to 2048, k = 1, C = ceil(D / 256): one pass, q resident,
//     o in registers over the block's 256 columns;
//   - past 2048, k = ceil(D / 2048) slices a block (slices_attention, the
//     kernel fused-QKV attention runs there too), two exact passes: S and
//     each row's maximum and sum over the tiles, q streamed from L2 a slice
//     a step, S kept in an f32 scratch the wrapper allocates; then p
//     against the row's final maximum and P.V slice by slice, out = o / sum.
// It issues the S product once a KV tile a query tile:
// 4*BH*Sq*Skv*256*ceil(D/256) operations for the two products, 25.8 GFLOP at
// heads of 768 (BH = 8, S = 1024).
//
// What bounds it on an H100: at heads of 768 and the work of the sampler's
// heads of 128 (BH = 8, S = 1024) the dots are 4*BH*S^2*D = 25.8 GFLOP, so
// the bf16 tensor cores bound it (0.026 ms); past 2048 the k-slice kernel
// also reads q once a step (k times a KV tile) from L2, and writes S in
// f32 and reads it back k times (4 bytes a score). PERF.md gives the times.

#include "wide_cluster_flash.cuh"

extern "C" {

// q [BH, Sq, D], k, v [BH, Skv, D] bf16 (16-byte aligned), D a multiple of
// 8 past 256; writes out [BH, Sq, D] (bf16 where out_bf16, else f32). Past
// 2048 (k > 1) `s_keep` is f32 scratch [BH, Sq, ceil(Skv / 8) * 8] for
// pass 1's S (None at 264 to 2048). Returns cudaErrorInvalidValue for a
// shape it does not take, and cudaErrorInvalidClusterSize where the card
// cannot place the cluster.
int dlm_dense_attention_cluster(const void* q, const void* k, const void* v,
                                void* out, int out_bf16, int BH, int Sq,
                                int Skv, int D, float sm_scale, void* stream,
                                void* s_keep) {
  int ks;
  const int C = wide_cluster::cluster_plan(D, &ks);
  if (C == 0 || Skv < 1 || BH > 65535 || (ks > 1 && !s_keep))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  CUtensorMap maps[3];
  if (!wide_cluster::bf16_map(&maps[0], q, BH, Sq, D, wide_cluster::kBQ) ||
      !wide_cluster::bf16_map(&maps[1], k, BH, Skv, D, wide_cluster::TK) ||
      !wide_cluster::bf16_map(&maps[2], v, BH, Skv, D, wide_cluster::TK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks > 1) {  // one head a grid row: h = z, b = 0
    wide_cluster::SliceArgs s{};
    s.out = out;
    s.oh = (size_t)Sq * D;
    s.orow = D;
    s.s_keep = static_cast<float*>(s_keep);
    s.out_bf16 = out_bf16;
    s.Sq = Sq;
    s.Skv = Skv;
    s.D = D;
    s.H = BH;
    s.C = C;
    s.k = ks;
    s.ld = (Skv + 7) / 8 * 8;
    s.sl2 = sm_scale * wide_cluster::kLog2e;
    return wide_cluster::launch_slices_attention<false>(maps, s, 1, st);
  }
  wide_cluster::Args a{};
  a.out = out;
  a.out_bf16 = out_bf16;
  a.Sq = Sq;
  a.D = D;
  a.C = C;
  a.sm = sm_scale;
  a.Skv = Skv;
  a.Z = BH;
  a.nsplit = 1;
  return wide_cluster::launch<wide_cluster::kDense, 8>(maps, a, st);
}

// The clusters of the dense cluster kernel the card runs at once for heads
// of D (0 where it cannot place one, a negative cudaError_t on failure);
// past 2048 those of the k-slice kernel.
int dlm_dense_attention_cluster_active(int D) {
  int ks;
  const int C = wide_cluster::cluster_plan(D, &ks);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  if (ks > 1) return wide_cluster::active_slices_attention<false>(C);
  return wide_cluster::active_clusters<wide_cluster::kDense, 8>(C);
}

}  // extern "C"
