// Dense bf16 flash attention at head widths past 256, for Hopper (sm_90a).
//
// With csrc/dense_attention.cu (heads of 8 to 256) it replaces the TPU
// kernel `_dense_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:213,
// behind `dense_attention`, :247), which takes any head width D % 8 == 0
// whose K and V fit its VMEM budget (:262-269): at S = 1024 up to about
// 1400, at S = 128 about 8000. Two designs, D a runtime argument in both,
// bf16 or f32 out:
//   - dlm_dense_attention_cluster, heads of 264 to 2048: mode kDense of
//     csrc/wide_cluster_flash.cuh, a cluster of ceil(D / 256) blocks a
//     128-query tile, each block 256 columns of the head, the partial S
//     summed through distributed shared memory. It issues the S product
//     once a KV tile a query tile: 4*BH*Sq*Skv*256*ceil(D/256) operations
//     for the two products, 25.8 GFLOP at heads of 768 (BH = 8, S = 1024).
//   - dlm_dense_attention_wide, heads past 2048: mode kDense of
//     csrc/wide_flash.cuh, a block per 64 queries and 128 output columns on
//     mma.sync, each block recomputing S over the whole head (ceil(D / 128)
//     times the S work).
//
// What bounds it on an H100: at heads of 768 and the work of the sampler's
// heads of 128 (BH = 8, S = 1024) the dots are 4*BH*S^2*D = 25.8 GFLOP, so
// the bf16 tensor cores bound it (0.026 ms); PERF.md gives the times.

#include "wide_cluster_flash.cuh"
#include "wide_flash.cuh"

extern "C" {

// q [BH, Sq, D], k, v [BH, Skv, D] bf16 (16-byte aligned), D a multiple of
// 8 from 264 to 2048; writes out [BH, Sq, D] (bf16 where out_bf16, else
// f32). Returns cudaErrorInvalidValue for a shape it does not take, and
// cudaErrorInvalidClusterSize where the card cannot place the cluster.
int dlm_dense_attention_cluster(const void* q, const void* k, const void* v,
                                void* out, int out_bf16, int BH, int Sq,
                                int Skv, int D, float sm_scale, void* stream) {
  const int C = wide_cluster::cluster_blocks(D);
  if (C == 0 || Skv < 1) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  CUtensorMap maps[3];
  if (!wide_cluster::bf16_map(&maps[0], q, BH, Sq, D, wide_cluster::kBQ) ||
      !wide_cluster::bf16_map(&maps[1], k, BH, Skv, D, wide_cluster::TK) ||
      !wide_cluster::bf16_map(&maps[2], v, BH, Skv, D, wide_cluster::TK))
    return (int)cudaErrorInvalidValue;
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
  return wide_cluster::launch<wide_cluster::kDense, 8>(
      maps, a, static_cast<cudaStream_t>(stream));
}

// The clusters of the dense cluster kernel the card runs at once for heads
// of D (0 where it cannot place one, a negative cudaError_t on failure).
int dlm_dense_attention_cluster_active(int D) {
  const int C = wide_cluster::cluster_blocks(D);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  return wide_cluster::active_clusters<wide_cluster::kDense, 8>(C);
}

// The same arguments for D a multiple of 8 past 2048 (the cluster kernel
// serves 264 to 2048).
int dlm_dense_attention_wide(const void* q, const void* k, const void* v,
                             void* out, int out_bf16, int BH, int Sq, int Skv,
                             int D, float sm_scale, void* stream) {
  if (D <= wide_cluster::kMaxD || D % 8 || Skv < 1)
    return (int)cudaErrorInvalidValue;
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
