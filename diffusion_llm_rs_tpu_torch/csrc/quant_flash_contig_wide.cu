// Flash attention over contiguous per-token-quantized K/V at head widths
// past 256, for Hopper (sm_90a): the scan sampler's kernel at wide heads.
//
// With csrc/quant_flash_contig.cu (heads of 8 to 256) it replaces the TPU
// kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:99,
// behind `attention`, :155), which takes D % (8 * vpb) == 0 within its VMEM
// budget (:165-176). One entry point, dlm_quant_attention_cluster, takes
// every multiple of 8 past 256 (D a runtime argument, one instance a bit
// width, f32 out, no lse): mode kContig of csrc/wide_cluster_flash.cuh, a
// cluster of blocks a 128-query tile, each block k slices of 256 channels
// of the head (the bytes of each block-packed row that hold them, copied by
// cp.async and unpacked into swizzled bf16 levels), the partial S summed
// through distributed shared memory, KV tiles of 32 tokens, the chain of
// tiles split over clusters and merged in the launch:
//   - heads of 264 to 2048, k = 1, C = ceil(D / 256): one pass, the rows two
//     tiles ahead, o in registers over the block's 256 channels;
//   - past 2048, k = ceil(D / 2048) slices a block (`cluster_plan`), two
//     passes: S and the online softmax over the tiles, keeping bf16(p * vs),
//     alpha and csum per tile in scratch, then P.V replayed slice by slice.
// It issues the S product once a KV tile a query tile: 4*BH*Sq*(32*
// ceil(Skv/32))*256*n operations for the two products (n = ceil(D / 256)).
// It needs the packed rows in no alignment (a row of 33 bytes at 1 bit and
// D = 264).
//
// What bounds it on an H100: at the scan sampler's wide shapes (BH = 16 x
// heads of 384, BH = 8 x 768, Sq = Skv = 256, 4-bit) the function moves
// about 11 MB (q bf16, the f32 out, packed K/V and their sidecars) and does
// 1.6 GFLOP: bytes, 0.0033 ms (PERF.md gives the times).

#include "wide_cluster_flash.cuh"

extern "C" {

// The clusters of the cluster kernel at `bits` the card runs at once for
// heads of D (0 where it cannot place one, a negative cudaError_t on
// failure): what dlm_quant_attention_cluster_splits splits the chain by.
int dlm_quant_attention_cluster_active(int D, int bits) {
  int k;
  const int C = wide_cluster::cluster_plan(D, &k);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  using wide_cluster::kContig;
  if (k > 1) {
    switch (bits) {
      case 1: return wide_cluster::active_slices<kContig, 1>(C);
      case 2: return wide_cluster::active_slices<kContig, 2>(C);
      case 4: return wide_cluster::active_slices<kContig, 4>(C);
      case 8: return wide_cluster::active_slices<kContig, 8>(C);
      default: return -(int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 1: return wide_cluster::active_clusters<kContig, 1>(C);
    case 2: return wide_cluster::active_clusters<kContig, 2>(C);
    case 4: return wide_cluster::active_clusters<kContig, 4>(C);
    case 8: return wide_cluster::active_clusters<kContig, 8>(C);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The splits dlm_quant_attention_cluster takes for these sizes (1: the
// chain in one piece), or a negative cudaError_t.
int dlm_quant_attention_cluster_splits(int BH, int Sq, int Skv, int D,
                                       int bits) {
  using namespace wide_cluster;
  int k;
  const int C = cluster_plan(D, &k);
  const int b = bits == 1 ? 0 : bits == 2 ? 1 : bits == 4 ? 2 : bits == 8 ? 3
                                                                           : -1;
  if (C == 0 || b < 0 || BH <= 0 || Sq <= 0 || Skv < 1)
    return -(int)cudaErrorInvalidValue;
  // clusters at once by bits, k > 1 and C
  static int placed[4][2][kMaxCluster + 1] = {};
  int& n = placed[b][k > 1][C];
  if (n == 0) n = max(dlm_quant_attention_cluster_active(D, bits), -1);
  return chain_splits(n, ((Sq + kBQ - 1) / kBQ) * BH, (Skv + TK - 1) / TK);
}

// dlm_quant_attention's arguments (csrc/quant_flash_contig.cu) for D a
// multiple of 8 past 256 (q 16-byte aligned, the packed K/V in any
// alignment), then the splits of the chain of ceil(Skv / 32) tiles
// (dlm_quant_attention_cluster_splits) and, where more than one, scratch
// f32 [nsplit, BH, Sq, D] and [nsplit, C, BH, Sq, 2] (C: the blocks of
// `cluster_plan(D)`) and int32 counters [ceil(Sq / 128), BH, C] that are
// zero and that the kernel leaves zero; past 2048 (k > 1) also scratch of
// [BH, ceil(Sq / 128), ceil(Skv / 32), 3, 256] 16-byte words for the
// tiles' P, alpha and csum (`replay`).
// Returns cudaErrorInvalidClusterSize where the card cannot place the
// cluster.
int dlm_quant_attention_cluster(const void* q, const void* k_data,
                                const void* k_scale, const void* k_zp,
                                const void* v_data, const void* v_scale,
                                const void* v_zp, void* out, int BH, int Sq,
                                int Skv, int D, int bits, float sm_scale,
                                void* stream, int nsplit, void* part_o,
                                void* part_ml, void* counters, void* replay) {
  int k;
  const int C = wide_cluster::cluster_plan(D, &k);
  if (C == 0 || Skv < 1 ||
      !wide_cluster::splits_fit(nsplit,
                                (Skv + wide_cluster::TK - 1) / wide_cluster::TK) ||
      (nsplit > 1 && (!part_o || !part_ml || !counters)) ||
      (k > 1 && !replay))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  CUtensorMap maps[3];
  if (!wide_cluster::bf16_map(&maps[0], q, BH, Sq, D, wide_cluster::kBQ))
    return (int)cudaErrorInvalidValue;
  maps[1] = maps[2] = maps[0];  // K and V are not read by TMA
  wide_cluster::Args a{};
  a.out = out;
  a.Sq = Sq;
  a.D = D;
  a.C = C;
  a.sm = sm_scale;
  a.Skv = Skv;
  a.k_data = static_cast<const uint8_t*>(k_data);
  a.k_scale = static_cast<const float*>(k_scale);
  a.k_zp = static_cast<const float*>(k_zp);
  a.v_data = static_cast<const uint8_t*>(v_data);
  a.v_scale = static_cast<const float*>(v_scale);
  a.v_zp = static_cast<const float*>(v_zp);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.Z = BH;
  a.nsplit = nsplit;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float2*>(part_ml);
  a.counters = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using wide_cluster::kContig;
  if (k > 1) {
    using wide_cluster::launch_slices;
    uint4* r = static_cast<uint4*>(replay);
    switch (bits) {
      case 1: return launch_slices<kContig, 1>(maps, a, k, r, st);
      case 2: return launch_slices<kContig, 2>(maps, a, k, r, st);
      case 4: return launch_slices<kContig, 4>(maps, a, k, r, st);
      case 8: return launch_slices<kContig, 8>(maps, a, k, r, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 1: return wide_cluster::launch<kContig, 1>(maps, a, st);
    case 2: return wide_cluster::launch<kContig, 2>(maps, a, st);
    case 4: return wide_cluster::launch<kContig, 4>(maps, a, st);
    case 8: return wide_cluster::launch<kContig, 8>(maps, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
