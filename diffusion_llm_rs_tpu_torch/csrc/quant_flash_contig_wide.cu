// Flash attention over contiguous per-token-quantized K/V at head widths
// past 256, for Hopper (sm_90a): the scan sampler's kernel at wide heads.
//
// With csrc/quant_flash_contig.cu (heads of 8 to 256) it replaces the TPU
// kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/pallas_attention.py:99,
// behind `attention`, :155), which takes D % (8 * vpb) == 0 within its VMEM
// budget (:165-176). Two designs, D a runtime argument in both, one
// instance a bit width (1, 2, 4, 8), f32 out, no lse:
//   - dlm_quant_attention_cluster, heads of 264 to 2048: mode kContig of
//     csrc/wide_cluster_flash.cuh, a cluster of ceil(D / 256) blocks a
//     128-query tile, each block 256 channels of the head (the bytes of
//     each block-packed row that hold them, copied by cp.async a tile
//     ahead and unpacked into swizzled bf16 levels), the partial S summed
//     through distributed shared memory, KV tiles of 32 tokens, the chain
//     of tiles split over clusters and merged in the launch. It issues the
//     S product once a KV tile a query tile: 4*BH*Sq*(32*ceil(Skv/32))*256*
//     ceil(D/256) operations for the two products.
//   - dlm_quant_attention_wide, heads past 2048: mode kContig of
//     csrc/wide_flash.cuh, KV tiles of 64 tokens, a block per 64 queries
//     and 128 output columns on mma.sync, each recomputing S over the whole
//     head, each packed row of D/vpb bytes read a byte an element.
// Neither needs the packed rows aligned (a row of 33 bytes at 1 bit and D =
// 264).
//
// What bounds it on an H100: at the scan sampler's wide shapes (BH = 16 x
// heads of 384, BH = 8 x 768, Sq = Skv = 256, 4-bit) the function moves
// about 11 MB (q bf16, the f32 out, packed K/V and their sidecars) and does
// 1.6 GFLOP: bytes, 0.0033 ms (PERF.md gives the times).

#include "wide_cluster_flash.cuh"
#include "wide_flash.cuh"

extern "C" {

// The clusters of the cluster kernel at `bits` the card runs at once for
// heads of D (0 where it cannot place one, a negative cudaError_t on
// failure): what dlm_quant_attention_cluster_splits splits the chain by.
int dlm_quant_attention_cluster_active(int D, int bits) {
  const int C = wide_cluster::cluster_blocks(D);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  using wide_cluster::kContig;
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
  const int C = cluster_blocks(D);
  const int b = bits == 1 ? 0 : bits == 2 ? 1 : bits == 4 ? 2 : bits == 8 ? 3
                                                                           : -1;
  if (C == 0 || b < 0 || BH <= 0 || Sq <= 0 || Skv < 1)
    return -(int)cudaErrorInvalidValue;
  static int placed[4][kMaxCluster + 1] = {};  // clusters at once by bits, C
  if (placed[b][C] == 0)
    placed[b][C] = max(dlm_quant_attention_cluster_active(D, bits), -1);
  return chain_splits(placed[b][C], ((Sq + kBQ - 1) / kBQ) * BH,
                      (Skv + TK - 1) / TK);
}

// dlm_quant_attention's arguments (csrc/quant_flash_contig.cu) for D a
// multiple of 8 from 264 to 2048 (q 16-byte aligned, the packed K/V in any
// alignment), then the splits of the chain of ceil(Skv / 32) tiles
// (dlm_quant_attention_cluster_splits) and, where more than one, scratch
// f32 [nsplit, BH, Sq, D] and [nsplit, C, BH, Sq, 2] (C = ceil(D / 256))
// and int32 counters [ceil(Sq / 128), BH, C] that are zero and that the
// kernel leaves zero.
// Returns cudaErrorInvalidClusterSize where the card cannot place the
// cluster.
int dlm_quant_attention_cluster(const void* q, const void* k_data,
                                const void* k_scale, const void* k_zp,
                                const void* v_data, const void* v_scale,
                                const void* v_zp, void* out, int BH, int Sq,
                                int Skv, int D, int bits, float sm_scale,
                                void* stream, int nsplit, void* part_o,
                                void* part_ml, void* counters) {
  const int C = wide_cluster::cluster_blocks(D);
  if (C == 0 || Skv < 1 ||
      !wide_cluster::splits_fit(nsplit,
                                (Skv + wide_cluster::TK - 1) / wide_cluster::TK) ||
      (nsplit > 1 && (!part_o || !part_ml || !counters)))
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
  a.Z = BH;
  a.nsplit = nsplit;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float2*>(part_ml);
  a.counters = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using wide_cluster::kContig;
  switch (bits) {
    case 1: return wide_cluster::launch<kContig, 1>(maps, a, st);
    case 2: return wide_cluster::launch<kContig, 2>(maps, a, st);
    case 4: return wide_cluster::launch<kContig, 4>(maps, a, st);
    case 8: return wide_cluster::launch<kContig, 8>(maps, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same arguments as dlm_quant_attention for D a multiple of 8 past 2048
// (the cluster kernel serves 264 to 2048); the packed K/V need no
// alignment.
int dlm_quant_attention_wide(const void* q, const void* k_data,
                             const void* k_scale, const void* k_zp,
                             const void* v_data, const void* v_scale,
                             const void* v_zp, void* out, int BH, int Sq,
                             int Skv, int D, int bits, float sm_scale,
                             void* stream) {
  if (D <= wide_cluster::kMaxD || D % 8 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  wide_flash::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_data = static_cast<const uint8_t*>(k_data);
  a.k_scale = static_cast<const float*>(k_scale);
  a.k_zp = static_cast<const float*>(k_zp);
  a.v_data = static_cast<const uint8_t*>(v_data);
  a.v_scale = static_cast<const float*>(v_scale);
  a.v_zp = static_cast<const float*>(v_zp);
  a.out = static_cast<float*>(out);
  a.Z = BH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.sm = sm_scale;
  return wide_flash::launch_bits<wide_flash::kContig>(
      a, bits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
