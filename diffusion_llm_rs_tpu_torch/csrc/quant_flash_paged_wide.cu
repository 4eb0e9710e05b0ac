// Flash attention over one paged, quantized KV sequence at head widths past
// 256, for Hopper (sm_90a): `PagedKVCache.attend` at wide heads.
//
// With csrc/quant_flash_paged.cu (heads of 8 to 256) it replaces the TPU
// kernel `_kernel` (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:34,
// behind `paged_attention`, :140), which takes D % 128 == 0 (:174; JAX's
// XLA `_fallback` serves the other widths). One entry point,
// dlm_paged_attention_cluster, takes every multiple of 8 past 256 (D a
// runtime argument, one instance a bit width, the lse written beside the
// output): mode kPaged of csrc/wide_cluster_flash.cuh, a cluster of blocks
// a 128-query tile, each block k slices of 256 columns of the head (256
// contiguous bytes of each packed row a slice, copied by cp.async and
// unpacked into swizzled bf16 levels), the partial S summed through
// distributed shared memory, the page chain split over clusters
// (`paged_splits`) and merged in the launch:
//   - heads of 264 to 2048, k = 1, C = ceil(D / 256): one pass, K two tiles
//     ahead, o in registers over the block's 256 columns;
//   - past 2048, k = ceil(D / 2048) slices a block (`cluster_plan`), two
//     passes: S and the online softmax over the tiles, keeping bf16(p * vs),
//     alpha and csum per tile in scratch, then P.V replayed slice by slice.
// It issues the S product once a KV tile a query tile:
// 4*BH*Sq*(n_pages*32*ceil(P/32))*256*n operations for the two products
// (n = ceil(D / 256); a page runs as tiles of 32 tokens, the last padded).

#include "wide_cluster_flash.cuh"

namespace {

// The splits of a single-sequence paged call over its page chain (C blocks
// of k slices a cluster).
int paged_splits(int C, int k, int Z, int Sq, int n_pages, int P) {
  using namespace wide_cluster;
  static int placed[2][kMaxCluster + 1] = {};  // clusters at once by C
  int& n = placed[k > 1][C];
  if (n == 0)
    n = max(k > 1 ? active_slices<4>(C) : active_clusters<kPaged, 4>(C), -1);
  return chain_splits(n, ((Sq + kBQ - 1) / kBQ) * Z,
                      n_pages * ((P + TK - 1) / TK));
}

}  // namespace

extern "C" {

// The splits dlm_paged_attention_cluster takes for these sizes (1: the
// chain in one piece), or a negative cudaError_t.
int dlm_paged_attention_cluster_splits(int BH, int Sq, int D, int n_pages,
                                       int P) {
  int k;
  const int C = wide_cluster::cluster_plan(D, &k);
  if (C == 0 || BH <= 0 || Sq <= 0 || n_pages < 1 || P < 8 || P > 128)
    return -(int)cudaErrorInvalidValue;
  return paged_splits(C, k, BH, Sq, n_pages, P);
}

// dlm_paged_attention's arguments (csrc/quant_flash_paged.cu) for D a
// multiple of 8 past 256 (the pools 16-byte aligned), then the splits
// (dlm_paged_attention_cluster_splits) and, where more than one, scratch
// f32 [nsplit, BH, Sq, D] and [nsplit, C, BH, Sq, 2] (C: the blocks of
// `cluster_plan(D)`) and int32 counters [ceil(Sq / 128), BH, C] that are
// zero and that the kernel leaves zero; past 2048 (k > 1) also scratch of
// [BH, ceil(Sq / 128), n_pages * ceil(P / 32), 3, 256] 16-byte words for
// the tiles' P, alpha and csum (`replay`). A slot outside the pool traps.
// Returns cudaErrorInvalidClusterSize where the card cannot place the
// cluster.
int dlm_paged_attention_cluster(const void* q, const void* page_table,
                                const void* page_tokens, const void* k_data,
                                const void* k_scale, const void* k_zp,
                                const void* v_data, const void* v_scale,
                                const void* v_zp, void* out, void* lse, int BH,
                                int Sq, int D, int n_pages, int n_slots, int P,
                                int bits, float sm_scale, void* stream,
                                int nsplit, void* part_o, void* part_ml,
                                void* counters, void* replay) {
  int k;
  const int C = wide_cluster::cluster_plan(D, &k);
  if (C == 0 || n_pages < 1 || P < 8 || P > 128 || P % 8 ||
      !wide_cluster::splits_fit(  // no split may be empty
          nsplit, n_pages * ((P + wide_cluster::TK - 1) / wide_cluster::TK)) ||
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
  a.lse = static_cast<float*>(lse);
  a.Sq = Sq;
  a.D = D;
  a.C = C;
  a.sm = sm_scale;
  a.page_table = static_cast<const int*>(page_table);
  a.page_tokens = static_cast<const int*>(page_tokens);
  a.k_data = static_cast<const uint8_t*>(k_data);
  a.k_scale = static_cast<const float*>(k_scale);
  a.k_zp = static_cast<const float*>(k_zp);
  a.v_data = static_cast<const uint8_t*>(v_data);
  a.v_scale = static_cast<const float*>(v_scale);
  a.v_zp = static_cast<const float*>(v_zp);
  a.n_pages = n_pages;
  a.n_slots = n_slots;
  a.Z = BH;
  a.P = P;
  a.nsplit = nsplit;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float2*>(part_ml);
  a.counters = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 1) {
    using wide_cluster::launch_slices;
    a.q = static_cast<const __nv_bfloat16*>(q);
    uint4* r = static_cast<uint4*>(replay);
    switch (bits) {
      case 1: return launch_slices<1>(maps[0], a, k, r, st);
      case 2: return launch_slices<2>(maps[0], a, k, r, st);
      case 4: return launch_slices<4>(maps[0], a, k, r, st);
      case 8: return launch_slices<8>(maps[0], a, k, r, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 1: return wide_cluster::launch<wide_cluster::kPaged, 1>(maps, a, st);
    case 2: return wide_cluster::launch<wide_cluster::kPaged, 2>(maps, a, st);
    case 4: return wide_cluster::launch<wide_cluster::kPaged, 4>(maps, a, st);
    case 8: return wide_cluster::launch<wide_cluster::kPaged, 8>(maps, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
