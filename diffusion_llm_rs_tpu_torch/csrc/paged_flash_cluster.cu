// Batched paged attention at head widths past 256 (bf16 and int8
// activations, every multiple of 8 past 256), for Hopper (sm_90a): the head
// split across a thread-block cluster.
//
// With csrc/batched_paged_attention.cu and csrc/paged_attention_a8.cu (heads
// of 8 to 256) it replaces the TPU kernel `_batched_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py: 288, behind
// `batched_paged_attention`, :686; its int8 path :411-427 and :520-653).
// csrc/paged_unpack.cu first unpacks every live page into a scratch of rows
// of DK = D rounded up to 64, zero past D; the attention over it is modes
// kScratch16 and kScratch8 of csrc/wide_cluster_flash.cuh: a cluster of
// blocks a 128-query tile of one (slot, head), each block k slices of 256
// columns of the head (`cluster_plan`), the partial S summed through
// distributed shared memory, S and P.V on wgmma:
//   - heads of 264 to 2048, k = 1, C = ceil(D / 256): one pass;
//   - past 2048, k = ceil(D / 2048) slices a block, two passes: the bf16
//     path (wide_cluster_slices) S and the online softmax over the tiles of
//     32 tokens, keeping bf16(p), alpha and csum a tile in a scratch the
//     wrapper allocates, then P.V replayed slice by slice; the int8 path
//     (wide_cluster_a8_slices) q quantized once into an int8 scratch the
//     wrapper allocates and streamed from it a slice a step by TMA, S in s32
//     partials and each page's softmax and requantization, keeping wi,
//     alpha, sw and csum a page in a second scratch; then P.V replayed slice
//     by slice.
// The S product is issued once a tile of 32 tokens (int8: a sub-tile of 64,
// or the page of 32) a query tile: 4*B*H*Sq*(keys in whole tiles)*256*
// ceil(D/256) operations for the two products, at the bf16 or the int8 rate.
//
// What bounds it on an H100: at heads_wide's serving shape (B = 2, Sq =
// 2048, 16 pages of 128 a slot) with one head of 768 the dots are 25.8
// GFLOP: 0.026 ms at the bf16 rate, 0.013 at the int8 rate (PERF.md).

#include "wide_cluster_flash.cuh"

namespace {

// The scratch's page tile of pages of P tokens (ops/paged_attention.py:
// tile_tokens).
int tile_of(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// kScratch8 over pages in tiles of a.PT tokens (its instance), or
// (`active`) the clusters of that instance the card runs at once: k = 1
// (heads of 264 to 2048), or k slices a block (past 2048, `maps` with q's
// int8 scratch first). Here and not in the header, so that the sources that
// include the header do not build these kernels.
template <int PT>
int launch_a8_tile(const CUtensorMap (&maps)[3], const wide_cluster::Args& a,
                   int k, int8_t* qi, uint4* replay, cudaStream_t stream,
                   bool active) {
  using namespace wide_cluster;
  if (k > 1)
    return active ? active_a8_slices<PT>(a.C)
                  : launch_a8_slices<PT>(maps, a, k, qi, replay, stream);
  const CUtensorMap kv[2] = {maps[1], maps[2]};
  return wide_cluster::launch_a8_pt<PT>(kv, a, stream, active);
}

int launch_a8(const CUtensorMap (&maps)[3], const wide_cluster::Args& a,
              int k, int8_t* qi, uint4* replay, cudaStream_t stream,
              bool active = false) {
  using namespace wide_cluster;
  if (a.C < 2 || a.C > kMaxCluster) return (int)cudaErrorInvalidValue;
  switch (a.PT) {
    case 32: return launch_a8_tile<32>(maps, a, k, qi, replay, stream, active);
    case 64: return launch_a8_tile<64>(maps, a, k, qi, replay, stream, active);
    case 128:
      return launch_a8_tile<128>(maps, a, k, qi, replay, stream, active);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool a8, const void* q, const void* page_tokens,
        const void* n_pages, const void* k, const void* v, const void* side,
        void* out, void* lse, int B, int H, int Sq, int D, int n_max, int PT,
        int DK, int P, void* stream, void* qi, void* replay) {
  int ks;
  const int C = wide_cluster::cluster_plan(D, &ks);
  if (C == 0 || (ks > 1 && ((a8 && !qi) || !replay)) || DK % 64 ||
      DK < D || n_max < 1 || P < 8 || P % 8 || PT != tile_of(P))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  wide_cluster::Args a{};
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.Sq = Sq;
  a.D = D;
  a.C = C;
  a.page_tokens = static_cast<const int*>(page_tokens);
  a.slot_pages = static_cast<const int*>(n_pages);
  a.side = static_cast<const float*>(side);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.Z = B * H;
  a.H = H;
  a.n_max = n_max;
  a.PT = PT;
  a.P = P;
  a.DK = DK;
  a.nsplit = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t Z = (uint64_t)B * H, n = (uint64_t)n_max;
  if (a8) {
    // K [Z, n_max * PT, DK] in boxes of 128 bytes x a sub-tile's rows;
    // V^T [Z, n_max, DK, PT] in boxes of a block's 256 rows of one page
    // (rows past DK zero), each swizzled as the wgmma descriptors read it;
    // past 2048 q's int8 scratch [Z, Sq, DK] in boxes of 128 bytes x 128
    // rows (rows past Sq zero)
    CUtensorMap maps[3];
    const uint64_t kdims[3] = {(uint64_t)DK, n * PT, Z};
    const uint64_t kstrides[2] = {(uint64_t)DK, n * PT * DK};
    const uint32_t kbox[3] = {128, (uint32_t)wide_cluster::a8_subtile(PT),
                              1};
    const uint64_t vdims[4] = {(uint64_t)PT, (uint64_t)DK, n, Z};
    const uint64_t vstrides[3] = {(uint64_t)PT, (uint64_t)DK * PT,
                                  n * DK * PT};
    const uint32_t vbox[4] = {(uint32_t)PT, (uint32_t)wide_cluster::kCols, 1,
                              1};
    const uint64_t qdims[3] = {(uint64_t)DK, (uint64_t)Sq, Z};
    const uint64_t qstrides[2] = {(uint64_t)DK, (uint64_t)Sq * DK};
    const uint32_t qbox[3] = {128, (uint32_t)wide_cluster::kBQ, 1};
    if (!hopper::make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, kdims,
                          kstrides, kbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hopper::make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, v, vdims,
                          vstrides, vbox,
                          hopper::tma_swizzle(hopper::swizzle_of(PT))))
      return (int)cudaErrorInvalidValue;
    if (ks == 1)
      maps[0] = maps[1];  // not read
    else if (!hopper::make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qi,
                               qdims, qstrides, qbox,
                               CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    return launch_a8(maps, a, ks, static_cast<int8_t*>(qi),
                     static_cast<uint4*>(replay), st);
  }
  CUtensorMap maps[3];
  if (!wide_cluster::bf16_map(&maps[0], q, B * H, Sq, D, wide_cluster::kBQ) ||
      !wide_cluster::bf16_map(&maps[1], k, B * H, n_max * PT, DK,
                              wide_cluster::TK) ||
      !wide_cluster::bf16_map(&maps[2], v, B * H, n_max * PT, DK,
                              wide_cluster::TK))
    return (int)cudaErrorInvalidValue;
  using wide_cluster::kScratch16;
  if (ks > 1)
    return wide_cluster::launch_slices<kScratch16, 8>(
        maps, a, ks, static_cast<uint4*>(replay), st);
  return wide_cluster::launch<kScratch16, 8>(maps, a, st);
}

}  // namespace

extern "C" {

// For D a multiple of 8 past 256: q [B, H, Sq, D] bf16 (16-byte aligned);
// page_tokens int32 [B, n_max]; n_pages int32 [B]; k, v, side:
// dlm_paged_unpack's bf16 scratch of pages of P tokens in tiles of PT (the
// smallest of 32, 64 and 128 that holds P), rows of DK (a multiple of 64, at
// least D); past 2048 (k > 1) also scratch of [B * H, ceil(Sq / 128),
// n_max * ceil(P / 32), 3, 256] 16-byte words for the tiles' P, alpha and
// csum (`replay`; None at 264 to 2048). Writes out f32 [B, H, Sq, D] and
// lse f32 [B, H, Sq]. Returns cudaErrorInvalidValue for a shape it does not
// take, and cudaErrorInvalidClusterSize where the card cannot place the
// cluster.
int dlm_batched_paged_attention_cluster(const void* q, const void* page_tokens,
                                        const void* n_pages, const void* k,
                                        const void* v, const void* side,
                                        void* out, void* lse, int B, int H,
                                        int Sq, int D, int n_max, int PT,
                                        int DK, int P, void* stream,
                                        void* replay) {
  return run(false, q, page_tokens, n_pages, k, v, side, out, lse, B,
             H, Sq, D, n_max, PT, DK, P, stream, nullptr, replay);
}

// The same over dlm_paged_unpack's int8 scratch (K [.., PT, DK], V^T
// [.., DK, PT] with its columns in vt_col order), for D a multiple of 8
// past 256. Past 2048 (k > 1), also scratch for q's levels, int8 [B * H, Sq,
// DK] (16-byte aligned), and for what pass 1 keeps, [B * H, ceil(Sq / 128),
// n_max, PT / 32 + 2, 256] 16-byte words (`qi`, `replay`; None at 264 to
// 2048).
int dlm_batched_paged_attention_a8_cluster(
    const void* q, const void* page_tokens, const void* n_pages, const void* k,
    const void* v, const void* side, void* out, void* lse, int B, int H,
    int Sq, int D, int n_max, int PT, int DK, int P, void* stream, void* qi,
    void* replay) {
  return run(true, q, page_tokens, n_pages, k, v, side, out, lse, B, H,
             Sq, D, n_max, PT, DK, P, stream, qi, replay);
}

// The clusters of the instance that serves heads of D over pages of P
// tokens (int8 where a8) the card runs at once (0 where it cannot place
// one, a negative cudaError_t on failure).
int dlm_batched_paged_attention_cluster_active(int D, int P, int a8) {
  int ks;
  const int C = wide_cluster::cluster_plan(D, &ks);
  if (C == 0 || P < 8 || P % 8 || P > 128) return -(int)cudaErrorInvalidValue;
  using wide_cluster::kScratch16;
  if (!a8)
    return ks > 1 ? wide_cluster::active_slices<kScratch16, 8>(C)
                  : wide_cluster::active_clusters<kScratch16, 8>(C);
  wide_cluster::Args a{};
  a.C = C;
  a.P = P;
  a.PT = tile_of(P);
  CUtensorMap maps[3];  // not read
  return launch_a8(maps, a, ks, nullptr, nullptr, nullptr, true);
}

}  // extern "C"
