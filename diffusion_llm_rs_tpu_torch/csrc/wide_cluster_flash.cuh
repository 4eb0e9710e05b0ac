// Dense, quantized-KV (contiguous and single-sequence paged) and batched
// paged attention at head widths from 264 to 2048, and dense, fused-QKV,
// single-sequence paged and batched int8 paged attention past 2048 (blocks
// of several 256-column slices, "k slices" below), for Hopper (sm_90a): the
// head split across a thread-block cluster.
//
// The fixed instances (csrc/dense_attention.cu, csrc/quant_flash.cuh) hold
// a whole head row of q, K and V in shared memory and o in registers, so
// they stop at 256; csrc/wide_flash.cuh takes any width by giving each
// block 128 output columns and recomputing S = q.k^T over the whole head in
// every one of them (ceil(D / 128) times the S work). Here a cluster of
// C = ceil(D / 256) blocks (at most 8, the portable cluster) owns one tile
// of 128 query rows, and block j of it columns [256j, 256j + 256) of the
// head: its slice of q, of every K tile and of every V tile (zero past D),
// so each byte of K and V is read once a query tile.
//   - S: block j runs its partial S_j = q[:, slice j] . K[:, slice j]^T on
//     wgmma (m64n32k16 a warpgroup, both operands in shared memory, 16
//     k-steps over its 256 columns) and stores it to shared memory; after a
//     cluster barrier every block adds the C partials, read through
//     distributed shared memory, in rank order 0 .. C-1, so every block
//     holds the same S bit for bit and runs the same softmax: m, l and p
//     agree, and only rank 0 writes the lse. The S product is issued once
//     per KV tile per query tile: 2 * 128 * 32 * 256 * C operations a tile,
//     D rounded up to 256 columns.
//   - P.V: each block multiplies P (bf16, registers) by its own 256 columns
//     of the V tile (MN-major) in m64n256k16 wgmmas; a warpgroup's f32 o of
//     64 x 256 lives in its registers, 128 a thread.
//   - A block is two warpgroups of 64 query rows (256 threads, so ptxas may
//     give each 255 registers; it allocates registers in groups of four
//     warps, so a producer warp or warpgroup would cap every thread at
//     168, and o spills), one block an SM. KV tiles of 32 tokens.
//   - The schedule of tile t: S of tile t + 1 is issued first and runs
//     under tile t's softmax; one wait then retires it and P.V of tile t - 1
//     (ptxas serializes every wgmma of a kernel where an accumulator is read
//     after a wait that retires only the older of two groups, or where an
//     S product stays in flight across the loop's back edge), P of tile t
//     (packed before the wait into registers of its own) moves into the
//     registers of P.V's A operand (only now: P.V of tile t - 1 reads them
//     until that wait, and PTX leaves a write before it undefined), o is
//     rescaled, P.V of tile t is issued, and the partial S of tile t + 1
//     goes to the cluster while it runs. The partials are double-buffered,
//     one cluster barrier a tile orders a buffer's reads before its next
//     write, and with clusters of 2 and 3 blocks (heads up to 768) the loads
//     of the next tile's partials are issued as soon as the barrier passes,
//     a tile before they are added (a load from another block's shared
//     memory takes several hundred clocks).
//   - kDense: q, K and V bf16 [Z, S, D] by TMA (64-column boxes, 128-byte
//     swizzle, zero fill past D, Sq and Skv), issued by one thread: K three
//     tiles ahead, V two.
//   - kPaged: q by TMA; the pool is packed along tokens ([n_slots, Z, P/vpb,
//     D]), so block j's columns of a packed row are 256 contiguous bytes. A
//     tile's packed rows (at most 32) are copied by cp.async, 16 bytes a
//     thread a row (8 where D % 16 != 0 leaves the rows 8-byte aligned), two
//     tiles ahead, and unpacked into swizzled bf16 level
//     tiles by all threads under P.V of the tile before (K two tiles ahead
//     of its S, V one). A
//     page of P tokens runs as ceil(P / 32) tiles. q's channel sum, which
//     meets K's zero point, is taken as C partial sums (each block over its
//     columns) and exchanged once at the start, in rank order. V's scale
//     folds into P as in csrc/quant_flash.cuh, whose logits() and
//     weights() this kernel runs. One sequence at wide heads has few query
//     tiles, so the chain of tiles is split over up to 8 clusters (grid z,
//     `paged_splits`) and merged in the same launch (`merge_splits`).
//   - kContig (`attention`'s QuantKV, [Z, Skv, Dp] packed along D, Dp = D /
//     vpb bytes a row): channel d is bit field d / Dp of byte d % Dp, so
//     block j's 256 channels are the n = min(256, Dp) bytes from c0 % Dp
//     on, wrapping at Dp (one run, or two where the block's channels span
//     two fields). A tile's runs of its 32 rows are copied by cp.async as
//     kPaged's rows are, CB = 16, 8 or 4 bytes a copy (CB divides Dp, the
//     run and the pointers' alignment; plain 2- or 1-byte loads where none
//     does, as at D = 264 and 1 bit, Dp = 33), into rows of 256 bytes, and
//     after a barrier every thread unpacks 8 columns of 4 rows: where Dp % 8
//     == 0 one field of 8 consecutive bytes (one 8-byte read), else each
//     column from its own byte and field. kPaged's sidecars (read a tile
//     ahead, token tid of 32), q's channel sum, softmax, split of the chain
//     over clusters (`chain_splits`) and merge; no lse.
//   - kScratch16 (batched paged attention, bf16): kDense's outline over the
//     bf16 scratch of csrc/paged_unpack.cu (K and V [Z = B * H, n_max, PT,
//     DK], rows of D rounded up to 64, zero past D): K and V tiles by TMA,
//     a page of P tokens as ceil(P / 32) tiles of 32, the page's sidecar
//     rows (ka', kb, vc) read a tile ahead; q's channel sum as in kPaged;
//     kPaged's softmax. The grid is (C x query tiles, B * H); a slot with no
//     page writes zeros and an lse of -1e30.
//   - kScratch8 (its int8 path, wide_cluster_attention_a8): the int8
//     scratch (K [Z, n_max, PT, DK], V^T [Z, n_max, DK, PT]) by TMA. q is
//     quantized once a row over the whole head: the C partial row maxima
//     are exchanged first (exact in any order), then each block quantizes
//     its columns into an int8 tile and the C partial sums of qi follow
//     (integers). S runs on s8 wgmma (m64n64k32, 8 k-steps) over sub-tiles
//     of 64 tokens (pages of 32: one of 32); its s32 partials add exactly
//     in any order, so every block holds the same integer S. The softmax
//     weights are requantized per page (sw = max w / 127), so a page's
//     whole S is held in registers before its softmax; P.V runs as two
//     m64n128k32 products from the register A operand of wi, each s32 sum
//     folded into o before the next (wi is packed after the wait that
//     retired the page before's products): o 128 registers a thread, a
//     page's logits 64 at PT = 128 (until wi, 16), one P.V sum 64; ptxas
//     gives 255 and spills 32-532 bytes a thread (the most at PT = 128), so
//     the partials are loaded when they are added, never a sub-tile early.
//     Shared memory at PT = 128: q 32 KB, three K stages of 16, two of a
//     page's V^T slice [256][PT] of 32 and its sidecars, two partial-S
//     buffers of 32: 214.5 KB.
// ptxas serializes no wgmma of any instance here (no C7514 or C7515
// "Potential Performance Loss" in the -Xptxas -v log): one wait<0> before
// every accumulator read, and no product in flight across a loop's back
// edge.
// The arithmetic is that of the plain versions (ops/attention.py:
// dense_attention_plain, ops/paged_attention.py: paged_attention_plain,
// batched_paged_attention_unpacked_plain):
//   kDense  logits = (q.k) * sm; acc = acc * a + bf16(p) . v; out = acc / l
//   kPaged, kContig  logits = raw * ka' - kb * qsum (ka' = ks * sm, kb =
//           ka' * kz); acc = acc * a - sum(p * vs * vz) + bf16(p * vs) . lv;
//           out = acc * (1 / l), lse = m + log(l) (kPaged)
//   kScratch16  logits = raw * ka' - kb * qsum; acc = acc * a - sum(p * vc)
//           + bf16(p) . v_sc; out and lse as kPaged
//   kScratch8  sq = amax|q| / 127 (1 where 0), qi = rint(q / sq), qsum =
//           sum(qi) * sq; logits = (qi.k * sq) * ka' - kb' * qsum; per page
//           w = p * vs (0 past page_tokens), sw = max w / 127 (1 where 0),
//           acc = acc * a + (rint(w / sw) . v) * sw - sum(w * vz')
// with exp taken on the ex2 unit and sums in another order. Tokens past
// Skv, or past a page's data, take p = 0; tokens past page_tokens[j] take
// logits of -1e30 (weight 1 while every key a row has seen is masked, as
// in the plain version). Query rows past Sq are not written.
//
// What bounds it on an H100 (PERF.md): at heads of 768, dense attention at
// BH = 8, S = 1024 is 25.8 GFLOP, 0.026 ms of bf16 tensor work; this design
// issues that work once (where csrc/wide_flash.cuh issued S six times over,
// 90 GFLOP), and moves 16 KB of partial S a block a KV tile through
// distributed shared memory for each other block of its cluster.

#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "paged_flash.cuh"
#include "quant_flash.cuh"

namespace wide_cluster {

using namespace hopper;

constexpr int kWG = 2;                     // warpgroups a block
constexpr int kThreads = 128 * kWG;        // 256: ptxas may give each 255
                                           // registers (o alone is 128)
constexpr int kBQ = 64 * kWG;              // query rows a cluster
constexpr int kCols = 256;                 // head columns a block
constexpr int kChunks = kCols / 64;        // 64-column chunks, 128-byte swizzle
constexpr int kSw = 128;
constexpr int TK = 32;                     // tokens a KV tile
constexpr int kStages = 3;
constexpr int kS = TK / 2;                 // logits a consumer thread
constexpr int kU = TK / 8;                 // their float4 units
constexpr int kRaw = TK * kCols;  // bytes of a tile's packed rows, at most
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMinD = 264, kMaxD = kCols * kMaxCluster;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Mode : int { kDense, kPaged, kScratch16, kScratch8, kContig };

struct Args {
  void* out;               // [Z, Sq, D]: f32, or bf16 where out_bf16 (kDense)
  float* lse;              // [Z, Sq] (kPaged, kScratch16, kScratch8)
  int out_bf16, Sq, D, C;  // C = ceil(D / 256) blocks a cluster
  float sm;
  int Skv;                 // kDense, kContig
  // kPaged: one sequence's page chain over pools [n_slots, Z, P/vpb, D]
  // and sidecars [n_slots, Z, P]; kContig: K and V [Z, Skv, D/vpb] and
  // their sidecars [Z, Skv] (the pointers below)
  const int* page_table;
  const int* page_tokens;
  const uint8_t* k_data;
  const float* k_scale;
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  int n_pages, n_slots, Z, P;
  // kPaged, kContig split over the chain of tiles (nsplit > 1, grid z):
  // each split's unnormalized o [nsplit, Z, Sq, D] and (m, l) [nsplit, C,
  // Z, Sq], and a
  // zeroed counter a (query tile, head, rank) that the merging block resets
  int nsplit;
  float* part_o;
  float2* part_ml;
  int* counters;
  // kScratch16, kScratch8: Z = B * H (slot, head) rows over the scratch of
  // csrc/paged_unpack.cu: the slots' page counts [B] (slot_pages) and valid
  // tokens [B, n_max] (page_tokens), pages of P tokens in tiles of PT,
  // sidecar rows [Z, n_max, 3 or 4, PT]; kScratch8 reads q [Z, Sq, D] itself
  const int* slot_pages;
  const float* side;
  const __nv_bfloat16* q;
  int H, n_max, PT;
  int DK;  // kScratch8 past 2048: the scratch's row of DK columns
};

// Shared memory of a block: q [128][256], three stages each of K and V
// [32][256] (bf16, 4 chunks of [rows][128 B] swizzled), two buffers of
// partial S (f32, 128 x 32), two stages of sidecars (kPaged, kContig), q's
// partial channel sums, the packed rows of two K and two V tiles (kPaged,
// kContig), and the
// mbarriers (q; K and V full a stage).
struct Smem {
  static constexpr int kQ = kBQ * kCols * 2;
  static constexpr int kTile = TK * kCols * 2;
  static constexpr int kX = kBQ * TK * 4;
  static constexpr int kSide = 4 * TK * 4;
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kXOff = kVOff + kStages * kTile;
  static constexpr int kSideOff = kXOff + 2 * kX;
  static constexpr int kQsOff = kSideOff + 2 * kSide;
  static constexpr int kRawOff = kQsOff + kBQ * 4;  // K's and V's rows, 2 each
  static constexpr int kBarOff = kRawOff + 4 * kRaw;
  static constexpr int kBytes = 1024 + kBarOff + (1 + 2 * kStages) * 8;
};

// The 16-byte unit u (columns 8u .. 8u + 7) of row r of a [TK][256] bf16
// tile.
__device__ __forceinline__ int unit_at(int r, int u) {
  return unit_offset<kCols * 2, TK>(r, u);
}

// A value that is the A operand of a wgmma, formed from `x` by an
// instruction of its own, so that the register it lands in is written here
// and not where x was computed or loaded (a wgmma reads its A registers
// until its wait, and PTX leaves a write to them before it undefined).
__device__ __forceinline__ uint32_t operand(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// kPaged: the packed rows of a page that hold tokens [h0, h0 + 32), bytes
// [c0, c0 + ncol) of each (`base` points at byte c0 of the page's first
// row), in chunks of CB bytes: 16 where D % 16 == 0 (the rows' alignment),
// else 8; at most 32 rows of 256 / CB chunks. Chunk c is row c / (256 /
// CB), bytes CB (c % (256 / CB)) onwards, so a lane always takes the same
// bytes of its rows (those past ncol it skips). The rows are h0 % Pp
// onwards, wrapping at Pp (token t sits in row t % Pp). Chunk c is copied
// by cp.async to raw + CB c and read back by the thread that copied it, so
// no barrier stands between the two.
template <int CB>
__device__ __forceinline__ void copy_raw(uint8_t* raw, const uint8_t* base,
                                         int D, int Pp, int h0, int tid) {
  constexpr int kLanes = kCols / CB, kPer = TK * kLanes / kThreads;
  const int rows = min(TK, Pp), r0 = h0 % Pp, u = tid % kLanes;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = tid + kThreads * i, ri = c / kLanes;
    if (ri < rows) {
      const int r = r0 + ri;
      const uint8_t* src = base + (size_t)(r < Pp ? r : r - Pp) * D + u * CB;
      if constexpr (CB == 16)
        cp_async16(raw + c * CB, src, 16);
      else
        cp_async8(raw + c * CB, src);
    }
  }
}

// The levels of the copied rows into the tile: byte (r, d) holds tokens
// r + p * Pp in bit field p; those in [h0, h0 + 32) are stored.
template <int BITS, int CB>
__device__ __forceinline__ void unpack_raw(const uint8_t* raw, int Pp, int h0,
                                           uint8_t* tile, int tid) {
  constexpr int kVpb = 8 / BITS, kLanes = kCols / CB;
  constexpr int kPer = TK * kLanes / kThreads;
  using W = typename std::conditional<CB == 16, uint4, uint2>::type;
  const int rows = min(TK, Pp), r0 = h0 % Pp, u = (tid % kLanes) * (CB / 8);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = tid + kThreads * i, ri = c / kLanes;
    if (ri >= rows) break;
    int r = r0 + ri;
    r = r < Pp ? r : r - Pp;
    const W w = *reinterpret_cast<const W*>(raw + c * CB);
#pragma unroll
    for (int p = 0; p < kVpb; ++p) {
      const int tok = r + p * Pp - h0;
      if (tok < 0 || tok >= TK) continue;
      quant_flash::st_shared(
          tile + unit_at(tok, u),
          quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.x, p)),
          quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.y, p)));
      if constexpr (CB == 16)
        quant_flash::st_shared(
            tile + unit_at(tok, u + 1),
            quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.z, p)),
            quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.w, p)));
    }
  }
}

// kContig: the bytes of `rows` packed rows of Dp bytes (`base`: the first
// row) that hold this block's channels, n bytes from byte s on, wrapping at
// Dp, into raw + 256 r + k (k < n: byte (s + k) % Dp of row r), in copies
// of CB bytes (CB divides Dp, s, n and the rows' address): cp.async of 16,
// 8 or 4 bytes, plain loads of 2 or 1.
template <int CB>
__device__ __forceinline__ void copy_contig(uint8_t* raw, const uint8_t* base,
                                            int Dp, int s, int n, int rows,
                                            int tid) {
  const int per = n / CB, run = min(n, Dp - s);  // copies a row; bytes to Dp
  for (int c = tid; c < rows * per; c += kThreads) {
    const int r = c / per, k = (c % per) * CB;
    const uint8_t* src = base + (size_t)r * Dp + (k < run ? s + k : k - run);
    uint8_t* dst = raw + r * kCols + k;
    if constexpr (CB == 16)
      cp_async16(dst, src, 16);
    else if constexpr (CB == 8)
      cp_async8(dst, src);
    else if constexpr (CB == 4)
      cp_async4(dst, src, 4);
    else if constexpr (CB == 2)
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
    else
      *dst = *src;
  }
}

// kContig: the levels of the copied rows into the tile. Column i < ncol of
// this block (channel c0 + i) is bit field (c0 + i) / Dp of raw[256 r + i %
// Dp]. A thread unpacks the 8 columns from 8u (u = tid % 32) of rows tid /
// 32 + 8h: with RUN (Dp % 8 == 0) one field of 8 consecutive bytes, read at
// once; else each column from its own byte and field.
template <int BITS, bool RUN>
__device__ __forceinline__ void unpack_contig(const uint8_t* raw, int Dp,
                                              int c0, int ncol, uint8_t* tile,
                                              int tid) {
  const int u = tid % (kCols / 8), i = 8 * u;
  if (i >= ncol) return;
#pragma unroll
  for (int h = 0; h < TK * kCols / 8 / kThreads; ++h) {
    const int r = tid / (kCols / 8) + h * (kThreads / (kCols / 8));
    const uint8_t* row = raw + r * kCols;
    if constexpr (RUN) {
      const int p = (c0 + i) / Dp;
      const uint2 w = *reinterpret_cast<const uint2*>(row + i % Dp);
      quant_flash::st_shared(
          tile + unit_at(r, u),
          quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.x, p)),
          quant_flash::bf16_levels<BITS>(quant_flash::field<BITS>(w.y, p)));
    } else {
      float lv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ch = c0 + i + e;
        lv[e] = (float)((row[(i + e) % Dp] >> ((ch / Dp) * BITS)) &
                        ((1 << BITS) - 1));
      }
      *reinterpret_cast<uint4*>(tile + unit_at(r, u)) =
          make_uint4(pack_bf16(lv[0], lv[1]), pack_bf16(lv[2], lv[3]),
                     pack_bf16(lv[4], lv[5]), pack_bf16(lv[6], lv[7]));
    }
  }
}

// This thread's C partial logits of a tile are kU float4 units, unit k at
// shared::cluster address x[r] + k * kThreads * 16 in block r. fetch()
// issues the loads of NB units, fold() adds each unit's C partials in rank
// order: a load from another block's shared memory takes several hundred
// clocks, so loads are issued together, and with clusters of 2 and 3 blocks
// (heads up to 768) those of a whole tile are issued a tile early.
template <int C, int NB>
__device__ __forceinline__ void fetch(float4 (&v)[NB][C], const uint32_t (&x)[C],
                                      int k0) {
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int r = 0; r < C; ++r)
      v[k][r] = ld_cluster_v4(x[r] + (k0 + k) * kThreads * 16);
}

template <int C, int NB>
__device__ __forceinline__ void fold(float (&s)[kS], const float4 (&v)[NB][C],
                                     int k0) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float4 acc = v[k][0];
#pragma unroll
    for (int r = 1; r < C; ++r) {
      acc.x = __fadd_rn(acc.x, v[k][r].x);
      acc.y = __fadd_rn(acc.y, v[k][r].y);
      acc.z = __fadd_rn(acc.z, v[k][r].z);
      acc.w = __fadd_rn(acc.w, v[k][r].w);
    }
    s[4 * (k0 + k)] = acc.x;
    s[4 * (k0 + k) + 1] = acc.y;
    s[4 * (k0 + k) + 2] = acc.z;
    s[4 * (k0 + k) + 3] = acc.w;
  }
}

// The same over s32 partials (kScratch8, N logits): exact, so in any
// order.
template <int C, int NB, int N>
__device__ __forceinline__ void fold(int (&s)[N], const float4 (&v)[NB][C],
                                     int k0) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      acc.x += __float_as_int(v[k][r].x);
      acc.y += __float_as_int(v[k][r].y);
      acc.z += __float_as_int(v[k][r].z);
      acc.w += __float_as_int(v[k][r].w);
    }
    s[4 * (k0 + k)] = acc.x;
    s[4 * (k0 + k) + 1] = acc.y;
    s[4 * (k0 + k) + 2] = acc.z;
    s[4 * (k0 + k) + 3] = acc.w;
  }
}

template <int C>
__device__ __forceinline__ void map_ranks(uint32_t (&x)[C], uint32_t at) {
#pragma unroll
  for (int r = 0; r < C; ++r) x[r] = cluster_map(at, r);
}

// The whole S of a tile (N logits, N / 4 units), its loads B units at a
// time (clusters of 4 to 8; of 2 to 8 in kScratch8).
template <int C, typename T, int N>
__device__ __forceinline__ void gather(T (&s)[N], uint32_t at) {
  constexpr int B = C <= 4 ? 2 : 1;
  uint32_t x[C];
  map_ranks<C>(x, at);
#pragma unroll
  for (int k0 = 0; k0 < N / 4; k0 += B) {
    float4 v[B][C];
    fetch<C, B>(v, x, k0);
    fold<C, B>(s, v, k0);
  }
}

// A slot with no page (kScratch16, kScratch8): its rows of this block's
// columns are 0 and, from rank 0, its lse -1e30, as in the plain version.
__device__ __forceinline__ void empty_rows(const Args& a, int q0, int rows0,
                                           int z, int rank, int c0, int ncol,
                                           int q4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    float* out = static_cast<float*>(a.out) + ((size_t)z * a.Sq + row) * a.D +
                 c0 + 2 * q4;
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(0.f, 0.f);
    }
    if (rank == 0 && q4 == 0) a.lse[(size_t)z * a.Sq + row] = kNegInf;
  }
}

// kPaged over a page chain split in a.nsplit parts (grid z): this block's
// partial (its columns of the unnormalized o, and m and l in natural units)
// goes to the scratch; the last of the splits' blocks of this column slice
// (an atomic count, which it resets) merges them in split order,
//   M = max_s m_s, w_s = exp(m_s - M), out = sum_s w_s o_s / sum_s w_s l_s,
//   lse = M + log(sum_s w_s l_s),
// the merge of `merge_partials` (ops/paged_attention.py) in terms of (m, l):
// where every key of every split is masked (all m_s = -1e30), lse - 1e30
// would lose log(l_s) in f32, and the merge would weigh the splits equally
// where the plain version weighs every key equally.
constexpr int kMaxSplit = 8;

template <bool kLse>  // whether rank 0 writes the lse (kPaged)
__device__ __forceinline__ void merge_splits(const Args& a,
                                             const float (&o)[kCols / 2],
                                             const float (&m)[2],
                                             const float (&l)[2], int q0,
                                             int rows0, int z, int C, int rank,
                                             int c0, int ncol, int q4) {
  __shared__ int last;
  const int split = blockIdx.z;
  const size_t plane = (size_t)a.Z * a.Sq * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    float* po = a.part_o + split * plane + ((size_t)z * a.Sq + row) * a.D + c0 +
                2 * q4;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;
      *reinterpret_cast<float2*>(po + 8 * j) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
    if (q4 == 0)
      a.part_ml[(((size_t)split * C + rank) * a.Z + z) * a.Sq + row] =
          make_float2(m[h], l[h]);
  }
  __threadfence();
  __syncthreads();
  int* count = a.counters + ((size_t)(blockIdx.x / C) * a.Z + z) * C + rank;
  if (threadIdx.x == 0) {
    last = atomicAdd(count, 1) == a.nsplit - 1;
    if (last) *count = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    float w[kMaxSplit], ls[kMaxSplit], M = -INFINITY, wl = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < a.nsplit) {
        const float2 ml = __ldcg(
            a.part_ml + (((size_t)s * C + rank) * a.Z + z) * a.Sq + row);
        w[s] = ml.x;
        ls[s] = ml.y;
        M = fmaxf(M, ml.x);
      }
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < a.nsplit) {
        w[s] = expf(w[s] - M);
        wl = __fmaf_rn(w[s], ls[s], wl);
      }
    const float inv = __fdiv_rn(1.f, wl);
    const size_t at = ((size_t)z * a.Sq + row) * a.D + c0 + 2 * q4;
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s)
        if (s < a.nsplit) {
          const float2 v = __ldcg(
              reinterpret_cast<const float2*>(a.part_o + s * plane + at + 8 * j));
          y0 = __fmaf_rn(w[s], v.x, y0);
          y1 = __fmaf_rn(w[s], v.y, y1);
        }
      *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + 8 * j) =
          make_float2(__fmul_rn(y0, inv), __fmul_rn(y1, inv));
    }
    if (kLse && rank == 0 && q4 == 0)
      a.lse[(size_t)z * a.Sq + row] = M + logf(wl);
  }
}

// CT: the cluster size for clusters of 2 and 3 blocks, whose S is fetched a
// tile early; 0 for any size (4 to 8), fetched when needed.
template <int MODE, int BITS, int CT>
__global__ void __launch_bounds__(kThreads, 1)
    wide_cluster_attention(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a) {
  using L = Smem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::kKOff;
  uint8_t* Vs = smem + L::kVOff;
  float* X = reinterpret_cast<float*>(smem + L::kXOff);
  float* sides = reinterpret_cast<float*>(smem + L::kSideOff);
  float* qpart = reinterpret_cast<float*>(smem + L::kQsOff);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* kfull = q_full + 1;
  uint64_t* vfull = kfull + kStages;

  const int C = a.C, rank = (int)cluster_rank();
  const int q0 = (blockIdx.x / C) * kBQ, z = blockIdx.y;
  const int c0 = rank * kCols, ncol = min(kCols, a.D - c0);
  const int nch = (ncol + 63) / 64;  // chunks of this block's slice loaded
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  // K and V by TMA (kDense, kScratch16), or as packed rows by cp.async
  constexpr bool kTma = MODE == kDense || MODE == kScratch16;
  // tiles a page (kPaged, kScratch16), and the tiles
  const int tpp = MODE == kPaged || MODE == kScratch16 ? (a.P + TK - 1) / TK
                                                      : 1;
  // the tiles, and this split's: [t0, t0 + T)
  const int Tall = MODE == kDense || MODE == kContig ? (a.Skv + TK - 1) / TK
                   : MODE == kPaged                  ? a.n_pages * tpp
                                     : a.slot_pages[z / a.H] * tpp;
  const int tps = (Tall + a.nsplit - 1) / a.nsplit, t0 = blockIdx.z * tps;
  const int T = min(tps, Tall - t0);
  const int Pp = MODE == kPaged ? a.P / (8 / BITS) : 1;
  if constexpr (MODE == kScratch16) {
    if (T == 0) {
      empty_rows(a, q0, rows0, z, rank, c0, ncol, q4);
      return;
    }
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
    }
    fence_barrier_init();
  }
  // zeros where no load writes: q's and (kDense, kScratch16) the tiles'
  // chunks past D; (kPaged, kContig) the whole K and V tiles, whose tokens
  // past a page's data and columns past D the loader leaves
  {
    uint4* qz = reinterpret_cast<uint4*>(Qs + nch * kBQ * kSw);
    for (int i = tid; i < (kChunks - nch) * kBQ * kSw / 16; i += kThreads)
      qz[i] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < 2 * kStages; ++s) {
      uint8_t* tile = Ks + s * L::kTile;  // K stages, then V stages
      const int from = kTma ? nch * TK * kSw : 0;
      uint4* p = reinterpret_cast<uint4*>(tile + from);
      for (int i = tid; i < (L::kTile - from) / 16; i += kThreads)
        p[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // kDense, kScratch16: a K or V tile of this block's columns by TMA (the
  // scratch's tile t is tokens [32 (t % tpp), + 32) of page t / tpp)
  auto load_tile = [&](const CUtensorMap* map, uint8_t* ring, uint64_t* bars,
                       int t) {
    const int s = t % kStages;
    const int row = MODE == kDense ? (t0 + t) * TK
                                   : (t / tpp) * a.PT + (t % tpp) * TK;
    mbar_expect_tx(bars + s, nch * TK * kSw);
    for (int c = 0; c < nch; ++c)
      tma_load_3d(ring + s * L::kTile + c * TK * kSw, map, bars + s,
                  c0 + 64 * c, row, z);
  };
  // kPaged: the pool row of (slot, head); the slots (and the tokens of the
  // pages) are read a tile before they are used
  auto slot_of = [&](int t) {
    return t < T ? a.page_table[(t0 + t) / tpp] : 0;
  };
  auto pool_row = [&](int slot) {
    if (slot < 0 || slot >= a.n_slots) __trap();
    return (size_t)slot * a.Z + z;
  };
  // the packed rows of K tile j at kraw(j), of V tile j at vraw(j)
  auto kraw = [&](int j) { return smem + L::kRawOff + (j & 1) * kRaw; };
  auto vraw = [&](int j) { return smem + L::kRawOff + (2 + (j & 1)) * kRaw; };
  // the rows of a block's columns are 16-byte aligned where D % 16 == 0;
  // the threads past its columns (ncol < 256) copy and unpack nothing
  const bool cb16 = a.D % 16 == 0;
  const bool has_cols = tid % (cb16 ? kCols / 16 : kCols / 8) <
                        ncol / (cb16 ? 16 : 8);
  auto raw_of = [&](uint8_t* raw, const uint8_t* data, int t, int slot) {
    const uint8_t* base = data + pool_row(slot) * Pp * a.D + c0;
    const int h0 = ((t0 + t) % tpp) * TK;
    if (!has_cols) return;
    if (cb16)
      copy_raw<16>(raw, base, a.D, Pp, h0, tid);
    else
      copy_raw<8>(raw, base, a.D, Pp, h0, tid);
  };
  auto unpack = [&](const uint8_t* raw, int t, uint8_t* ring) {
    const int h0 = ((t0 + t) % tpp) * TK;
    uint8_t* tile = ring + (t % kStages) * L::kTile;
    if (!has_cols) return;
    if (cb16)
      unpack_raw<BITS, 16>(raw, Pp, h0, tile, tid);
    else
      unpack_raw<BITS, 8>(raw, Pp, h0, tile, tid);
  };
  // the sidecars of tile t: ks, kz, vs, vz of token tid (tid < 32), read
  // ahead into registers, then stored as ka' = ks * sm, kb = ka' * kz, vs,
  // vz
  auto side_of = [&](int t, int slot) {
    const int h0 = ((t0 + t) % tpp) * TK;
    const size_t pg = pool_row(slot);
    float4 sd = make_float4(0.f, 0.f, 0.f, 0.f);
    const int tok = h0 + tid;
    if (tid < TK && tok < a.P) {
      const size_t at = pg * a.P + tok;
      sd = make_float4(a.k_scale[at], a.k_zp[at], a.v_scale[at], a.v_zp[at]);
    }
    return sd;
  };
  auto put_side = [&](float4 sd, int t) {
    float* d = sides + (t & 1) * 4 * TK;
    if (tid < TK) {
      const float ka = __fmul_rn(sd.x, a.sm);
      d[tid] = ka;
      d[TK + tid] = __fmul_rn(ka, sd.y);
      d[2 * TK + tid] = sd.z;
      d[3 * TK + tid] = sd.w;
    }
  };
  // kScratch16: the scratch's sidecars of tile t (ka', kb, vc = vs * vz of
  // token tid), staged as (ka', kb, 1, vc): logits() and weights() then
  // give p itself for bf16(p) . v_sc and sum p * vc
  auto scr_side = [&](int t) {
    float4 sd = make_float4(0.f, 0.f, 1.f, 0.f);
    if (tid < TK) {
      const float* f = a.side + ((size_t)z * a.n_max + t / tpp) * 3 * a.PT +
                       (t % tpp) * TK + tid;
      sd = make_float4(f[0], f[a.PT], 1.f, f[2 * a.PT]);
    }
    return sd;
  };
  auto put_scr = [&](float4 sd, int t) {
    float* d = sides + (t & 1) * 4 * TK;
    if (tid < TK) {
      d[tid] = sd.x;
      d[TK + tid] = sd.y;
      d[2 * TK + tid] = sd.z;
      d[3 * TK + tid] = sd.w;
    }
  };
  auto scr_tokens = [&](int t) {
    return a.page_tokens[(size_t)(z / a.H) * a.n_max + t / tpp];
  };
  // kContig: the n = min(ncol, Dp) bytes of a packed row from byte c0 % Dp
  // on hold this block's channels; they are copied CB bytes at once, the
  // largest of 16, 8, 4, 2, 1 that divides Dp, n and the pointers (cp.async
  // needs the smaller the alignment), and unpacked after a barrier
  const int Dp = MODE == kContig ? a.D / (8 / BITS) : 1;
  const int cn = min(ncol, Dp), cs = c0 % Dp;
  const int cb = [&] {
    const uintptr_t at = (uintptr_t)a.k_data | (uintptr_t)a.v_data;
    const unsigned any =
        (unsigned)Dp | (unsigned)cn | (unsigned)(at & 15) | 16u;
    return (int)(any & (0u - any));  // the lowest set bit
  }();
  auto craw = [&](uint8_t* raw, const uint8_t* data, int t) {
    const int tok = (t0 + t) * TK, rows = min(TK, a.Skv - tok);
    const uint8_t* base = data + ((size_t)z * a.Skv + tok) * Dp;
    switch (cb) {
      case 16: copy_contig<16>(raw, base, Dp, cs, cn, rows, tid); break;
      case 8: copy_contig<8>(raw, base, Dp, cs, cn, rows, tid); break;
      case 4: copy_contig<4>(raw, base, Dp, cs, cn, rows, tid); break;
      case 2: copy_contig<2>(raw, base, Dp, cs, cn, rows, tid); break;
      default: copy_contig<1>(raw, base, Dp, cs, cn, rows, tid); break;
    }
  };
  auto cunpack = [&](const uint8_t* raw, int t, uint8_t* ring) {
    uint8_t* tile = ring + (t % kStages) * L::kTile;
    if constexpr (BITS == 8) {
      unpack_contig<BITS, true>(raw, Dp, c0, ncol, tile, tid);
    } else {
      if (Dp % 8 == 0)
        unpack_contig<BITS, true>(raw, Dp, c0, ncol, tile, tid);
      else
        unpack_contig<BITS, false>(raw, Dp, c0, ncol, tile, tid);
    }
  };
  // kContig: the sidecars of tile t, token tid (tid < 32; 0 past Skv)
  auto cside_of = [&](int t) {
    const int tok = (t0 + t) * TK + tid;
    float4 sd = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < TK && tok < a.Skv) {
      const size_t at = (size_t)z * a.Skv + tok;
      sd = make_float4(a.k_scale[at], a.k_zp[at], a.v_scale[at], a.v_zp[at]);
    }
    return sd;
  };

  if (tid == 0) {
    mbar_expect_tx(q_full, nch * kBQ * kSw);
    for (int c = 0; c < nch; ++c)
      tma_load_3d(Qs + c * kBQ * kSw, &tq, q_full, c0 + 64 * c, q0, z);
    if constexpr (kTma) {
      for (int t = 0; t < kStages && t < T; ++t) load_tile(&tk, Ks, kfull, t);
      for (int t = 0; t < kStages - 1 && t < T; ++t)
        load_tile(&tv, Vs, vfull, t);
    }
  }
  __syncwarp();

  float qs[2] = {0.f, 0.f};
  // q's channel sums over this block's columns, two threads a row, in
  // column order; then the C partial sums in rank order
  auto q_sums = [&]() {
    {
      const int r = tid >> 1, half = tid & 1;
      float s = 0.f;
      for (int c = 2 * half; c < 2 * half + 2; ++c)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              Qs + c * kBQ * kSw + r * kSw + ((u ^ (r & 7)) << 4));
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s += __bfloat162float(h[e].x) + __bfloat162float(h[e].y);
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's halves
      if (half == 0) qpart[r] = s;
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = smem_u32(qpart + rows0 + 8 * h);
      qs[h] = ld_cluster_f32(cluster_map(at, 0));
      for (int r = 1; r < C; ++r)
        qs[h] = __fadd_rn(qs[h], ld_cluster_f32(cluster_map(at, r)));
    }
  };
  if constexpr (MODE == kPaged) {
    for (int t = 0; t < 2 && t < T; ++t) {
      raw_of(kraw(t), a.k_data, t, slot_of(t));
      cp_async_wait_all();
      unpack(kraw(t), t, Ks);
    }
    raw_of(vraw(0), a.v_data, 0, slot_of(0));
    cp_async_wait_all();
    unpack(vraw(0), 0, Vs);
    put_side(side_of(0, slot_of(0)), 0);
    // the rows the first tile unpacks: copies run two tiles ahead
    if (T > 2) raw_of(kraw(2), a.k_data, 2, slot_of(2));
    if (T > 1) raw_of(vraw(1), a.v_data, 1, slot_of(1));
    cp_async_commit();
    fence_proxy_async();
    mbar_wait(q_full, 0);
    q_sums();
  } else if constexpr (MODE == kContig) {
    // tiles 0 and 1 of K and tile 0 of V, unpacked by every thread once all
    // have landed; then the copies two tiles ahead
    craw(kraw(0), a.k_data, 0);
    if (T > 1) craw(kraw(1), a.k_data, 1);
    craw(vraw(0), a.v_data, 0);
    cp_async_wait_all();
    __syncthreads();
    cunpack(kraw(0), 0, Ks);
    if (T > 1) cunpack(kraw(1), 1, Ks);
    cunpack(vraw(0), 0, Vs);
    put_side(cside_of(0), 0);
    __syncthreads();  // the rows read before the next copies overwrite them
    if (T > 2) craw(kraw(2), a.k_data, 2);
    if (T > 1) craw(vraw(1), a.v_data, 1);
    cp_async_commit();
    fence_proxy_async();
    mbar_wait(q_full, 0);
    q_sums();
  } else if constexpr (MODE == kScratch16) {
    put_scr(scr_side(0), 0);
    mbar_wait(q_full, 0);
    q_sums();  // its cluster barrier also orders the sidecars' stores
  } else {
    mbar_wait(q_full, 0);
  }

  // this warpgroup's rows of q, chunk c at q_addr + c * kBQ * kSw
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * kSw;
  // S of tile t over this block's columns into s, 16 columns a k-step
  auto issue_s = [&](float(&s)[kS], int t) {
    const uint32_t k_addr = smem_u32(Ks + (t % kStages) * L::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      const int chunk = kk / 4, in = (kk % 4) * 32;
      wgmma_ss<TK>(s,
                   gmma_desc(q_addr + chunk * kBQ * kSw + in, 16, 8 * kSw, 1),
                   gmma_desc(k_addr + chunk * TK * kSw + in, 16, 8 * kSw, 1),
                   kk > 0);
    }
    wgmma_commit();
  };
  // this block's partial S into buffer b, a thread's logits as kU float4
  // units (unit k of thread i at k * 256 + i: a warp's accesses hit
  // distinct banks)
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  auto put = [&](const float(&s)[kS], int b) {
    float4* xb = reinterpret_cast<float4*>(X + b * (L::kX / 4));
#pragma unroll
    for (int k = 0; k < kU; ++k)
      xb[k * kThreads + tid] =
          make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  };
  // S of the tile in buffer b: the C partials, added in rank order; with
  // CT, loaded by prefetch(b) a tile early
  float4 vpre[kU][CT > 0 ? CT : 1];
  auto prefetch = [&](int b) {
    if constexpr (CT > 0) {
      uint32_t x[CT];
      map_ranks<CT>(x, x_addr + b * L::kX);
      fetch<CT, kU>(vpre, x, 0);
    }
  };
  auto gather_b = [&](float(&s)[kS], int b) {
    if constexpr (CT > 0) {
      fold<CT, kU>(s, vpre, 0);
    } else {
      const uint32_t at = x_addr + b * L::kX;
      switch (C) {
        case 4: gather<4>(s, at); break;
        case 5: gather<5>(s, at); break;
        case 6: gather<6>(s, at); break;
        case 7: gather<7>(s, at); break;
        default: gather<8>(s, at); break;
      }
    }
  };

  float o[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  // running max (kDense: in log2 units, logits times sm * log2(e)), sum
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float sl2 = a.sm * kLog2e;
  float cur[kS], nxt[kS];

  if constexpr (kTma) mbar_wait(kfull, 0);
  issue_s(nxt, 0);
  wgmma_wait<0>();
  fence_regs(nxt);
  put(nxt, 0);
  cluster_arrive();
  cluster_wait();  // every block's partial S of tile 0
  prefetch(0);
  // kPaged: the slots of tiles t + 3 (K rows copied), t + 2 (V rows) and
  // t + 1 (sidecars), and the tokens of tile t's page
  int slot3 = 0, slot2 = 0, slot1 = 0, tokens = 0;
  if constexpr (MODE == kPaged) {
    slot3 = slot_of(3);
    slot2 = slot_of(2);
    slot1 = slot_of(1);
    tokens = a.page_tokens[t0 / tpp];
  } else if constexpr (MODE == kScratch16) {
    tokens = scr_tokens(0);
  }

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    const int b = t & 1;
    if (more) {  // S of the next tile runs under this one's exchange
      if constexpr (kTma)
        mbar_wait(kfull + (t + 1) % kStages, ((t + 1) / kStages) & 1);
      issue_s(nxt, t + 1);
    }
    float4 sd_next = make_float4(0.f, 0.f, 0.f, 0.f);
    int slot_next = 0, tokens_next = 0;
    if constexpr (kTma) {
      if (tid == 0 && t + kStages < T) load_tile(&tk, Ks, kfull, t + kStages);
      __syncwarp();
      if constexpr (MODE == kScratch16) {
        if (more) {
          sd_next = scr_side(t + 1);
          tokens_next = scr_tokens(t + 1);
        }
      }
    } else if constexpr (MODE == kPaged) {  // the packed rows of the tiles
      // unpacked a tile later
      if (t + 3 < T) raw_of(kraw(t + 3), a.k_data, t + 3, slot3);
      if (t + 2 < T) raw_of(vraw(t + 2), a.v_data, t + 2, slot2);
      cp_async_commit();
      if (more) {
        sd_next = side_of(t + 1, slot1);
        tokens_next = a.page_tokens[(t0 + t + 1) / tpp];
      }
      slot_next = slot_of(t + 4);
    } else {
      if (t + 3 < T) craw(kraw(t + 3), a.k_data, t + 3);
      if (t + 2 < T) craw(vraw(t + 2), a.v_data, t + 2);
      cp_async_commit();
      if (more) sd_next = cside_of(t + 1);
    }
    gather_b(cur, b);

    // online softmax; this thread holds rows g and g + 8 of its warp's 16,
    // tokens 8j + 2 q4 + (e & 1) of entry 4j + e
    float alpha[2], csum[2] = {0.f, 0.f};
    if constexpr (MODE == kDense) {
      const int kv0 = (t0 + t) * TK;
      if (kv0 + TK > a.Skv) {
#pragma unroll
        for (int i = 0; i < kS; ++i)
          if (kv0 + (i >> 2) * 8 + q4 * 2 + (i & 1) >= a.Skv) cur[i] = kNegInf;
      }
      float mx[2] = {kNegInf, kNegInf}, rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], cur[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], quant_flash::quad_max(mx[h]) * sl2);
        alpha[h] = quant_flash::ex2(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int h = (i >> 1) & 1;
        cur[i] = quant_flash::ex2(fmaf(cur[i], sl2, -m_run[h]));
        rsum[h] += cur[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_run[h] = l_run[h] * alpha[h] + quant_flash::quad_sum(rsum[h]);
    } else {
      int present, valid;
      if constexpr (MODE == kContig) {
        present = valid = min(a.Skv - (t0 + t) * TK, TK);
      } else {
        const int h0 = ((t0 + t) % tpp) * TK;
        present = min(a.P - h0, TK);
        valid = min(max(min(tokens, a.P) - h0, 0), TK);
      }
      const float* sd = sides + (t & 1) * 4 * TK;
      float msc[2], rsum[2] = {0.f, 0.f};
      if (valid < TK) {
        quant_flash::logits<true, TK>(cur, sd, qs, q4, valid, m_run, alpha, msc);
        quant_flash::weights<true, TK>(cur, sd, q4, valid, present, m_run, msc,
                                       rsum, csum);
      } else {
        quant_flash::logits<false, TK>(cur, sd, qs, q4, valid, m_run, alpha, msc);
        quant_flash::weights<false, TK>(cur, sd, q4, valid, present, m_run,
                                        msc, rsum, csum);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] = l_run[h] * alpha[h] + quant_flash::quad_sum(rsum[h]);
        csum[h] = quant_flash::quad_sum(csum[h]);
      }
    }

    // bf16(p) (kPaged: bf16(p * vs)), packed now into registers of their
    // own: the tokens of n-block j go to register (j & 1) * 2 + r of step
    // j / 2
    uint32_t pk[TK / 16][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      pk[j >> 1][(j & 1) * 2] = pack_bf16(cur[4 * j], cur[4 * j + 1]);
      pk[j >> 1][(j & 1) * 2 + 1] = pack_bf16(cur[4 * j + 2], cur[4 * j + 3]);
    }

    // P.V of tile t - 1 and S of tile t + 1 are done: o is ours, P.V of
    // tile t goes to the tensor cores and then S of tile t + 1 to the
    // cluster. (One wait for every product before an accumulator is read:
    // where a wait retires only the older of two groups ptxas cannot tell
    // which across the loop, and serializes every wgmma of the kernel.)
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(nxt);
    // P.V's A operand, written only now: P.V of tile t - 1 reads the same
    // registers until the wait above
    uint32_t pf[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = operand(pk[kk][r]);
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) {
      if constexpr (MODE == kDense)
        o[i] *= alpha[(i >> 1) & 1];
      else
        o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], -csum[(i >> 1) & 1]);
    }
    if constexpr (kTma) mbar_wait(vfull + t % kStages, (t / kStages) & 1);
    const uint32_t v_addr = smem_u32(Vs + (t % kStages) * L::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<kCols, 1>(o, pf[kk],
                         gmma_desc(v_addr + kk * 16 * kSw, TK * kSw, 8 * kSw, 1),
                         1);
    wgmma_commit();
    if (more) {
      put(nxt, b ^ 1);
      cluster_arrive();
    }
    if constexpr (MODE == kScratch16) {
      if (more) {
        put_scr(sd_next, t + 1);
        tokens = tokens_next;
      }
    }
    // kContig: the rows copied a tile ago, which other threads unpack
    if constexpr (MODE == kContig) cp_async_wait<1>();
    __syncthreads();  // both warpgroups' P.V of tile t - 1: its V stage free
    if constexpr (kTma) {
      if (tid == 0 && t + kStages - 1 < T)
        load_tile(&tv, Vs, vfull, t + kStages - 1);
      __syncwarp();
    }
    if (more) {
      cluster_wait();  // every block's partial S of tile t + 1
      prefetch(b ^ 1);
    }

    if constexpr (MODE == kPaged) {  // the next tiles, under P.V
      cp_async_wait<1>();  // the rows copied a tile ago
      if (t + 2 < T) unpack(kraw(t + 2), t + 2, Ks);
      if (more) {
        unpack(vraw(t + 1), t + 1, Vs);
        put_side(sd_next, t + 1);
      }
      fence_proxy_async();
      __syncthreads();  // every thread's levels before the products read them
      slot1 = slot2;
      slot2 = slot3;
      slot3 = slot_next;
      tokens = tokens_next;
    } else if constexpr (MODE == kContig) {
      if (t + 2 < T) cunpack(kraw(t + 2), t + 2, Ks);
      if (more) {
        cunpack(vraw(t + 1), t + 1, Vs);
        put_side(sd_next, t + 1);
      }
      fence_proxy_async();
      __syncthreads();  // every thread's levels before the products read
                        // them, and its reads before the next copies
    }
  }
  wgmma_wait<0>();
  fence_regs(o);

  if ((MODE == kPaged || MODE == kContig) && a.nsplit > 1) {
    merge_splits<MODE == kPaged>(a, o, m_run, l_run, q0, rows0, z, C, rank,
                                 c0, ncol, q4);
  } else {
  // out (this block's columns), and the lse from rank 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    const size_t at = ((size_t)z * a.Sq + row) * a.D + c0 + 2 * q4;
    const float l = l_run[h], inv = __frcp_rn(l);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;  // columns past D are not stored
      float y0 = o[4 * j + 2 * h], y1 = o[4 * j + 2 * h + 1];
      if constexpr (MODE == kDense) {
        y0 = __fdiv_rn(y0, l);
        y1 = __fdiv_rn(y1, l);
      } else {
        y0 = __fmul_rn(y0, inv);
        y1 = __fmul_rn(y1, inv);
      }
      if (MODE == kDense && a.out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + at +
                                     8 * j) = pack_bf16(y0, y1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + 8 * j) =
            make_float2(y0, y1);
    }
    if ((MODE == kPaged || MODE == kScratch16) && rank == 0 && q4 == 0)
      a.lse[(size_t)z * a.Sq + row] = m_run[h] + logf(l);
  }
  }
  // no block leaves while another may still read its partials
  cluster_arrive();
  cluster_wait();
}

// ------------------------------------------------------------- kScratch8

// The tokens of a sub-tile of the int8 kernel at pages of PT tokens (the
// partial S goes to the cluster a sub-tile at a time): 64, or the page of
// 32. Sub-tiles of 64 halve the cluster barriers of a page of 128 beside
// sub-tiles of 32, and ran 8% faster at heads of 384 and 768.
__host__ __device__ constexpr int a8_subtile(int PT) {
  return PT < 64 ? PT : 64;
}

// Shared memory of the int8 kernel (PT: the scratch's page tile, U: the
// tokens a sub-tile): q int8 [128][256] (two chunks of [128][128 B],
// 128-byte swizzle, as TMA lays out K), three stages of a K sub-tile int8
// [U][256] (two chunks), two stages of a page's V^T rows of this block's
// columns [256][PT] (swizzled over rows of PT bytes) with the page's sidecar
// rows (ka', kb', vs, vz') beside them, two buffers of partial S (s32, 128
// x U), q's row statistics (partial amax, partial sum of qi, sq), and the
// mbarriers (K full a stage; V^T and sidecars full a stage): 214.5 KB at
// PT = 128.
template <int PT, int U = a8_subtile(PT)>
struct Smem8 {
  static constexpr int kQ = kBQ * kCols;
  static constexpr int kK = U * kCols;
  static constexpr int kV = kCols * PT;
  static constexpr int kSide = 4 * PT * 4;
  static constexpr int kX = kBQ * U * 4;
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kSideOff = kVOff + 2 * kV;
  static constexpr int kXOff = kSideOff + 2 * kSide;
  static constexpr int kRowOff = kXOff + 2 * kX;
  static constexpr int kBarOff = kRowOff + 3 * kBQ * 4;
  static constexpr int kBytes = 1024 + kBarOff + (kStages + 2) * 8;
};

// kScratch8: the int8 path over the int8 scratch, K [Z, n_max, PT, DK] and
// V^T [Z, n_max, DK, PT] (tokens in `vt_columns` order). A page's tile of
// PT tokens runs as NT = PT / U sub-tiles of U = a8_subtile(PT) whose S
// this thread holds until the page's last (its softmax weights are
// requantized per page, so the page's whole S comes first); then the
// page's softmax, wi = rint(w / sw) into the register A operand
// (`vt_columns` order), and P.V as two m64n128k32 products of this block's
// 256 columns, each s32 sum folded into o before the next (o 128, wi PT / 8
// and one sum 64 registers a thread). The C partials of a sub-tile are
// loaded when they are added: loading them a sub-tile early, as
// wide_cluster_attention does for clusters of 2 and 3, kept 32-48 more
// registers live beside the page's S and ran 3-9% slower (more spills).
template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
    wide_cluster_attention_a8(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const Args a) {
  constexpr int U = a8_subtile(PT), NT = PT / U;
  using L = Smem8<PT>;
  constexpr int kSU = U / 2, kUU = U / 8;  // logits a thread, float4 units
  constexpr int kVSw = swizzle_of(PT);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::kKOff;
  uint8_t* Vs = smem + L::kVOff;
  float* sides = reinterpret_cast<float*>(smem + L::kSideOff);
  float* X = reinterpret_cast<float*>(smem + L::kXOff);
  float* qamax = reinterpret_cast<float*>(smem + L::kRowOff);
  int* qisum = reinterpret_cast<int*>(qamax + kBQ);
  float* qsq = qamax + 2 * kBQ;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* vfull = kfull + kStages;

  const int C = a.C, rank = (int)cluster_rank();
  const int q0 = (blockIdx.x / C) * kBQ, z = blockIdx.y;
  const int c0 = rank * kCols, ncol = min(kCols, a.D - c0);
  const int nch = (ncol + 127) / 128;  // 128-byte chunks of K loaded
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  const int slot = z / a.H, n_pages = a.slot_pages[slot], T = n_pages * NT;
  if (T == 0) {
    empty_rows(a, q0, rows0, z, rank, c0, ncol, q4);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(kfull + s, 1);
    for (int s = 0; s < 2; ++s) mbar_init(vfull + s, 1);
    fence_barrier_init();
  }
  if (nch < 2) {  // K's second chunk, which no load writes, stays zero
    for (int s = 0; s < kStages; ++s) {
      uint4* p = reinterpret_cast<uint4*>(Ks + s * L::kK + U * 128);
      for (int i = tid; i < U * 128 / 16; i += kThreads)
        p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // K sub-tile t (tokens [U (t % NT), + U) of page t / NT) and page j's
  // V^T rows and sidecars, by TMA and a bulk copy
  auto load_k = [&](int t) {
    const int s = t % kStages;
    mbar_expect_tx(kfull + s, nch * U * 128);
    for (int c = 0; c < nch; ++c)
      tma_load_3d(Ks + s * L::kK + c * U * 128, &tk, kfull + s, c0 + 128 * c,
                  (t / NT) * PT + (t % NT) * U, z);
  };
  auto load_v = [&](int j) {
    const int s = j & 1;
    mbar_expect_tx(vfull + s, L::kV + L::kSide);
    tma_load_4d(Vs + s * L::kV, &tv, vfull + s, 0, c0, j, z);
    bulk_load(sides + s * 4 * PT,
              a.side + ((size_t)z * a.n_max + j) * 4 * PT, L::kSide,
              vfull + s);
  };
  if (tid == 0) {
    for (int t = 0; t < kStages && t < T; ++t) load_k(t);
    for (int j = 0; j < 2 && j < n_pages; ++j) load_v(j);
  }
  __syncwarp();

  // q, two threads a row, 128 columns each: the row's amax over the whole
  // head (the C partial maxima, exact in any order), sq = amax / 127 (1
  // where 0), qi = rint(q / sq) into the q tile, and qsum = sum(qi) * sq
  // (the C partial sums, integers); rows past Sq and columns past D are 0
  float sq[2], qs[2];
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    const int d0 = c0 + 128 * half;
    const __nv_bfloat16* qr = a.q + ((size_t)z * a.Sq + row) * a.D + d0;
    uint4 w[16];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] = make_uint4(0u, 0u, 0u, 0u);
      if (row < a.Sq && d0 + 8 * i < a.D)
        w[i] = *reinterpret_cast<const uint4*>(qr + 8 * i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        amax = fmaxf(amax, fmaxf(fabsf(__bfloat162float(h[e].x)),
                                 fabsf(__bfloat162float(h[e].y))));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    if (half == 0) qamax[r] = amax;
    cluster_arrive();
    cluster_wait();
    const uint32_t at = smem_u32(qamax + r);
    for (int k = 0; k < C; ++k)
      amax = fmaxf(amax, ld_cluster_f32(cluster_map(at, k)));
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    int isum = 0;
    uint8_t* qt = Qs + half * kBQ * 128 + r * 128;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const __nv_bfloat16* x16 =
          reinterpret_cast<const __nv_bfloat16*>(&w[2 * u]);
      int qi[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        qi[k] = (int)rintf(__fdiv_rn(__bfloat162float(x16[k]), scale));
        isum += qi[k];
      }
      *reinterpret_cast<uint4*>(qt + ((u ^ (r & 7)) << 4)) = make_uint4(
          paged_flash::pack_s8(qi[0], qi[1], qi[2], qi[3]),
          paged_flash::pack_s8(qi[4], qi[5], qi[6], qi[7]),
          paged_flash::pack_s8(qi[8], qi[9], qi[10], qi[11]),
          paged_flash::pack_s8(qi[12], qi[13], qi[14], qi[15]));
    }
    isum += __shfl_xor_sync(0xffffffffu, isum, 1);
    if (half == 0) {
      qisum[r] = isum;
      qsq[r] = scale;
    }
    fence_proxy_async();  // the q tile, for the S products
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at2 = smem_u32(qisum + rows0 + 8 * h);
      int total = 0;
      for (int k = 0; k < C; ++k)
        total += __float_as_int(ld_cluster_f32(cluster_map(at2, k)));
      sq[h] = qsq[rows0 + 8 * h];
      qs[h] = __fmul_rn((float)total, sq[h]);
    }
  }

  // this warpgroup's rows of q, chunk c at q_addr + c * kBQ * 128
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
  // the partial S of sub-tile t over this block's columns, 32 columns a
  // k-step
  auto issue_s = [&](int (&s)[kSU], int t) {
    const uint32_t k_addr = smem_u32(Ks + (t % kStages) * L::kK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 32; ++kk) {
      const int chunk = kk / 4, in = (kk % 4) * 32;
      wgmma_s8_ss<U>(s,
                     gmma_desc(q_addr + chunk * kBQ * 128 + in, 16, 1024, 1),
                     gmma_desc(k_addr + chunk * U * 128 + in, 16, 1024, 1),
                     kk > 0);
    }
    wgmma_commit();
  };
  // the partials through buffer b, as in wide_cluster_attention
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  auto put = [&](const int (&s)[kSU], int b) {
    int4* xb = reinterpret_cast<int4*>(X + b * (L::kX / 4));
#pragma unroll
    for (int k = 0; k < kUU; ++k)
      xb[k * kThreads + tid] =
          make_int4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  };
  auto gather_b = [&](int (&s)[kSU], int b) {
    const uint32_t at = x_addr + b * L::kX;
    switch (C) {
      case 2: gather<2>(s, at); break;
      case 3: gather<3>(s, at); break;
      case 4: gather<4>(s, at); break;
      case 5: gather<5>(s, at); break;
      case 6: gather<6>(s, at); break;
      case 7: gather<7>(s, at); break;
      default: gather<8>(s, at); break;
    }
  };

  float o[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int cur[kSU], nxt[kSU];
  // the page's S (sub-tile h at h * kSU; this thread's rows g and g + 8,
  // tokens 8n + 2 q4 + (e & 1) of entry 4n + e), then its logits, then w
  float x[NT * kSU];

  // page j, once its whole S is here: the logits (raw = S * sq; raw * ka'
  // - kb' * qsum; -1e30 past the valid tokens), the online softmax, w = p *
  // vs (0 past the valid tokens) with sum w * vz' and the page maximum, sw
  // = max w / 127 (1 where 0), wi = rint(w / sw); then P.V and the fold
  // o = o * alpha + (wi . v) * sw - sum w * vz'. A masked token weighs 1
  // while every key its row has seen is masked and it holds data (below
  // P), as in the plain version.
  auto page = [&](auto mask, int j, int valid) {
    constexpr bool kMask = decltype(mask)::value;
    const int s = j & 1;
    mbar_wait(vfull + s, (j >> 1) & 1);
    const float* sd = sides + s * 4 * PT;
    float mx[2] = {m_run[0], m_run[1]}, alpha[2], msc[2];
#pragma unroll
    for (int n = 0; n < NT * U / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float2 ka = *reinterpret_cast<const float2*>(sd + col);
      const float2 kb = *reinterpret_cast<const float2*>(sd + PT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float raw = __fmul_rn(x[4 * n + e], sq[r]);
        float y = __fsub_rn(__fmul_rn(raw, (e & 1) ? ka.y : ka.x),
                            __fmul_rn((e & 1) ? kb.y : kb.x, qs[r]));
        if (kMask && col + (e & 1) >= valid) y = kNegInf;
        x[4 * n + e] = y;
        mx[r] = fmaxf(mx[r], y);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quant_flash::quad_max(mx[r]);
      alpha[r] = quant_flash::ex2((m_run[r] - mx[r]) * kLog2e);
      msc[r] = mx[r] * kLog2e;
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f}, wmax[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT * U / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float2 vs = *reinterpret_cast<const float2*>(sd + 2 * PT + col);
      const float2 vz = *reinterpret_cast<const float2*>(sd + 3 * PT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, tok = col + (e & 1);
        float p = quant_flash::ex2(__fmaf_rn(x[4 * n + e], kLog2e, -msc[r]));
        float w = __fmul_rn(p, (e & 1) ? vs.y : vs.x);
        if (kMask && tok >= valid) {
          p = m_run[r] == kNegInf && tok < a.P ? 1.f : 0.f;
          w = 0.f;
        }
        rsum[r] += p;
        csum[r] = __fmaf_rn(w, (e & 1) ? vz.y : vz.x, csum[r]);
        wmax[r] = fmaxf(wmax[r], w);
        x[4 * n + e] = w;
      }
    }
    float sw[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quant_flash::quad_sum(rsum[r]);
      wmax[r] = quant_flash::quad_max(wmax[r]);
      sw[r] = wmax[r] > 0.f ? __fdiv_rn(wmax[r], 127.f) : 1.f;
      rs[r] = __frcp_rn(sw[r]);
      csum[r] = quant_flash::quad_sum(csum[r]);
    }
    // wi, 0..127: step kk of 32 tokens, register 0 row g's tokens of
    // n-blocks 4kk and 4kk + 1, register 2 those of 4kk + 2 and 4kk + 3,
    // registers 1 and 3 row g + 8's (the `vt_columns` order of V^T)
    constexpr int kSteps = NT * U / 32;  // of 32 tokens
    uint32_t pf[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n0 = 4 * kk + 2 * hf;
          int wi[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wi[e] = paged_flash::rint_bits(paged_flash::div_by(
                x[4 * (n0 + (e >> 1)) + 2 * r + (e & 1)], sw[r], rs[r]));
          pf[kk][hf * 2 + r] = paged_flash::pack_s8(wi[0], wi[1], wi[2], wi[3]);
        }
    // P.V, 128 of this block's columns at a time, each s32 sum folded into
    // o as it comes back (one wait for every product before it is read)
    const uint32_t v_addr = smem_u32(Vs + s * L::kV);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int pv[kCols / 4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_s8<kCols / 2>(
            pv, pf[kk],
            gmma_desc(v_addr + half * (kCols / 2) * PT + kk * 32, 16,
                      8 * kVSw, layout_of(kVSw)),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < kCols / 4; ++i) {
        const int r = (i >> 1) & 1;
        float& y = o[half * (kCols / 4) + i];
        y = __fsub_rn(__fmaf_rn(paged_flash::i2f(pv[i]), sw[r],
                                __fmul_rn(y, alpha[r])),
                      csum[r]);
      }
    }
  };

  mbar_wait(kfull, 0);
  issue_s(nxt, 0);
  wgmma_wait<0>();
  fence_regs(nxt);
  put(nxt, 0);
  cluster_arrive();
  cluster_wait();  // every block's partial S of tile 0

#pragma unroll 1
  for (int j = 0; j < n_pages; ++j) {
    const int valid = min(a.page_tokens[(size_t)slot * a.n_max + j], a.P);
#pragma unroll
    for (int h = 0; h < NT; ++h) {
      const int t = j * NT + h;
      const bool more = t + 1 < T;
      if (more) {  // the next tile's partial S runs under this one's sum
        mbar_wait(kfull + (t + 1) % kStages, ((t + 1) / kStages) & 1);
        issue_s(nxt, t + 1);
      }
      if (tid == 0 && t + kStages < T) load_k(t + kStages);
      __syncwarp();
      gather_b(cur, t & 1);
#pragma unroll
      for (int i = 0; i < kSU; ++i) x[h * kSU + i] = __int2float_rn(cur[i]);
      wgmma_wait<0>();
      fence_regs(nxt);
      if (more) {  // the next tile's partial goes to the cluster
        put(nxt, (t + 1) & 1);
        cluster_arrive();
      }
      if (h == NT - 1) {
        if (valid < NT * U)
          page(std::true_type{}, j, valid);
        else
          page(std::false_type{}, j, valid);
      }
      __syncthreads();  // K stage t % 3 read; at a page's end its V^T stage
      if (h == NT - 1 && tid == 0 && j + 2 < n_pages) load_v(j + 2);
      __syncwarp();
      if (more) cluster_wait();  // every block's partial S of tile t + 1
    }
  }

  // out (this block's columns), and the lse from rank 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    const float l = l_run[h], inv = __frcp_rn(l > 0.f ? l : 1.f);
    float* out = static_cast<float*>(a.out) + ((size_t)z * a.Sq + row) * a.D +
                 c0 + 2 * q4;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(__fmul_rn(o[4 * j + 2 * h], inv),
                      __fmul_rn(o[4 * j + 2 * h + 1], inv));
    }
    if (rank == 0 && q4 == 0)
      a.lse[(size_t)z * a.Sq + row] = l > 0.f ? m_run[h] + logf(l) : kNegInf;
  }
  cluster_arrive();
  cluster_wait();
}

// ------------------------------------------------------------- k slices

// Heads past 2048 (kPaged): n = ceil(D / 256) slices of 256 columns, k =
// ceil(n / 8) of them a block, a cluster of C = ceil(n / k) blocks (at most
// 8); block j owns slices [jk, jk + k), the last one fewer, or a slice of 8
// columns. A block cannot hold o for two slices in registers, so the tile
// loop runs twice, as slices_attention below does:
//   - Pass 1, S and the softmax: for each tile of 32 tokens, the block's
//     partial S summed over its slices in one accumulator (m64n32k16, 16
//     k-steps a slice), the C partials added in rank order as above
//     (`gather`), then kPaged's online softmax. Each step (a tile's slice)
//     takes q's slice by TMA and the K tile's columns unpacked from rows
//     copied by cp.async a step earlier, in a ring of two stages of q [128]
//     [256] and K [32][256]: q does not fit resident past one slice, so it
//     streams from L2 once a step. What pass 2 needs to replay the online
//     recurrence is kept in global scratch (`replay`), per thread and tile:
//     the packed P.V A operand bf16(p * vs), and alpha and csum of its two
//     rows; the blocks of a cluster hold the same values, so each warp's are
//     written by block w % C.
//   - Pass 2, slice by slice: the V tile's columns of the slice (copied and
//     unpacked as K was, three stages), o = o * alpha - csum + P.V, and the
//     slice's columns written (or, where the chain is split, its partial o).
// The arithmetic and the rounding points are those of the one-pass kernel:
// bf16(p * vs) rounds against the running max of its tile.
struct SmemK {
  static constexpr int kQ = kBQ * kCols * 2;
  static constexpr int kTile = TK * kCols * 2;
  static constexpr int kStage = kQ + kTile;
  static constexpr int kX = kBQ * TK * 4;
  static constexpr int kXOff = 2 * kStage;
  static constexpr int kSideOff = kXOff + 2 * kX;
  static constexpr int kQsOff = kSideOff + 2 * 4 * TK * 4;
  static constexpr int kRawOff = kQsOff + kBQ * 4;
  static constexpr int kBarOff = kRawOff + 2 * kRaw;
  static constexpr int kBytes = 1024 + kBarOff + 2 * 8;
};

// uint4 words a thread keeps a tile for pass 2: P (two), alpha and csum
constexpr int kReplayWords = 3;

// S of the tile in buffer `at` (clusters of 5 to 8 blocks: k > 1; f32
// partials, or s32 ones in kScratch8)
template <typename T, int N>
__device__ __forceinline__ void gather_slices(T (&s)[N], uint32_t at, int C) {
  switch (C) {
    case 5: gather<5>(s, at); break;
    case 6: gather<6>(s, at); break;
    case 7: gather<7>(s, at); break;
    default: gather<8>(s, at); break;
  }
}

// The columns [c0, c0 + ncol) of this split's unnormalized o to part_o.
__device__ __forceinline__ void put_partial(const Args& a,
                                            const float (&o)[kCols / 2],
                                            int q0, int rows0, int z, int c0,
                                            int ncol, int q4) {
  const size_t plane = (size_t)a.Z * a.Sq * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    float* po = a.part_o + blockIdx.z * plane +
                ((size_t)z * a.Sq + row) * a.D + c0 + 2 * q4;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;
      *reinterpret_cast<float2*>(po + 8 * j) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
}

// merge_splits for a block of several slices: its partial o went out slice
// by slice (put_partial); here its (m, l), the count, and where it is the
// last of the splits, the merge of its columns [cb, cb + ncols).
__device__ __forceinline__ void merge_slices(const Args& a, const float (&m)[2],
                                             const float (&l)[2], int q0,
                                             int rows0, int z, int C, int rank,
                                             int cb, int ncols, int q4) {
  __shared__ int last;
  const int split = blockIdx.z;
  const size_t plane = (size_t)a.Z * a.Sq * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row < a.Sq && q4 == 0)
      a.part_ml[(((size_t)split * C + rank) * a.Z + z) * a.Sq + row] =
          make_float2(m[h], l[h]);
  }
  __threadfence();
  __syncthreads();
  int* count = a.counters + ((size_t)(blockIdx.x / C) * a.Z + z) * C + rank;
  if (threadIdx.x == 0) {
    last = atomicAdd(count, 1) == a.nsplit - 1;
    if (last) *count = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rows0 + 8 * h;
    if (row >= a.Sq) continue;
    float w[kMaxSplit], ls[kMaxSplit], M = -INFINITY, wl = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < a.nsplit) {
        const float2 ml = __ldcg(
            a.part_ml + (((size_t)s * C + rank) * a.Z + z) * a.Sq + row);
        w[s] = ml.x;
        ls[s] = ml.y;
        M = fmaxf(M, ml.x);
      }
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < a.nsplit) {
        w[s] = expf(w[s] - M);
        wl = __fmaf_rn(w[s], ls[s], wl);
      }
    const float inv = __fdiv_rn(1.f, wl);
    const size_t at = ((size_t)z * a.Sq + row) * a.D + cb + 2 * q4;
    for (int c = 0; c < ncols; c += 8) {
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s)
        if (s < a.nsplit) {
          const float2 v = __ldcg(
              reinterpret_cast<const float2*>(a.part_o + s * plane + at + c));
          y0 = __fmaf_rn(w[s], v.x, y0);
          y1 = __fmaf_rn(w[s], v.y, y1);
        }
      *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + c) =
          make_float2(__fmul_rn(y0, inv), __fmul_rn(y1, inv));
    }
    if (rank == 0 && q4 == 0) a.lse[(size_t)z * a.Sq + row] = M + logf(wl);
  }
}

// kPaged at heads past 2048, k slices a block (a.q: q itself, for its
// channel sums; `replay`: [clusters, tiles, kReplayWords, 256] uint4).
template <int BITS>
__global__ void __launch_bounds__(kThreads, 1)
    wide_cluster_paged_slices(const __grid_constant__ CUtensorMap tq,
                              const Args a, const int k, uint4* replay) {
  using L = SmemK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* X = reinterpret_cast<float*>(smem + L::kXOff);
  float* sides = reinterpret_cast<float*>(smem + L::kSideOff);
  float* qpart = reinterpret_cast<float*>(smem + L::kQsOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);

  const int C = a.C, rank = (int)cluster_rank();
  const int qt = blockIdx.x / C, q0 = qt * kBQ, z = blockIdx.y;
  const int cb = rank * k * kCols;  // the block's first column
  const int ns = min(k, (a.D + kCols - 1) / kCols - rank * k);  // its slices
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  const int tpp = (a.P + TK - 1) / TK, Tall = a.n_pages * tpp;
  const int tps = (Tall + a.nsplit - 1) / a.nsplit, t0 = blockIdx.z * tps;
  const int T = min(tps, Tall - t0);
  const int Pp = a.P / (8 / BITS);
  const int N = T * ns;  // pass 1's steps: step i is tile i / ns, slice i % ns
  const bool writes = (tid >> 5) % C == rank;  // its warp's replay rows
  uint4* rp = replay + ((size_t)(z * (gridDim.x / C) + qt) * Tall + t0) *
                           kReplayWords * kThreads + tid;

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    fence_barrier_init();
  }
  // the ring starts at zero: the columns of K and V past a slice of fewer
  // than 256, and the tokens past a page's data, which no unpack writes,
  // then hold finite values (zeros, or levels of another slice) that meet
  // q's zero columns or weights of 0
  for (int i = tid; i < 2 * L::kStage / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  auto col_of = [&](int s) { return cb + s * kCols; };
  auto ncol_of = [&](int s) { return min(kCols, a.D - col_of(s)); };
  auto stage = [&](int i) { return smem + (i & 1) * L::kStage; };
  auto raw = [&](int i) { return smem + L::kRawOff + (i & 1) * kRaw; };
  // q's slice of step i by TMA, all four chunks (zero past D)
  auto load_q = [&](int i) {
    mbar_expect_tx(full + (i & 1), L::kQ);
    for (int c = 0; c < kChunks; ++c)
      tma_load_3d(stage(i) + c * kBQ * kSw, &tq, full + (i & 1),
                  col_of(i % ns) + 64 * c, q0, z);
  };
  auto slot_of = [&](int t) { return a.page_table[(t0 + t) / tpp]; };
  auto pool_row = [&](int slot) {
    if (slot < 0 || slot >= a.n_slots) __trap();
    return (size_t)slot * a.Z + z;
  };
  // the packed rows of tile t's columns of slice s (K or V), and their
  // levels into a [32][256] tile, as wide_cluster_attention's raw_of and
  // unpack; a thread unpacks what it copied
  const bool cb16 = a.D % 16 == 0;
  auto has_cols = [&](int s) {
    return tid % (cb16 ? kCols / 16 : kCols / 8) < ncol_of(s) / (cb16 ? 16 : 8);
  };
  auto copy_rows = [&](uint8_t* dst, const uint8_t* data, int t, int s,
                       int slot) {
    if (!has_cols(s)) return;
    const uint8_t* base = data + pool_row(slot) * Pp * a.D + col_of(s);
    const int h0 = ((t0 + t) % tpp) * TK;
    if (cb16)
      copy_raw<16>(dst, base, a.D, Pp, h0, tid);
    else
      copy_raw<8>(dst, base, a.D, Pp, h0, tid);
  };
  auto unpack_rows = [&](const uint8_t* src, int t, int s, uint8_t* tile) {
    if (!has_cols(s)) return;
    const int h0 = ((t0 + t) % tpp) * TK;
    if (cb16)
      unpack_raw<BITS, 16>(src, Pp, h0, tile, tid);
    else
      unpack_raw<BITS, 8>(src, Pp, h0, tile, tid);
  };
  // the sidecars of tile t (token tid < 32), stored as ka', kb, vs, vz
  auto side_of = [&](int t) {
    float4 sd = make_float4(0.f, 0.f, 0.f, 0.f);
    const int tok = ((t0 + t) % tpp) * TK + tid;
    if (tid < TK && tok < a.P) {
      const size_t at = pool_row(slot_of(t)) * a.P + tok;
      sd = make_float4(a.k_scale[at], a.k_zp[at], a.v_scale[at], a.v_zp[at]);
    }
    return sd;
  };
  auto put_side = [&](float4 sd, int t) {
    float* d = sides + (t & 1) * 4 * TK;
    if (tid < TK) {
      const float ka = __fmul_rn(sd.x, a.sm);
      d[tid] = ka;
      d[TK + tid] = __fmul_rn(ka, sd.y);
      d[2 * TK + tid] = sd.z;
      d[3 * TK + tid] = sd.w;
    }
  };

  if (tid == 0) {
    load_q(0);
    if (N > 1) load_q(1);
  }
  __syncwarp();
  copy_rows(raw(0), a.k_data, 0, 0, slot_of(0));
  cp_async_wait_all();
  unpack_rows(raw(0), 0, 0, stage(0) + L::kQ);
  if (N > 1) copy_rows(raw(1), a.k_data, 1 / ns, 1 % ns, slot_of(1 / ns));
  cp_async_commit();
  put_side(side_of(0), 0);

  // q's channel sums: two threads a row, each over its half of every owned
  // slice, read from q itself; then the C partial sums in rank order
  float qs[2];
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float s = 0.f;
    if (row < a.Sq) {
      const __nv_bfloat16* qr = a.q + ((size_t)z * a.Sq + row) * a.D;
      for (int sl = 0; sl < ns; ++sl)
        for (int u = 0; u < 16; ++u) {
          const int c = col_of(sl) + 128 * half + 8 * u;
          if (c >= a.D) break;
          const uint4 w = *reinterpret_cast<const uint4*>(qr + c);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s += __bfloat162float(h2[e].x) + __bfloat162float(h2[e].y);
        }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's halves
    if (half == 0) qpart[r] = s;
    fence_proxy_async();  // the first K tile's levels, for the S products
    cluster_arrive();
    cluster_wait();  // also every thread's levels and sidecars of tile 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = smem_u32(qpart + rows0 + 8 * h);
      qs[h] = ld_cluster_f32(cluster_map(at, 0));
      for (int j = 1; j < C; ++j)
        qs[h] = __fadd_rn(qs[h], ld_cluster_f32(cluster_map(at, j)));
    }
  }

  // pass 1
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  float acc[kS], cur[kS];
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int slot_n = N > 2 ? slot_of(2 / ns) : 0;  // the slot of step i + 2
  int tokens = a.page_tokens[t0 / tpp];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    float4 sd_next = make_float4(0.f, 0.f, 0.f, 0.f);
    int tokens_next = 0;
    if (more) {  // read now, stored after this tile's softmax
      sd_next = side_of(t + 1);
      tokens_next = a.page_tokens[(t0 + t + 1) / tpp];
    }
#pragma unroll 1
    for (int s = 0; s < ns; ++s) {
      const int i = t * ns + s;
      mbar_wait(full + (i & 1), (i >> 1) & 1);
      const uint32_t q_addr = smem_u32(stage(i)) + wg * 64 * kSw;
      const uint32_t k_addr = smem_u32(stage(i) + L::kQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const int chunk = kk / 4, in = (kk % 4) * 32;
        wgmma_ss<TK>(acc,
                     gmma_desc(q_addr + chunk * kBQ * kSw + in, 16, 8 * kSw, 1),
                     gmma_desc(k_addr + chunk * TK * kSw + in, 16, 8 * kSw, 1),
                     s > 0 || kk > 0);
      }
      wgmma_commit();
      // under it: step i + 1's K from the rows copied a step ago (its stage
      // was last read by step i - 1's products, retired), then the rows of
      // step i + 2 into the buffer step i's were unpacked from
      cp_async_wait_all();
      if (i + 1 < N)
        unpack_rows(raw(i + 1), (i + 1) / ns, (i + 1) % ns,
                    stage(i + 1) + L::kQ);
      if (i + 2 < N) copy_rows(raw(i), a.k_data, (i + 2) / ns, (i + 2) % ns,
                               slot_n);
      cp_async_commit();
      if (i + 3 < N) slot_n = slot_of((i + 3) / ns);
      fence_proxy_async();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // stage i read by both warpgroups; step i + 1's K
      if (tid == 0 && i + 2 < N) load_q(i + 2);
      __syncwarp();
    }
    // the block's partial S of tile t to the cluster; S = the C partials in
    // rank order. Buffer t & 1 was last read (tile t - 2) before every
    // block arrived at tile t - 1's barrier.
    {
      float4* xb = reinterpret_cast<float4*>(X + (t & 1) * (L::kX / 4));
#pragma unroll
      for (int u = 0; u < kU; ++u)
        xb[u * kThreads + tid] = make_float4(acc[4 * u], acc[4 * u + 1],
                                             acc[4 * u + 2], acc[4 * u + 3]);
    }
    cluster_arrive();
    cluster_wait();
    gather_slices(cur, x_addr + (t & 1) * L::kX, C);

    // kPaged's online softmax (wide_cluster_attention's, tile for tile)
    const int h0 = ((t0 + t) % tpp) * TK;
    const int present = min(a.P - h0, TK);
    const int valid = min(max(min(tokens, a.P) - h0, 0), TK);
    const float* sd = sides + (t & 1) * 4 * TK;
    float alpha[2], msc[2], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
    if (valid < TK) {
      quant_flash::logits<true, TK>(cur, sd, qs, q4, valid, m_run, alpha, msc);
      quant_flash::weights<true, TK>(cur, sd, q4, valid, present, m_run, msc,
                                     rsum, csum);
    } else {
      quant_flash::logits<false, TK>(cur, sd, qs, q4, valid, m_run, alpha, msc);
      quant_flash::weights<false, TK>(cur, sd, q4, valid, present, m_run, msc,
                                      rsum, csum);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] = l_run[h] * alpha[h] + quant_flash::quad_sum(rsum[h]);
      csum[h] = quant_flash::quad_sum(csum[h]);
    }
    if (writes) {  // bf16(p * vs) as P.V's A operand, alpha and csum
      uint32_t pf[TK / 16][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        pf[j >> 1][(j & 1) * 2] = pack_bf16(cur[4 * j], cur[4 * j + 1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(cur[4 * j + 2], cur[4 * j + 3]);
      }
      uint4* r = rp + (size_t)t * kReplayWords * kThreads;
      r[0] = make_uint4(pf[0][0], pf[0][1], pf[0][2], pf[0][3]);
      r[kThreads] = make_uint4(pf[1][0], pf[1][1], pf[1][2], pf[1][3]);
      r[2 * kThreads] =
          make_uint4(__float_as_uint(alpha[0]), __float_as_uint(alpha[1]),
                     __float_as_uint(csum[0]), __float_as_uint(csum[1]));
    }
    if (more) {  // sides buffer (t + 1) & 1: tile t - 1's, read before the
                 // barriers of this tile's steps
      put_side(sd_next, t + 1);
      tokens = tokens_next;
    }
  }
  if (a.nsplit == 1 && rank == 0 && q4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rows0 + 8 * h;
      if (row < a.Sq)
        a.lse[(size_t)z * a.Sq + row] = m_run[h] + logf(l_run[h]);
    }
  }
  // every block's replay rows are written (the barrier orders them at
  // cluster scope), every product of pass 1 has retired, and no block reads
  // another's shared memory after it
  cluster_arrive();
  cluster_wait();

  // pass 2: step j is tile j % T of owned slice j / T; V tiles in three
  // stages over pass 1's ring
  const int M = ns * T;
  auto vtile = [&](int j) { return smem + (j % 3) * L::kTile; };
  copy_rows(raw(0), a.v_data, 0, 0, slot_of(0));
  cp_async_wait_all();
  unpack_rows(raw(0), 0, 0, vtile(0));
  if (M > 1) copy_rows(raw(1), a.v_data, 1 % T, 1 / T, slot_of(1 % T));
  cp_async_commit();
  fence_proxy_async();
  __syncthreads();
  slot_n = M > 2 ? slot_of(2 % T) : 0;
  uint4 nx[kReplayWords];  // tile t's words, read a step before they are used
  auto read_replay = [&](int t) {
#pragma unroll
    for (int w = 0; w < kReplayWords; ++w)
      nx[w] = __ldcg(rp + ((size_t)t * kReplayWords + w) * kThreads);
  };
  read_replay(0);
  const float inv[2] = {__frcp_rn(l_run[0]), __frcp_rn(l_run[1])};
  float o[kCols / 2];
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const int j = s * T + t;
      wgmma_wait<0>();  // P.V of step j - 1: o, and its A registers, ours
      fence_regs(o);
      const uint32_t pf[TK / 16][4] = {
          {operand(nx[0].x), operand(nx[0].y), operand(nx[0].z),
           operand(nx[0].w)},
          {operand(nx[1].x), operand(nx[1].y), operand(nx[1].z),
           operand(nx[1].w)}};
      const float alpha[2] = {__uint_as_float(nx[2].x),
                              __uint_as_float(nx[2].y)};
      const float csum[2] = {__uint_as_float(nx[2].z),
                             __uint_as_float(nx[2].w)};
      if (j + 1 < M) read_replay((t + 1) % T);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i)
        o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], -csum[(i >> 1) & 1]);
      const uint32_t v_addr = smem_u32(vtile(j));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<kCols, 1>(o, pf[kk],
                           gmma_desc(v_addr + kk * 16 * kSw, TK * kSw, 8 * kSw, 1),
                           1);
      wgmma_commit();
      // under it: step j + 1's V (its stage last read by step j - 2's
      // products, which both warpgroups retired before the last barrier),
      // then the rows of step j + 2
      cp_async_wait_all();
      if (j + 1 < M)
        unpack_rows(raw(j + 1), (j + 1) % T, (j + 1) / T, vtile(j + 1));
      if (j + 2 < M)
        copy_rows(raw(j), a.v_data, (j + 2) % T, (j + 2) / T, slot_n);
      cp_async_commit();
      if (j + 3 < M) slot_n = slot_of((j + 3) % T);
      fence_proxy_async();
      __syncthreads();  // every thread's levels of step j + 1
    }
    wgmma_wait<0>();
    fence_regs(o);
    const int c0 = col_of(s), ncol = ncol_of(s);
    if (a.nsplit > 1) {
      put_partial(a, o, q0, rows0, z, c0, ncol, q4);
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rows0 + 8 * h;
      if (row >= a.Sq) continue;
      float* out = static_cast<float*>(a.out) + ((size_t)z * a.Sq + row) * a.D +
                   c0 + 2 * q4;
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj) {
        if (8 * jj >= ncol) break;
        *reinterpret_cast<float2*>(out + 8 * jj) =
            make_float2(__fmul_rn(o[4 * jj + 2 * h], inv[h]),
                        __fmul_rn(o[4 * jj + 2 * h + 1], inv[h]));
      }
    }
  }
  if (a.nsplit > 1)
    merge_slices(a, m_run, l_run, q0, rows0, z, C, rank, cb,
                 min(ns * kCols, a.D - cb), q4);
}

// Dense attention and fused-QKV attention at heads past 2048, k slices a
// block (`slices_attention`): the two exact passes of csrc/fused_qkv_
// attention_wide.cu's cluster kernel over blocks of several slices. q, K
// and V come by TMA, all four chunks of a slice, zero past D, Sq and Skv:
// for dense attention from three bf16 [Z, S, D] tensors (3-D maps, grid y
// the head z), for fused-QKV attention (kQkv) from the [B, S, 3H, Hd]
// projection (one 4-D map, head index h, H + h, 2H + h; grid y the head h,
// grid z the batch row b).
//   - Pass 1: each step (a tile's slice) takes q's slice and the K tile's
//     into a ring of two stages of q [128][256] and K [32][256] (q does not
//     fit resident past one slice, so it streams from L2 once a step); the
//     block's partial S summed over its slices in one accumulator (16
//     k-steps a slice), the C partials in rank order (`gather_slices`).
//     Each row's running maximum of logit * log2(e) and sum of 2^(that -
//     maximum) are kept, and the summed S is written to an f32 scratch
//     `s_keep` [B * H, Sq, ld] by block w % C for warp w.
//   - Pass 2, after a cluster barrier (which orders those writes before the
//     reads), slice by slice: S read back a tile ahead, p = 2^(logit
//     log2(e) - max) rounded to bf16, times the slice's columns of the V
//     tile (three stages over pass 1's ring; o 128 registers a thread, no
//     rescale: max is final); the slice's columns written, o / sum, in bf16
//     or f32 as out_bf16 asks. For fused-QKV attention p is divided by the
//     sum before it is rounded (p = 2^(logit log2(e) - (max + log2 sum)))
//     and o is written as it is.
// Every key is seen twice, so each p rounds against the row's final
// maximum: the roundings of fused-QKV's TPU kernel, and of dense
// attention's in every tile where its running maximum is already the row's.
// The two callers are two instances (kQkv), so neither pays for the other's
// normalisation (a runtime choice cost fused-QKV attention 4.5% at 2056,
// PERF.md).
struct SliceArgs {
  void* out;  // bf16 where out_bf16, else f32
  // element (b, h, row, column) of out at b * ob + h * oh + row * orow +
  // column
  size_t ob, oh, orow;
  float* s_keep;  // [B * H, Sq, ld]: pass 1's S for pass 2
  int out_bf16, Sq, Skv, D, H, C, k;
  int ld;     // the scratch's row: Skv rounded up to 8 (keys in pairs)
  float sl2;  // sm_scale * log2(e)
};

// Shared memory: the ring of two stages of q [128][256] and K [32][256]
// (pass 2: three V stages), two buffers of partial S, the mbarriers (two
// q+K stages, three V stages).
struct SmemSlices {
  static constexpr int kQ = kBQ * kCols * 2;
  static constexpr int kTile = TK * kCols * 2;
  static constexpr int kStage = kQ + kTile;
  static constexpr int kX = kBQ * TK * 4;
  static constexpr int kXOff = 2 * kStage;
  static constexpr int kBarOff = kXOff + 2 * kX;
  static constexpr int kBytes = 1024 + kBarOff + (2 + kStages) * 8;
};

// The 64-column box of part `part` (0 q, 1 K, 2 V) at column col and row
// row of this block's head, into dst.
template <bool kQkv>
__device__ __forceinline__ void slice_box(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int part, int col,
                                          int row, int H) {
  if constexpr (kQkv)
    tma_load_4d(dst, map, bar, col, part * H + (int)blockIdx.y, row,
                (int)blockIdx.z);
  else
    tma_load_3d(dst, map, bar, col, row, (int)blockIdx.y);
}

template <bool kQkv>
__global__ void __launch_bounds__(kThreads, 1)
    slices_attention(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const SliceArgs a) {
  using L = SmemSlices;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* X = reinterpret_cast<float*>(smem + L::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* vfull = full + 2;

  const int C = a.C, k = a.k, rank = (int)cluster_rank();
  const int q0 = (blockIdx.x / C) * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int zh = b * a.H + h;
  const int cb = rank * k * kCols;  // the block's first column
  const int ns = min(k, (a.D + kCols - 1) / kCols - rank * k);  // its slices
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  const int T = (a.Skv + TK - 1) / TK;        // tiles of 32 keys
  const int N = T * ns;  // pass 1's steps: step i is tile i / ns, slice i % ns
  const bool writes = (tid >> 5) % C == rank;  // its warp's rows of S
  float* s_rows = a.s_keep + ((size_t)zh * a.Sq + q0 + rows0) * a.ld;

  if (tid == 0) {
    for (int s = 0; s < 2 + kStages; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto stage = [&](int i) { return smem + (i & 1) * L::kStage; };
  auto load_step = [&](int i) {
    const int col = cb + (i % ns) * kCols, t = i / ns;
    uint64_t* bar = full + (i & 1);
    mbar_expect_tx(bar, L::kStage);
    for (int c = 0; c < kChunks; ++c) {
      slice_box<kQkv>(stage(i) + c * kBQ * kSw, &tq, bar, 0, col + 64 * c,
                       q0, a.H);
      slice_box<kQkv>(stage(i) + L::kQ + c * TK * kSw, &tk, bar, 1,
                       col + 64 * c, t * TK, a.H);
    }
  };
  if (tid == 0) {
    load_step(0);
    if (N > 1) load_step(1);
  }
  __syncwarp();

  // pass 1
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[kS], cur[kS];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
#pragma unroll 1
    for (int s = 0; s < ns; ++s) {
      const int i = t * ns + s;
      mbar_wait(full + (i & 1), (i >> 1) & 1);
      const uint32_t q_addr = smem_u32(stage(i)) + wg * 64 * kSw;
      const uint32_t k_addr = smem_u32(stage(i) + L::kQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const int chunk = kk / 4, in = (kk % 4) * 32;
        wgmma_ss<TK>(acc,
                     gmma_desc(q_addr + chunk * kBQ * kSw + in, 16, 8 * kSw, 1),
                     gmma_desc(k_addr + chunk * TK * kSw + in, 16, 8 * kSw, 1),
                     s > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // stage i read by both warpgroups
      if (tid == 0 && i + 2 < N) load_step(i + 2);
      __syncwarp();
    }
    // the partial S to the cluster (buffer t & 1, last read at tile t - 2
    // before every block arrived at tile t - 1's barrier), then S in rank
    // order
    {
      float4* xb = reinterpret_cast<float4*>(X + (t & 1) * (L::kX / 4));
#pragma unroll
      for (int u = 0; u < kU; ++u)
        xb[u * kThreads + tid] = make_float4(acc[4 * u], acc[4 * u + 1],
                                             acc[4 * u + 2], acc[4 * u + 3]);
    }
    cluster_arrive();
    cluster_wait();
    gather_slices(cur, x_addr + (t & 1) * L::kX, C);
    const int kv0 = t * TK;
    if (writes) {  // keys in pairs: the row of ld = Skv rounded up to 8
                   // holds both of a pair whose first is < Skv
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int jj = 0; jj < TK / 8; ++jj) {
          const int key = kv0 + 8 * jj + 2 * q4;
          if (q0 + rows0 + 8 * hh < a.Sq && key < a.Skv)
            *reinterpret_cast<float2*>(s_rows + (size_t)8 * hh * a.ld + key) =
                make_float2(cur[4 * jj + 2 * hh], cur[4 * jj + 2 * hh + 1]);
        }
      }
    }
    if (kv0 + TK > a.Skv) {  // keys past Skv (the zero rows of the box)
#pragma unroll
      for (int e = 0; e < kS; ++e)
        if (kv0 + (e >> 2) * 8 + q4 * 2 + (e & 1) >= a.Skv) cur[e] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < kS; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], cur[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r] * a.sl2);
      l_run[r] *= quant_flash::ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int r = (e >> 1) & 1;
      l_run[r] += quant_flash::ex2(fmaf(cur[e], a.sl2, -m_run[r]));
    }
  }
  float bias[2], l[2];  // p = 2^(logit log2(e) - bias); out = o, or o / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = quant_flash::quad_max(m_run[r]);
    l[r] = quant_flash::quad_sum(l_run[r] * quant_flash::ex2(m_run[r] - m));
    bias[r] = kQkv ? m + log2f(l[r]) : m;
  }
  // every block's rows of S are written, every product of pass 1 has
  // retired (its ring is V's now), and no block reads another's shared
  // memory after it
  cluster_arrive();
  cluster_wait();

  // pass 2: step j is tile j % T of owned slice j / T
  const int M = ns * T;
  auto load_v = [&](int j) {
    const int st = j % kStages, col = cb + (j / T) * kCols;
    mbar_expect_tx(vfull + st, L::kTile);
    for (int c = 0; c < kChunks; ++c)
      slice_box<kQkv>(smem + st * L::kTile + c * TK * kSw, &tv, vfull + st,
                       2, col + 64 * c, (j % T) * TK, a.H);
  };
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < M; ++j) load_v(j);
  __syncwarp();
  auto load_s = [&](float(&s)[kS], int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int jj = 0; jj < TK / 8; ++jj) {
        const int key = t * TK + 8 * jj + 2 * q4;
        float2 v = make_float2(kNegInf, kNegInf);
        if (q0 + rows0 + 8 * hh < a.Sq && key < a.Skv)
          v = __ldcg(reinterpret_cast<const float2*>(
              s_rows + (size_t)8 * hh * a.ld + key));
        s[4 * jj + 2 * hh] = v.x;
        s[4 * jj + 2 * hh + 1] = v.y;
      }
    }
  };
  float o[kCols / 2];
  float lg[kS], lg_next[kS];
  load_s(lg_next, 0);
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const int j = s * T + t;
#pragma unroll
      for (int e = 0; e < kS; ++e) lg[e] = lg_next[e];
      if (j + 1 < M) load_s(lg_next, (t + 1) % T);
      wgmma_wait<0>();  // P.V of the step before
      fence_regs(o);
      uint32_t pf[TK / 16][4];
#pragma unroll
      for (int jj = 0; jj < TK / 8; ++jj) {
        pf[jj >> 1][(jj & 1) * 2] =
            pack_bf16(quant_flash::ex2(fmaf(lg[4 * jj], a.sl2, -bias[0])),
                      quant_flash::ex2(fmaf(lg[4 * jj + 1], a.sl2, -bias[0])));
        pf[jj >> 1][(jj & 1) * 2 + 1] =
            pack_bf16(quant_flash::ex2(fmaf(lg[4 * jj + 2], a.sl2, -bias[1])),
                      quant_flash::ex2(fmaf(lg[4 * jj + 3], a.sl2, -bias[1])));
      }
      mbar_wait(vfull + j % kStages, (j / kStages) & 1);
      const uint32_t v_addr = smem_u32(smem + (j % kStages) * L::kTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<kCols, 1>(
            o, pf[kk], gmma_desc(v_addr + kk * 16 * kSw, TK * kSw, 8 * kSw, 1),
            1);
      wgmma_commit();
      __syncthreads();  // both warpgroups' P.V of step j - 1: its V stage free
      if (tid == 0 && j + kStages - 1 < M) load_v(j + kStages - 1);
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_regs(o);
    const int c0 = cb + s * kCols, ncol = min(kCols, a.D - c0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + rows0 + 8 * hh;
      if (row >= a.Sq) continue;
      const size_t at = b * a.ob + h * a.oh + row * a.orow + c0 + 2 * q4;
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj) {
        if (8 * jj >= ncol) break;  // columns past D are not stored
        float y0 = o[4 * jj + 2 * hh], y1 = o[4 * jj + 2 * hh + 1];
        if constexpr (!kQkv) {
          y0 = __fdiv_rn(y0, l[hh]);
          y1 = __fdiv_rn(y1, l[hh]);
        }
        if (a.out_bf16)
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) +
                                       at + 8 * jj) = pack_bf16(y0, y1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + 8 * jj) =
              make_float2(y0, y1);
      }
    }
  }
}

// kScratch8 at heads past 2048, k slices a block: the two passes again.
// q's int8 tile of one slice is 32 KB, so k slices of it cannot stay
// resident beside the ring: q is quantized once, after the exchange of its
// row maxima, into a global int8 scratch `qi` [Z, Sq, DK] (each block its own
// columns, zero past D), and a slice of it streams by TMA with each K
// sub-tile (a `fence.proxy.async.global` and a cluster barrier stand
// between the stores and the loads). Requantizing each streamed bf16 slice
// of q instead would take a 64 KB stage and a division an element every step.
//   - Pass 1: each step (a sub-tile's slice) takes q's int8 slice and the K
//     sub-tile's [U][256] into a ring of two stages; the block's s32
//     partial S summed over its slices in one accumulator, the C partials
//     (exact in any order), a page's whole S held until its last sub-tile,
//     then the page's softmax and requantization as in
//     wide_cluster_attention_a8. Kept in `replay` per thread and page: wi
//     (PT / 32 words, the P.V A operand in `vt_columns` order), the rows'
//     alpha and sw, and their csum = sum(w * vz').
//   - Pass 2, slice by slice: page j's V^T rows of the slice [256][PT] by
//     TMA (three stages over the ring), its words staged by cp.async a page
//     ahead in the partial-S buffers (free after pass 1), then o = o * alpha
//     + (wi . V^T) * sw - csum as two m64n128k32 halves, each folded into o
//     before the next.
// An empty slot writes zeros and an lse of -1e30; a row whose every key so
// far is masked weighs each key 1 (wide_cluster_attention_a8's rule).
template <int PT, int U = a8_subtile(PT)>
struct SmemK8 {
  static constexpr int kQ = kBQ * kCols;
  static constexpr int kK = U * kCols;
  static constexpr int kStage = kQ + kK;
  static constexpr int kV = kCols * PT;
  static constexpr int kX = kBQ * U * 4;
  static constexpr int kSide = 4 * PT * 4;
  static constexpr int kXOff = 2 * kStage;
  static constexpr int kSideOff = kXOff + 2 * kX;
  static constexpr int kRowOff = kSideOff + 2 * kSide;
  static constexpr int kBarOff = kRowOff + 3 * kBQ * 4;
  static constexpr int kBytes = 1024 + kBarOff + (2 + kStages) * 8;
  // uint4 words a thread keeps a page: wi, (alpha, sw) and csum
  static constexpr int kWords = PT / 32 + 2;
  static_assert(kStages * kV <= 2 * kStage, "V^T stages over the ring");
  static_assert(2 * kWords * kThreads * 16 <= 2 * kX, "words over X");
};

template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
    wide_cluster_a8_slices(const __grid_constant__ CUtensorMap tqi,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a, const int k, int8_t* qi,
                           uint4* replay) {
  constexpr int U = a8_subtile(PT), NT = PT / U;
  using L = SmemK8<PT>;
  constexpr int kSU = U / 2, kUU = U / 8;  // logits a thread, int4 units
  constexpr int kVSw = swizzle_of(PT);
  constexpr int W = L::kWords, kSteps = PT / 32;  // P.V k-steps of 32 tokens
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* X = reinterpret_cast<int*>(smem + L::kXOff);
  float* sides = reinterpret_cast<float*>(smem + L::kSideOff);
  float* qamax = reinterpret_cast<float*>(smem + L::kRowOff);
  int* qisum = reinterpret_cast<int*>(qamax + kBQ);
  float* qsq = qamax + 2 * kBQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* vfull = full + 2;

  const int C = a.C, rank = (int)cluster_rank();
  const int qt = blockIdx.x / C, q0 = qt * kBQ, z = blockIdx.y;
  const int cb = rank * k * kCols;  // the block's first column
  const int ns = min(k, (a.D + kCols - 1) / kCols - rank * k);  // its slices
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  const int slot = z / a.H, n_pages = a.slot_pages[slot], T = n_pages * NT;
  auto col_of = [&](int s) { return cb + s * kCols; };
  auto ncol_of = [&](int s) { return min(kCols, a.D - col_of(s)); };
  if (T == 0) {
    for (int s = 0; s < ns; ++s)
      empty_rows(a, q0, rows0, z, rank, col_of(s), ncol_of(s), q4);
    return;
  }
  const int N = T * ns;  // pass 1's steps: step i is sub-tile i / ns, slice
                         // i % ns
  const bool writes = (tid >> 5) % C == rank;  // its warp's replay rows
  uint4* rp = replay + (size_t)(z * (gridDim.x / C) + qt) * a.n_max * W *
                           kThreads + tid;

  if (tid == 0) {
    for (int s = 0; s < 2 + kStages; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // q, two threads a row, 128 columns of each owned slice each: the row's
  // amax over the whole head (the C partial maxima, exact in any order), sq
  // = amax / 127 (1 where 0), qi = rint(q / sq) into the scratch (columns
  // past D 0; rows past Sq are not written and load as 0), and qsum =
  // sum(qi) * sq (the C partial sums, integers)
  float sq[2], qs[2];
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    const __nv_bfloat16* qr = a.q + ((size_t)z * a.Sq + row) * a.D;
    float amax = 0.f;
    if (row < a.Sq)
      for (int s = 0; s < ns; ++s)
        for (int u = 0; u < 16; ++u) {
          const int c = col_of(s) + 128 * half + 8 * u;
          if (c >= a.D) break;
          const uint4 w = *reinterpret_cast<const uint4*>(qr + c);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            amax = fmaxf(amax, fmaxf(fabsf(__bfloat162float(h2[e].x)),
                                     fabsf(__bfloat162float(h2[e].y))));
        }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    if (half == 0) qamax[r] = amax;
    cluster_arrive();
    cluster_wait();
    const uint32_t at = smem_u32(qamax + r);
    for (int j = 0; j < C; ++j)
      amax = fmaxf(amax, ld_cluster_f32(cluster_map(at, j)));
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    int isum = 0;
    if (row < a.Sq) {
      int8_t* qo = qi + ((size_t)z * a.Sq + row) * a.DK;
      for (int s = 0; s < ns; ++s)
        for (int u = 0; u < 8; ++u) {  // 16 columns
          const int c = col_of(s) + 128 * half + 16 * u;
          if (c >= a.DK) break;
          int v[16];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (c + 8 * e2 < a.D)
              w = *reinterpret_cast<const uint4*>(qr + c + 8 * e2);
            const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              v[8 * e2 + e] =
                  (int)rintf(__fdiv_rn(__bfloat162float(x8[e]), scale));
              isum += v[8 * e2 + e];
            }
          }
          *reinterpret_cast<uint4*>(qo + c) =
              make_uint4(paged_flash::pack_s8(v[0], v[1], v[2], v[3]),
                         paged_flash::pack_s8(v[4], v[5], v[6], v[7]),
                         paged_flash::pack_s8(v[8], v[9], v[10], v[11]),
                         paged_flash::pack_s8(v[12], v[13], v[14], v[15]));
        }
    }
    isum += __shfl_xor_sync(0xffffffffu, isum, 1);
    if (half == 0) {
      qisum[r] = isum;
      qsq[r] = scale;
    }
    fence_proxy_async_global();  // qi's stores, for pass 1's TMA loads
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at2 = smem_u32(qisum + rows0 + 8 * h);
      int total = 0;
      for (int j = 0; j < C; ++j)
        total += __float_as_int(ld_cluster_f32(cluster_map(at2, j)));
      sq[h] = qsq[rows0 + 8 * h];
      qs[h] = __fmul_rn((float)total, sq[h]);
    }
  }

  auto stage = [&](int i) { return smem + (i & 1) * L::kStage; };
  auto load_step = [&](int i) {
    const int col = col_of(i % ns), t = i / ns;
    uint64_t* bar = full + (i & 1);
    mbar_expect_tx(bar, L::kStage);
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(stage(i) + c * kBQ * 128, &tqi, bar, col + 128 * c, q0, z);
      tma_load_3d(stage(i) + L::kQ + c * U * 128, &tk, bar, col + 128 * c,
                  (t / NT) * PT + (t % NT) * U, z);
    }
  };
  if (tid == 0) {
    load_step(0);
    if (N > 1) load_step(1);
  }
  __syncwarp();

  // pass 1
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int acc[kSU], cur[kSU];
  // the page's S (sub-tile h at h * kSU; this thread's rows g and g + 8,
  // tokens 8n + 2 q4 + (e & 1) of entry 4n + e), then its logits, then w
  float x[NT * kSU];
#pragma unroll 1
  for (int j = 0; j < n_pages; ++j) {
    const int valid = min(a.page_tokens[(size_t)slot * a.n_max + j], a.P);
    // the page's sidecar rows (ka', kb', vs, vz'), read by its softmax after
    // the barriers of its sub-tiles; buffer j & 1 was last read by page
    // j - 2's, before every thread arrived at page j - 1's barriers
    float* sd = sides + (j & 1) * 4 * PT;
    if (tid < PT)
      reinterpret_cast<float4*>(sd)[tid] = __ldg(
          reinterpret_cast<const float4*>(
              a.side + ((size_t)z * a.n_max + j) * 4 * PT) + tid);
#pragma unroll
    for (int h = 0; h < NT; ++h) {
      const int t = j * NT + h;
#pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        const int i = t * ns + s;
        mbar_wait(full + (i & 1), (i >> 1) & 1);
        const uint32_t q_addr = smem_u32(stage(i)) + wg * 64 * 128;
        const uint32_t k_addr = smem_u32(stage(i) + L::kQ);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kCols / 32; ++kk) {
          const int chunk = kk / 4, in = (kk % 4) * 32;
          wgmma_s8_ss<U>(acc,
                         gmma_desc(q_addr + chunk * kBQ * 128 + in, 16, 1024, 1),
                         gmma_desc(k_addr + chunk * U * 128 + in, 16, 1024, 1),
                         s > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncthreads();  // stage i read by both warpgroups
        if (tid == 0 && i + 2 < N) load_step(i + 2);
        __syncwarp();
      }
      // the partial S to the cluster (buffer t & 1, as in slices_attention
      // above), S summed (exact)
      {
        int4* xb = reinterpret_cast<int4*>(X + (t & 1) * (L::kX / 4));
#pragma unroll
        for (int u = 0; u < kUU; ++u)
          xb[u * kThreads + tid] = make_int4(acc[4 * u], acc[4 * u + 1],
                                             acc[4 * u + 2], acc[4 * u + 3]);
      }
      cluster_arrive();
      cluster_wait();
      gather_slices(cur, x_addr + (t & 1) * L::kX, C);
#pragma unroll
      for (int e = 0; e < kSU; ++e) x[h * kSU + e] = __int2float_rn(cur[e]);
    }

    // the page's softmax as in wide_cluster_attention_a8: the logits (raw
    // = S * sq; raw * ka' - kb' * qsum; -1e30 past the valid tokens), w = p
    // * vs (0 past the valid tokens) with sum w * vz' and the page maximum,
    // sw = max w / 127 (1 where 0), wi = rint(w / sw)
    const bool mask = valid < PT;
    float mx[2] = {m_run[0], m_run[1]}, alpha[2], msc[2];
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float2 ka = *reinterpret_cast<const float2*>(sd + col);
      const float2 kb = *reinterpret_cast<const float2*>(sd + PT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float raw = __fmul_rn(x[4 * n + e], sq[r]);
        float y = __fsub_rn(__fmul_rn(raw, (e & 1) ? ka.y : ka.x),
                            __fmul_rn((e & 1) ? kb.y : kb.x, qs[r]));
        if (mask && col + (e & 1) >= valid) y = kNegInf;
        x[4 * n + e] = y;
        mx[r] = fmaxf(mx[r], y);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quant_flash::quad_max(mx[r]);
      alpha[r] = quant_flash::ex2((m_run[r] - mx[r]) * kLog2e);
      msc[r] = mx[r] * kLog2e;
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f}, wmax[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float2 vs = *reinterpret_cast<const float2*>(sd + 2 * PT + col);
      const float2 vz = *reinterpret_cast<const float2*>(sd + 3 * PT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, tok = col + (e & 1);
        float p = quant_flash::ex2(__fmaf_rn(x[4 * n + e], kLog2e, -msc[r]));
        float w = __fmul_rn(p, (e & 1) ? vs.y : vs.x);
        if (mask && tok >= valid) {
          p = m_run[r] == kNegInf && tok < a.P ? 1.f : 0.f;
          w = 0.f;
        }
        rsum[r] += p;
        csum[r] = __fmaf_rn(w, (e & 1) ? vz.y : vz.x, csum[r]);
        wmax[r] = fmaxf(wmax[r], w);
        x[4 * n + e] = w;
      }
    }
    float sw[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quant_flash::quad_sum(rsum[r]);
      wmax[r] = quant_flash::quad_max(wmax[r]);
      sw[r] = wmax[r] > 0.f ? __fdiv_rn(wmax[r], 127.f) : 1.f;
      rs[r] = __frcp_rn(sw[r]);
      csum[r] = quant_flash::quad_sum(csum[r]);
    }
    if (writes) {
      // wi, 0..127: step kk of 32 tokens, register 0 row g's tokens of
      // n-blocks 4kk and 4kk + 1, register 2 those of 4kk + 2 and 4kk + 3,
      // registers 1 and 3 row g + 8's (the `vt_columns` order of V^T)
      uint4* wr = rp + (size_t)j * W * kThreads;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t pf[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n0 = 4 * kk + 2 * hf;
            int wi[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wi[e] = paged_flash::rint_bits(paged_flash::div_by(
                  x[4 * (n0 + (e >> 1)) + 2 * r + (e & 1)], sw[r], rs[r]));
            pf[hf * 2 + r] = paged_flash::pack_s8(wi[0], wi[1], wi[2], wi[3]);
          }
        wr[kk * kThreads] = make_uint4(pf[0], pf[1], pf[2], pf[3]);
      }
      wr[kSteps * kThreads] =
          make_uint4(__float_as_uint(alpha[0]), __float_as_uint(alpha[1]),
                     __float_as_uint(sw[0]), __float_as_uint(sw[1]));
      wr[(kSteps + 1) * kThreads] = make_uint4(
          __float_as_uint(csum[0]), __float_as_uint(csum[1]), 0u, 0u);
    }
  }
  if (rank == 0 && q4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rows0 + 8 * h;
      if (row < a.Sq)
        a.lse[(size_t)z * a.Sq + row] =
            l_run[h] > 0.f ? m_run[h] + logf(l_run[h]) : kNegInf;
    }
  }
  // every block's replay rows are written (the barrier orders them at
  // cluster scope), every product of pass 1 has retired (its ring is V^T's
  // now), and no block reads another's shared memory after it
  cluster_arrive();
  cluster_wait();

  // pass 2: step jj is page jj % n_pages of owned slice jj / n_pages
  const int M = ns * n_pages;
  auto vstage = [&](int jj) { return smem + (jj % kStages) * L::kV; };
  auto load_v = [&](int jj) {
    const int st = jj % kStages;
    mbar_expect_tx(vfull + st, L::kV);
    tma_load_4d(vstage(jj), &tv, vfull + st, 0, col_of(jj / n_pages),
                jj % n_pages, z);
  };
  if (tid == 0)
    for (int jj = 0; jj < kStages - 1 && jj < M; ++jj) load_v(jj);
  __syncwarp();
  // page j's words, staged by cp.async into buffer b of the partial-S
  // buffers; each thread copies and reads back its own
  uint4* words = reinterpret_cast<uint4*>(smem + L::kXOff);
  auto fetch_words = [&](int j, int b) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      cp_async16(words + (b * W + w) * kThreads + tid,
                 rp + ((size_t)j * W + w) * kThreads, 16);
    cp_async_commit();
  };
  fetch_words(0, 0);
  const float inv[2] = {__frcp_rn(l_run[0] > 0.f ? l_run[0] : 1.f),
                        __frcp_rn(l_run[1] > 0.f ? l_run[1] : 1.f)};
  float o[kCols / 2];
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
#pragma unroll 1
    for (int j = 0; j < n_pages; ++j) {
      const int jj = s * n_pages + j, b = jj & 1;
      cp_async_wait_all();  // page j's words
      const uint4* wd = words + b * W * kThreads + tid;
      uint32_t pf[kSteps][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint4 v = wd[kk * kThreads];
        pf[kk][0] = v.x;
        pf[kk][1] = v.y;
        pf[kk][2] = v.z;
        pf[kk][3] = v.w;
      }
      const uint4 st = wd[kSteps * kThreads], cs = wd[(kSteps + 1) * kThreads];
      const float alpha[2] = {__uint_as_float(st.x), __uint_as_float(st.y)};
      const float sw[2] = {__uint_as_float(st.z), __uint_as_float(st.w)};
      const float csum[2] = {__uint_as_float(cs.x), __uint_as_float(cs.y)};
      if (jj + 1 < M) fetch_words((j + 1) % n_pages, b ^ 1);
      mbar_wait(vfull + jj % kStages, (jj / kStages) & 1);
      const uint32_t v_addr = smem_u32(vstage(jj));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int pv[kCols / 4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_s8<kCols / 2>(
              pv, pf[kk],
              gmma_desc(v_addr + half * (kCols / 2) * PT + kk * 32, 16,
                        8 * kVSw, layout_of(kVSw)),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < kCols / 4; ++i) {
          const int r = (i >> 1) & 1;
          float& y = o[half * (kCols / 4) + i];
          y = __fsub_rn(__fmaf_rn(paged_flash::i2f(pv[i]), sw[r],
                                  __fmul_rn(y, alpha[r])),
                        csum[r]);
        }
      }
      __syncthreads();  // both warpgroups read V^T stage jj % 3 (and their
                        // words of page j)
      if (tid == 0 && jj + kStages - 1 < M) load_v(jj + kStages - 1);
      __syncwarp();
    }
    const int c0 = col_of(s), ncol = ncol_of(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rows0 + 8 * h;
      if (row >= a.Sq) continue;
      float* out = static_cast<float*>(a.out) +
                   ((size_t)z * a.Sq + row) * a.D + c0 + 2 * q4;
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj) {
        if (8 * jj >= ncol) break;
        *reinterpret_cast<float2*>(out + 8 * jj) =
            make_float2(__fmul_rn(o[4 * jj + 2 * h], inv[h]),
                        __fmul_rn(o[4 * jj + 2 * h + 1], inv[h]));
      }
    }
  }
}

// ------------------------------------------------------------- launches

// The number of clusters of C blocks of `kernel` (one block an SM, `smem`
// bytes of shared memory, already allowed) the card runs at once, or a
// negative cudaError_t.
template <class... Ps>
int occupancy(void (*kernel)(Ps...), int smem, int C) {
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 16, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Whether the card places clusters of C blocks of an instance (`placed`,
// the instance's own, asks `active` once a size): 0, or the error.
template <class F>
int check_placed(int (&placed)[kMaxCluster + 1], int C, F active) {
  if (placed[C] == 0) {
    const int n = active(C);
    if (n < 0) return -n;
    placed[C] = n > 0 ? n : -1;
  }
  return placed[C] < 0 ? (int)cudaErrorInvalidClusterSize : 0;
}

// `kernel` over a grid of clusters of C blocks (along x) on `stream`.
template <class... Ps, class... As>
int cluster_launch(void (*kernel)(Ps...), int smem, dim3 grid, int C,
                   cudaStream_t stream, const As&... args) {
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The number of clusters of C blocks of an instance (one block an SM) the
// card runs at once, or a negative cudaError_t.
template <int MODE, int BITS, int CT>
int active_clusters_ct(int C) {
  auto kernel = wide_cluster_attention<MODE, BITS, CT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return occupancy(kernel, Smem::kBytes, C);
}

template <int MODE, int BITS>
int active_clusters(int C) {
  return C == 2   ? active_clusters_ct<MODE, BITS, 2>(C)
         : C == 3 ? active_clusters_ct<MODE, BITS, 3>(C)
                  : active_clusters_ct<MODE, BITS, 0>(C);
}

// Launch over Z heads: a cluster of a.C blocks a tile of 128 query rows.
// Returns cudaErrorInvalidClusterSize where the card cannot place the
// cluster; nothing falls back.
template <int MODE, int BITS, int CT>
int launch_ct(const CUtensorMap (&maps)[3], const Args& a, cudaStream_t stream) {
  static int placed[kMaxCluster + 1] = {};  // active clusters by C, 0: not asked
  if (const int err = check_placed(placed, a.C,
                                   active_clusters_ct<MODE, BITS, CT>))
    return err;
  return cluster_launch(wide_cluster_attention<MODE, BITS, CT>, Smem::kBytes,
                        dim3(a.C * ((a.Sq + kBQ - 1) / kBQ), a.Z, a.nsplit),
                        a.C, stream, maps[0], maps[1], maps[2], a);
}

template <int MODE, int BITS>
int launch(const CUtensorMap (&maps)[3], const Args& a, cudaStream_t stream) {
  if (a.C < 2 || a.C > kMaxCluster) return (int)cudaErrorInvalidValue;
  return a.C == 2   ? launch_ct<MODE, BITS, 2>(maps, a, stream)
         : a.C == 3 ? launch_ct<MODE, BITS, 3>(maps, a, stream)
                    : launch_ct<MODE, BITS, 0>(maps, a, stream);
}

// kScratch8's instances: one a page tile PT of 32, 64 or 128 tokens.
template <int PT>
int active_clusters_a8(int C) {
  auto kernel = wide_cluster_attention_a8<PT>;
  constexpr int kBytes = Smem8<PT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return occupancy(kernel, kBytes, C);
}

// kScratch8 at clusters of a.C blocks (`active`: only the clusters at once)
template <int PT>
int launch_a8_pt(const CUtensorMap (&maps)[2], const Args& a,
                 cudaStream_t stream, bool active) {
  if (active) return active_clusters_a8<PT>(a.C);
  static int placed[kMaxCluster + 1] = {};
  if (const int err = check_placed(placed, a.C, active_clusters_a8<PT>))
    return err;
  return cluster_launch(wide_cluster_attention_a8<PT>, Smem8<PT>::kBytes,
                        dim3(a.C * ((a.Sq + kBQ - 1) / kBQ), a.Z), a.C,
                        stream, maps[0], maps[1], a);
}

// kPaged at heads past 2048 (wide_cluster_paged_slices): the clusters of
// C blocks the card runs at once, or a negative cudaError_t; and the launch
// over clusters of a.C blocks of k slices each.
template <int BITS>
int active_slices(int C) {
  auto kernel = wide_cluster_paged_slices<BITS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SmemK::kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return occupancy(kernel, SmemK::kBytes, C);
}

template <int BITS>
int launch_slices(const CUtensorMap& tq, const Args& a, int k, uint4* replay,
                  cudaStream_t stream) {
  static int placed[kMaxCluster + 1] = {};
  if (const int err = check_placed(placed, a.C, active_slices<BITS>))
    return err;
  return cluster_launch(wide_cluster_paged_slices<BITS>, SmemK::kBytes,
                        dim3(a.C * ((a.Sq + kBQ - 1) / kBQ), a.Z, a.nsplit),
                        a.C, stream, tq, a, k, replay);
}

// Dense and fused-QKV attention past 2048 (slices_attention), as above:
// the grid is (a.C x query tiles, a.H, B).
template <bool kQkv>
int active_slices_attention(int C) {
  auto kernel = slices_attention<kQkv>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SmemSlices::kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return occupancy(kernel, SmemSlices::kBytes, C);
}

template <bool kQkv>
int launch_slices_attention(const CUtensorMap (&maps)[3], const SliceArgs& a,
                            int B, cudaStream_t stream) {
  static int placed[kMaxCluster + 1] = {};
  if (const int err =
          check_placed(placed, a.C, active_slices_attention<kQkv>))
    return err;
  return cluster_launch(slices_attention<kQkv>, SmemSlices::kBytes,
                        dim3(a.C * ((a.Sq + kBQ - 1) / kBQ), a.H, B), a.C,
                        stream, maps[0], maps[1], maps[2], a);
}

// kScratch8 at heads past 2048 (wide_cluster_a8_slices), one instance a page
// tile PT, as above.
template <int PT>
int active_a8_slices(int C) {
  auto kernel = wide_cluster_a8_slices<PT>;
  constexpr int kBytes = SmemK8<PT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return occupancy(kernel, kBytes, C);
}

template <int PT>
int launch_a8_slices(const CUtensorMap (&maps)[3], const Args& a, int k,
                     int8_t* qi, uint4* replay, cudaStream_t stream) {
  static int placed[kMaxCluster + 1] = {};
  if (const int err = check_placed(placed, a.C, active_a8_slices<PT>))
    return err;
  return cluster_launch(wide_cluster_a8_slices<PT>, SmemK8<PT>::kBytes,
                        dim3(a.C * ((a.Sq + kBQ - 1) / kBQ), a.Z), a.C, stream,
                        maps[0], maps[1], maps[2], a, k, qi, replay);
}

// A TMA map over a bf16 [Z, rows, D] tensor, boxes of 64 columns x `box`
// rows, 128-byte swizzle (zero fill past D and past rows).
inline bool bf16_map(CUtensorMap* map, const void* ptr, int Z, int rows, int D,
                     int box) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, (uint64_t)Z};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)rows * D * 2};
  const uint32_t boxes[3] = {64, (uint32_t)box, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides,
                  boxes, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The splits of a chain of `tiles` tiles of 32 tokens over which each of
// `clusters` clusters runs (`active` of their size run at once): enough to
// fill the card, at least 4 tiles a split, at most kMaxSplit, and no split
// empty (dlm_paged_attention_cluster_splits and
// dlm_quant_attention_cluster_splits ask it for the wrappers).
inline int chain_splits(int active, int clusters, int tiles) {
  int n = active > 0 ? active / clusters : 1;
  n = max(1, min(min(n, tiles / 4), kMaxSplit));
  const int per = (tiles + n - 1) / n;
  return (tiles + per - 1) / per;
}

// Whether nsplit is what chain_splits can give for `tiles` (no split
// empty).
inline bool splits_fit(int nsplit, int tiles) {
  if (nsplit < 1 || nsplit > kMaxSplit) return false;
  const int per = (tiles + nsplit - 1) / nsplit;
  return (tiles + per - 1) / per == nsplit;
}

// The blocks of a cluster for heads of D, or 0 outside [kMinD, kMaxD].
inline int cluster_blocks(int D) {
  return D >= kMinD && D <= kMaxD && D % 8 == 0 ? (D + kCols - 1) / kCols : 0;
}

// The cluster for heads of any multiple of 8 past 256: n = ceil(D / 256)
// slices of 256 columns, *k = ceil(n / 8) of them a block, and C = ceil(n /
// k) blocks (returned; cluster_blocks(D) with k = 1 up to 2048); 0 (and *k
// = 0) elsewhere. ops/attention.py: cluster_plan is the same.
inline int cluster_plan(int D, int* k) {
  *k = 0;
  if (D < kMinD || D % 8) return 0;
  const int n = (D + kCols - 1) / kCols;
  *k = (n + kMaxCluster - 1) / kMaxCluster;
  return (n + *k - 1) / *k;
}

}  // namespace wide_cluster
