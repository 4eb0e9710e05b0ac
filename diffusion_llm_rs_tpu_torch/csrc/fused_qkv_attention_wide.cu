// Fused-QKV bidirectional attention at head widths past 256, for Hopper
// (sm_90a): the two exact passes of csrc/fused_qkv_attention.cu over the
// thread-block cluster of csrc/wide_cluster_flash.cuh.
//
// With csrc/fused_qkv_attention.cu (heads of up to 256) it replaces the TPU
// kernel `_qkv_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_attention.py:293, behind
// `fused_qkv_attention`, :318), which takes every head width Hd % 8 == 0
// whose whole row fits its 8 MiB. Per (batch row, head):
//   logits = (q . k) * sm_scale, f32 over all S keys
//   p = exp(logits - max) / sum, normalised BEFORE it is rounded to bf16
//   out = bf16(p) . v, f32 sums
// so this is not an online softmax (whose bf16(p) rounds against running
// maxima): every key is seen twice.
//
// Design (heads of 264 to 2048, `qkv_cluster_kernel`; past 2048 blocks of
// several 256-column slices, csrc/wide_cluster_flash.cuh: slices_attention,
// the same two passes, which dense attention runs there too). A cluster of C =
// ceil(Hd / 256) blocks owns 128 query rows of one (batch row, head); block
// j owns head columns [256j, 256j + 256) (the last block of heads of 264
// owns 8). Each block reads its slices of q, K and V
// straight from the [B, S, 3D] projection through a 4-D TMA map
// ([B][S][3H][Hd], head index h, H + h, 2H + h; 64-column boxes, 128-byte
// swizzle, zero fill past Hd and past S).
//   - Pass 1, S: block j runs its partial S_j = q[:, j] . K[:, j]^T on
//     wgmma (m64n32k16 a warpgroup, 16 k-steps) for each tile of 32 keys,
//     stores it to shared memory, and after a cluster barrier adds the C
//     partials through distributed shared memory in rank order 0 .. C-1
//     (wide_cluster_flash.cuh: fetch, fold, gather), so every block holds
//     the same S bit for bit. The pipeline is wide_cluster_flash.cuh's: S
//     of the next tile is issued before this tile's partials are added and
//     runs under them, the partials are double-buffered, one cluster barrier
//     a tile, and with clusters of 2 and 3 the next tile's partials are
//     loaded a tile early; K streams three tiles ahead by TMA. Each row's
//     exact maximum and its sum of exp(logit - max) are kept running (log2
//     units), and every block writes the rows of its share of the warps (w
//     % C == j) of the summed S to an f32 scratch [B * H, S, S].
//   - Pass 2, after a cluster barrier (which orders those writes before
//     the reads): each block reads its 128 rows of S back a tile ahead
//     (L2; 2.1-4.2 MB a call at S = 256, 48 MB at B = 8, 2 heads, S = 864),
//     forms p = 2^(logit log2(e) - (max log2(e) + log2(sum))), rounds it
//     to bf16 and multiplies it by its own 256 columns of the V tile
//     (m64n256k16, o 128 registers a thread, no rescale: p is final). No S
//     product and no cluster exchange: computing S again ran 1.3-1.5x
//     slower (PERF.md), and splitting the keys over clusters (two
//     launches, the splits' o merged through f32 scratch) slower still.
//   - Two warpgroups of 64 query rows (256 threads, ptxas may give each 255
//     registers; it allocates registers four warps at a time, so no
//     producer warp), one block an SM.
// ptxas serializes no wgmma here (no C7514 or C7515 in the -Xptxas -v log):
// one wait<0> before every accumulator read, no S product in flight across
// a loop's back edge, and no P.V in the S pipeline's loop.
//
// What bounds it on an H100: at B = 8, S = 256, D = 768 (2 heads of 384 or
// one of 768) the function reads the 9.4 MB projection and writes the 3.1
// MB output, 0.0038 ms of bytes; at S = 864 its 4 B H S^2 Hd operations
// (9.2 GFLOP) bound it at 0.0185 ms. This design issues the S product once
// and P.V once over D in whole blocks of 256 columns, 4 B H S^2 256 C
// operations (512 and 768 columns at heads of 384 and 768), moves 16 KB of
// partial S a block a tile through distributed shared memory for each other
// block of its cluster, and writes and reads back S in f32 (PERF.md gives
// the times).

#include "wide_cluster_flash.cuh"

namespace qkv_cluster {

using namespace hopper;
using wide_cluster::kBQ;
using wide_cluster::kChunks;
using wide_cluster::kCols;
using wide_cluster::kLog2e;
using wide_cluster::kMaxCluster;
using wide_cluster::kNegInf;
using wide_cluster::kS;
using wide_cluster::kSw;
using wide_cluster::kThreads;
using wide_cluster::kU;
using wide_cluster::TK;

constexpr int kStages = 3;  // K and V tiles in flight

// Shared memory of a block: q [128][256], three stages each of K and V
// [32][256] (bf16, 4 chunks of [rows][128 B] swizzled), two buffers of
// partial S (f32, 128 x 32), and the mbarriers (q; K and V full a stage).
struct Layout {
  static constexpr int kQ = kBQ * kCols * 2;
  static constexpr int kTile = TK * kCols * 2;
  static constexpr int kX = kBQ * TK * 4;
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kXOff = kVOff + kStages * kTile;
  static constexpr int kBarOff = kXOff + 2 * kX;
  static constexpr int kBytes = 1024 + kBarOff + (1 + 2 * kStages) * 8;
};

struct Args {
  void* out;  // [B, S, H * Hd]: bf16 where out_bf16, else f32
  int out_bf16, S, H, Hd, C;
  float sl2;      // sm_scale * log2(e)
  float* s_keep;  // [B * H, S, S]: pass 1's S for pass 2
};

// CT: the cluster size for clusters of 2 and 3 blocks, whose partial S is
// fetched a tile early; 0 for any size (4 to 8), fetched when needed.
template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tkv, const Args a) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::kKOff;
  uint8_t* Vs = smem + L::kVOff;
  float* X = reinterpret_cast<float*>(smem + L::kXOff);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* kfull = q_full + 1;
  uint64_t* vfull = kfull + kStages;

  const int C = a.C, rank = (int)cluster_rank();
  const int q0 = (blockIdx.x / C) * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int zh = b * a.H + h;
  const int c0 = rank * kCols, ncol = min(kCols, a.Hd - c0);
  const int nch = (ncol + 63) / 64;  // chunks of this block's slice loaded
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) >> 5;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int rows0 = wg * 64 + warp * 16 + g;  // and rows0 + 8, in the tile
  const int T = (a.S + TK - 1) / TK;          // tiles of 32 keys
  // the rows of S this block writes: those of its share of the warps
  const bool writes = (tid >> 5) % C == rank;
  float* s_rows = a.s_keep + ((size_t)zh * a.S + q0 + rows0) * a.S;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
    }
    fence_barrier_init();
  }
  // zeros where no load writes: the chunks of q, K and V past Hd
  if (nch < kChunks) {
    uint4* qz = reinterpret_cast<uint4*>(Qs + nch * kBQ * kSw);
    for (int i = tid; i < (kChunks - nch) * kBQ * kSw / 16; i += kThreads)
      qz[i] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < 2 * kStages; ++s) {  // K stages, then V stages
      uint4* p = reinterpret_cast<uint4*>(Ks + s * L::kTile + nch * TK * kSw);
      for (int i = tid; i < (kChunks - nch) * TK * kSw / 16; i += kThreads)
        p[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // the K or V tile t of this block's columns (head index `at`) into stage
  // t % 3 of `ring`
  auto load_tile = [&](uint8_t* ring, uint64_t* bars, int at, int t) {
    const int s = t % kStages;
    mbar_expect_tx(bars + s, nch * TK * kSw);
    for (int c = 0; c < nch; ++c)
      tma_load_4d(ring + s * L::kTile + c * TK * kSw, &tkv, bars + s,
                  c0 + 64 * c, at, t * TK, b);
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, nch * kBQ * kSw);
    for (int c = 0; c < nch; ++c)
      tma_load_4d(Qs + c * kBQ * kSw, &tq, q_full, c0 + 64 * c, h, q0, b);
    for (int t = 0; t < kStages && t < T; ++t)
      load_tile(Ks, kfull, a.H + h, t);
    for (int t = 0; t < kStages - 1 && t < T; ++t)
      load_tile(Vs, vfull, 2 * a.H + h, t);
  }
  __syncwarp();

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
  // this block's partial S into buffer bb, a thread's logits as kU float4
  // units (unit k of thread i at k * 256 + i: a warp's accesses hit
  // distinct banks)
  const uint32_t x_addr = smem_u32(X) + tid * 16;
  auto put = [&](const float(&s)[kS], int bb) {
    float4* xb = reinterpret_cast<float4*>(X + bb * (L::kX / 4));
#pragma unroll
    for (int k = 0; k < kU; ++k)
      xb[k * kThreads + tid] =
          make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  };
  // S of the tile in buffer bb: the C partials, added in rank order; with
  // CT, loaded by prefetch(bb) a tile early
  float4 vpre[kU][CT > 0 ? CT : 1];
  auto prefetch = [&](int bb) {
    if constexpr (CT > 0) {
      uint32_t x[CT];
      wide_cluster::map_ranks<CT>(x, x_addr + bb * L::kX);
      wide_cluster::fetch<CT, kU>(vpre, x, 0);
    }
  };
  auto gather_b = [&](float(&s)[kS], int bb) {
    if constexpr (CT > 0) {
      wide_cluster::fold<CT, kU>(s, vpre, 0);
    } else {
      const uint32_t at = x_addr + bb * L::kX;
      switch (C) {
        case 4: wide_cluster::gather<4>(s, at); break;
        case 5: wide_cluster::gather<5>(s, at); break;
        case 6: wide_cluster::gather<6>(s, at); break;
        case 7: wide_cluster::gather<7>(s, at); break;
        default: wide_cluster::gather<8>(s, at); break;
      }
    }
  };

  // pass 1. This thread holds rows g and g + 8 of its warp's 16, keys 8j +
  // 2 q4 + (e & 1) of entry 4j + e: the running maximum of logit * log2(e)
  // and sum of 2^(that - maximum) of each
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float cur[kS], nxt[kS];
  mbar_wait(q_full, 0);
  mbar_wait(kfull, 0);
  issue_s(nxt, 0);
  wgmma_wait<0>();
  fence_regs(nxt);
  put(nxt, 0);
  cluster_arrive();
  cluster_wait();  // every block's partial S of tile 0
  prefetch(0);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    const int bb = t & 1;
    if (more) {  // S of the next tile runs under this one's exchange
      mbar_wait(kfull + (t + 1) % kStages, ((t + 1) / kStages) & 1);
      issue_s(nxt, t + 1);
    }
    if (tid == 0 && t + kStages < T) load_tile(Ks, kfull, a.H + h, t + kStages);
    __syncwarp();
    gather_b(cur, bb);
    const int kv0 = t * TK;
    if (writes) {  // keys in pairs: S % 8 == 0, so both or neither < S
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int jj = 0; jj < TK / 8; ++jj) {
          const int key = kv0 + 8 * jj + 2 * q4;
          if (q0 + rows0 + 8 * hh < a.S && key < a.S)
            *reinterpret_cast<float2*>(s_rows + (size_t)8 * hh * a.S + key) =
                make_float2(cur[4 * jj + 2 * hh], cur[4 * jj + 2 * hh + 1]);
        }
      }
    }
    if (kv0 + TK > a.S) {  // keys past S (the zero rows of the box)
#pragma unroll
      for (int e = 0; e < kS; ++e)
        if (kv0 + (e >> 2) * 8 + q4 * 2 + (e & 1) >= a.S) cur[e] = kNegInf;
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
    wgmma_wait<0>();  // S of the next tile
    fence_regs(nxt);
    if (more) {
      put(nxt, bb ^ 1);
      cluster_arrive();
    }
    __syncthreads();  // both warpgroups' S of the next tile: a K stage free
    if (more) {
      cluster_wait();  // every block's partial S of tile t + 1
      prefetch(bb ^ 1);
    }
  }
  // p's bias, max + log2(sum), the four lanes of a row merged
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = quant_flash::quad_max(m_run[r]);
    bias[r] = m + log2f(quant_flash::quad_sum(
                      l_run[r] * quant_flash::ex2(m_run[r] - m)));
  }
  // every block's rows of S are written (the barrier orders them at cluster
  // scope) and no block reads another's shared memory after it
  cluster_arrive();
  cluster_wait();

  // pass 2: this thread's logits of tile t, read a tile before they are
  // used (into registers of their own: none that a wgmma wrote); p
  // normalised, then rounded to bf16 as P.V's A operand once the P.V before
  // has retired (a wgmma reads its register operands until its wait)
  const float* s_read = a.s_keep + ((size_t)zh * a.S + q0 + rows0) * a.S;
  auto load_s = [&](float(&s)[kS], int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int jj = 0; jj < TK / 8; ++jj) {
        const int key = t * TK + 8 * jj + 2 * q4;
        float2 v = make_float2(kNegInf, kNegInf);
        if (q0 + rows0 + 8 * hh < a.S && key < a.S)
          v = __ldcg(reinterpret_cast<const float2*>(
              s_read + (size_t)8 * hh * a.S + key));
        s[4 * jj + 2 * hh] = v.x;
        s[4 * jj + 2 * hh + 1] = v.y;
      }
    }
  };
  float o[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  float lg[kS], lg_next[kS];
  load_s(lg_next, 0);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int e = 0; e < kS; ++e) lg[e] = lg_next[e];
    if (t + 1 < T) load_s(lg_next, t + 1);
    wgmma_wait<0>();  // P.V of the tile before
    fence_regs(o);
    uint32_t pf[TK / 16][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      pf[j >> 1][(j & 1) * 2] =
          pack_bf16(quant_flash::ex2(fmaf(lg[4 * j], a.sl2, -bias[0])),
                    quant_flash::ex2(fmaf(lg[4 * j + 1], a.sl2, -bias[0])));
      pf[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(quant_flash::ex2(fmaf(lg[4 * j + 2], a.sl2, -bias[1])),
                    quant_flash::ex2(fmaf(lg[4 * j + 3], a.sl2, -bias[1])));
    }
    mbar_wait(vfull + t % kStages, (t / kStages) & 1);
    const uint32_t v_addr = smem_u32(Vs + (t % kStages) * L::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<kCols, 1>(
          o, pf[kk], gmma_desc(v_addr + kk * 16 * kSw, TK * kSw, 8 * kSw, 1),
          1);
    wgmma_commit();
    __syncthreads();  // both warpgroups' P.V of tile t - 1: its V stage free
    if (tid == 0 && t + kStages - 1 < T)
      load_tile(Vs, vfull, 2 * a.H + h, t + kStages - 1);
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_regs(o);

  const int D = a.H * a.Hd;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + rows0 + 8 * hh;
    if (row >= a.S) continue;
    const size_t at = ((size_t)b * a.S + row) * D + (size_t)h * a.Hd + c0 +
                      2 * q4;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (8 * j >= ncol) break;  // columns past Hd are not stored
      const float y0 = o[4 * j + 2 * hh], y1 = o[4 * j + 2 * hh + 1];
      if (a.out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + at +
                                     8 * j) = pack_bf16(y0, y1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + 8 * j) =
            make_float2(y0, y1);
    }
  }
}

template <int CT>
int active_ct(int C) {
  auto kernel = qkv_cluster_kernel<CT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::kBytes);
  if (attr != cudaSuccess) return -(int)attr;
  return wide_cluster::occupancy(kernel, Layout::kBytes, C);
}

// The clusters of C blocks the card runs at once, or a negative
// cudaError_t.
inline int active(int C) {
  return C == 2 ? active_ct<2>(C) : C == 3 ? active_ct<3>(C) : active_ct<0>(C);
}

template <int CT>
int launch_ct(const CUtensorMap (&maps)[2], const Args& a, dim3 grid,
              cudaStream_t stream) {
  static int placed[kMaxCluster + 1] = {};  // active clusters by C, 0: not asked
  if (const int err = wide_cluster::check_placed(placed, a.C, active_ct<CT>))
    return err;
  return wide_cluster::cluster_launch(qkv_cluster_kernel<CT>, Layout::kBytes,
                                      grid, a.C, stream, maps[0], maps[1], a);
}

}  // namespace qkv_cluster

extern "C" {

// The clusters of the cluster kernel the card runs at once for heads of Hd
// (0 where it cannot place one, a negative cudaError_t on failure).
int dlm_fused_qkv_attention_cluster_active(int Hd) {
  int k;
  const int C = wide_cluster::cluster_plan(Hd, &k);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  return k > 1 ? wide_cluster::active_slices_attention<true>(C)
               : qkv_cluster::active(C);
}

// dlm_fused_qkv_attention's arguments (csrc/fused_qkv_attention.cu) for Hd
// a multiple of 8 past 256 and S % 8 == 0, then scratch f32 [B * H, S, S]
// for the logits. Heads of 264 to 2048 run a block a 256-column slice,
// wider ones k slices a block (wide_cluster::cluster_plan). Returns
// cudaErrorInvalidValue for a shape it does not take, and
// cudaErrorInvalidClusterSize where the card cannot place the cluster;
// nothing falls back.
int dlm_fused_qkv_attention_cluster(const void* qkv, void* out, int out_bf16,
                                    int B, int S, int H, int Hd,
                                    float sm_scale, void* stream,
                                    void* s_keep) {
  using namespace qkv_cluster;
  int k;
  const int C = wide_cluster::cluster_plan(Hd, &k);
  if (C == 0 || H <= 0 || B > 65535 || S % 8 || !s_keep)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  // [B][S][3H][Hd] bf16, Hd innermost: q at head index h, K at H + h, V at
  // 2H + h; boxes of 64 columns of one head's 128 (q) or 32 (K, V) rows
  const uint64_t dims[4] = {(uint64_t)Hd, (uint64_t)(3 * H), (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Hd * 2, (uint64_t)3 * H * Hd * 2,
                               (uint64_t)S * 3 * H * Hd * 2};
  const uint32_t box_q[4] = {64, 1, (uint32_t)kBQ, 1};
  const uint32_t box_kv[4] = {64, 1, (uint32_t)TK, 1};
  CUtensorMap maps[2];
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qkv, dims,
                strides, box_q, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qkv, dims,
                strides, box_kv, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 1) {  // the one map serves q, K and V
    const CUtensorMap three[3] = {maps[0], maps[1], maps[1]};
    wide_cluster::SliceArgs s{};
    s.out = out;
    s.ob = (size_t)S * H * Hd;
    s.oh = Hd;
    s.orow = (size_t)H * Hd;
    s.s_keep = static_cast<float*>(s_keep);
    s.out_bf16 = out_bf16;
    s.Sq = S;
    s.Skv = S;
    s.D = Hd;
    s.H = H;
    s.C = C;
    s.k = k;
    s.ld = S;
    s.sl2 = sm_scale * kLog2e;
    return wide_cluster::launch_slices_attention<true>(three, s, B, st);
  }
  Args a{};
  a.out = out;
  a.out_bf16 = out_bf16;
  a.S = S;
  a.H = H;
  a.Hd = Hd;
  a.C = C;
  a.sl2 = sm_scale * kLog2e;
  a.s_keep = static_cast<float*>(s_keep);
  const dim3 grid(C * ((S + kBQ - 1) / kBQ), H, B);
  return C == 2   ? launch_ct<2>(maps, a, grid, st)
         : C == 3 ? launch_ct<3>(maps, a, grid, st)
                  : launch_ct<0>(maps, a, grid, st);
}

}  // extern "C"
