// Fused decoded-int8 MLP block for Hopper (sm_90a): the [64, F] inner
// activation of a 64-row tile never leaves the SMs of one thread-block
// cluster.
//
// Replaces the TPU kernel `_kernel_i8_mlp` (diffusion_llm_rs_tpu/ops/
// pallas_matmul.py, behind `int8w_mlp`):
//   xi, sx = quant_rows(x)                 x bf16 [M, K]
//   inner  = gelu(xi @ w1 * sx * cs1 + b1) f32 [M, F]
//   yi, sy = quant_rows(inner)             amax over the whole inner row
//   out    = yi @ w2 * sy * cs2 + b2 (+ r) [M, N]
// The whole inner row must be known before it is requantized. The rounding
// steps come from int8_common.cuh and every inner value is computed by the
// same epilogue as the chained kernels' (the int32 products are exact in
// any order), so the result equals the chained kernels (quant_rows, gemm,
// quant_rows, gemm) bit for bit.
//
// Design: a cluster of cl = 3 or 4 blocks owns 64 rows. Block j of the
// cluster computes inner columns in chunks of 128 (chunk r * cl + j in round
// r) and owns output columns [j * NT * 64, (j + 1) * NT * 64).
//   - Block j quantizes its share of the 64 x rows into a K-major,
//     128-byte-swizzled shared-memory tile (the A operand of the first
//     product) and copies those rows into the other blocks' tiles.
//   - Pass 1: the block's inner chunks (s8 wgmma, both operands in shared
//     memory), their epilogue and gelu, and each row's amax over them. The
//     partial amaxes go to every block of the cluster through distributed
//     shared memory (a max is exact in any order).
//   - Pass 2, round by round: the block recomputes its chunk bit for bit,
//     quantizes it with the now-known row scale into its slot of the round's
//     [64 x 128 cl] int8 buffer, and copies the slot into the other blocks'
//     buffers (bulk copies completing on their mbarriers). With every slot
//     present, each block multiplies the round's inner columns into its
//     output accumulators (registers). Two buffers alternate; a block
//     refills one only after every block has multiplied it.
//   - Two consumer warpgroups share the work of a block: warpgroup c takes
//     inner columns 64c.. of each chunk and half of each round's 512 inner
//     columns in the second product; at the end each hands the other the
//     partial int32 sums of the rows that one writes.
//   - The f32 epilogue (gelu, requantization) runs on eight warps of an SM
//     and is most of a block's time: its values carry no branch (columns
//     past F have zero scale and bias rather than a test), and the IEEE
//     divisions of the requantization take the fast path of the division
//     without its slow-path branch (int8_common.cuh: quant_level_rcp), so
//     the compiler interleaves a thread's 32 values. With a branch per
//     value it ran them one after another, at twice the time.
//   - s8 wgmma reads both operands K-major, and `Int8Weight.data` is [K, N]
//     with N contiguous, as in JAX: the wrapper hands the kernel K-major
//     copies (w1^T [F, K], w2^T [N, F]) made once per weight. One thread of
//     a producer warpgroup streams their tiles by TMA through a ring of 4
//     stages of 16 KB (its registers go to the consumers, setmaxnreg).
// So both weights stream once per pass through L2 for 64 rows (w1 twice,
// w2 once: 7 MB at 768 -> 3072 -> 768), where the first design streamed
// 4.7 MB for 16 rows; the inner activation is never stored in full.
//
// What bounds it on an H100: at the sampler's shape (M = 2048, 768 -> 3072
// -> 768) the function does 19.3 GOP of int8 products over ~9 MB of inputs
// and outputs, so the tensor cores bound it (0.0098 ms); this design does
// the first product twice (29 GOP). A block (one an SM, 178 KB of shared
// memory) took about 0.1 ms whatever M was (NVIDIA H100 80GB HBM3, 700 W):
// its epilogue and the products run one after the other. The card holds 30
// clusters of 4 at once (its SMs sit in groups that clusters may not span):
// M = 2048, 32 row tiles, would take two waves. Clusters of 3 do a third
// more work a block, and more of them fit at once; the wrapper
// (`mlp_plan`) takes whichever size needs fewer waves, weighted so.
// An inner row wider than 3072, an x row wider than 1536 or an output row
// wider than 1024 goes to the chained kernels (the Python wrapper decides
// with `mlp_fits` and counts those launches apart).

#include "hopper.cuh"
#include "int8_common.cuh"

namespace {

using namespace hopper;
using namespace dlm_int8;

constexpr int kMaxCluster = 4;
constexpr int kRows = 64;                  // rows of x a cluster
constexpr int kChunk = 128;                // inner columns a block a round
constexpr int kStages = 4;
constexpr int kStage = 16384;              // two [64 x 128 B] TMA boxes
constexpr int kBox = 8192;
constexpr int kSlot = kRows * kChunk;      // int8 [64 x 128], 8 KB
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup
constexpr int kMaxInner = 3072;
constexpr int kMaxK = 1536;
constexpr int kMaxNT = 4;                  // 64-column output tiles a block
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int padded_k(int K) { return (K + 127) / 128 * 128; }

// xi tile, ring, two round buffers, amax exchange, scales, barriers
__host__ __device__ constexpr int smem_bytes(int K) {
  return 1024 + kRows * padded_k(K) + kStages * kStage +
         2 * kMaxCluster * kSlot + 2 * kMaxCluster * kRows * 4 + kRows * 4 +
         16 * 8;
}

// the 64-column output tiles of each block
__host__ __device__ constexpr int out_tiles(int N, int cl) {
  return ((N + 63) / 64 + cl - 1) / cl;
}

// byte (row, col) of a [rows x 128 B] tile in TMA's 128-byte swizzle
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

struct Params {
  const __nv_bfloat16* x;
  const float* cs1;
  const float* b1;
  const float* cs2;
  const float* b2;
  const __nv_bfloat16* residual;  // bf16, or f32 where residual_f32
  void* out;
  int out_bf16, M, K, F, N;
  int residual_f32;
};

// NT: 64-column output tiles a block; CL: blocks a cluster (3 or 4)
template <int NT, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
    int8_mlp_kernel(const __grid_constant__ CUtensorMap w1t,
                    const __grid_constant__ CUtensorMap w2t, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int KC = padded_k(p.K) / 128;  // 128-byte k chunks of x
  uint8_t* xs = smem;                  // KC chunks of [64 x 128 B]
  uint8_t* ring = xs + KC * kBox;
  uint8_t* ybuf = ring + kStages * kStage;  // [2][kMaxCluster] slots
  float* amax_x = reinterpret_cast<float*>(ybuf + 2 * kMaxCluster * kSlot);
  float* sx = amax_x + 2 * kMaxCluster * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(sx + kRows);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;  // [2]: the round buffer is complete
  uint64_t* xempty = xfull + 2;       // [2]: every block has multiplied it
  uint64_t* afull = xempty + 2;       // the amax exchange is complete
  uint64_t* xready = afull + 1;       // every block's x rows have arrived

  const int j = (int)cluster_rank();
  const int m0 = blockIdx.y * kRows;
  constexpr int cl = CL, round_cols = cl * kChunk;  // a round's inner columns
  const int rounds = (p.F + round_cols - 1) / round_cols;
  // block j quantizes x rows [x0, x1) for the cluster
  const int x_rows = (kRows + cl - 1) / cl, x0 = j * x_rows;
  const int x1 = min(kRows, x0 + x_rows);
  const int ntc = min(NT, max(0, (p.N + 63) / 64 - j * NT));  // my tiles
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(xfull + b, 1);
      mbar_init(xempty + b, cl);
    }
    mbar_init(afull, cl);
    mbar_init(xready, 1 + cl);
    fence_barrier_init();
  }
  cluster_sync();  // every block's barriers exist before any remote use

  if (tid >= kConsumers) {  // ------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid == kConsumers) {
      int it = 0;
      auto load = [&](const CUtensorMap* map, int c, int r0, int c1, int r1) {
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, kStage);
        tma_load_2d(ring + s * kStage, map, full + s, c, r0);
        tma_load_2d(ring + s * kStage + kBox, map, full + s, c1, r1);
        ++it;
      };
      for (int pass = 0; pass < 2; ++pass)
        for (int r = 0; r < rounds; ++r) {
          const int f0 = (r * cl + j) * kChunk;
          if (f0 < p.F)
            for (int kc = 0; kc < KC; ++kc)
              load(&w1t, kc * 128, f0, kc * 128, f0 + 64);
          if (pass == 1)
            for (int h = 0; h < 2; ++h) {
              const int g0 = r * round_cols + h * 256;
              if (g0 >= p.F || 2 * h >= cl) continue;
              for (int t = 0; t < ntc; ++t)
                load(&w2t, g0, (j * NT + t) * 64, g0 + 128, (j * NT + t) * 64);
            }
        }
    }
    __syncwarp();
  } else {  // --------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    // warpgroup c takes box c of every stage: inner columns 64c.. of the
    // block's chunk, and f 128c.. of each 256 of the second product
    const int c = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q4 = lane & 3;

    // 1. block j quantizes x rows [x0, x1) (warp w: rows x0 + w + 8i) into
    //    its xs and the other blocks' (those rows of each 128-byte k chunk,
    //    bulk copies) with their scales; rows past M are zero with scale 1,
    //    k past K zero. A lane holds 8 values of each 256 of a row.
    constexpr int kSeg = kMaxK / 256;
    if (tid == 0)
      mbar_expect_tx(xready, (kRows - (x1 - x0)) * 128 * KC);
    {
      uint4 v[3][kSeg];
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int m = m0 + x0 + (tid >> 5) + 8 * rr;
        const bool live = x0 + (tid >> 5) + 8 * rr < x1 && m < p.M;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const int k = i * 256 + lane * 8;
          v[rr][i] = live && k < p.K
                         ? *reinterpret_cast<const uint4*>(p.x + (size_t)m * p.K + k)
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int row = x0 + (tid >> 5) + 8 * rr;
        if (row >= x1) break;
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[rr][i]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            amax = fmaxf(amax, fabsf(__bfloat162float(e[u])));
        }
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        const float s = row_scale(amax), rcp = refined_rcp(s);
        if (lane < cl) st_cluster_f32(cluster_addr(sx + row, lane), s);
        uint32_t word[kSeg][2];
        auto levels = [&](bool fast) {
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[rr][i]);
            word[i][0] = word[i][1] = 0u;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const float f = __bfloat162float(e[u]);
              const int8_t l = fast ? quant_level_rcp(f, s, rcp) : quant_level(f, s);
              word[i][u >> 2] |= (uint32_t)(uint8_t)l << (8 * (u & 3));
            }
          }
        };
        if (fast_divisor(s))  // the same for the whole warp
          levels(true);
        else
          levels(false);
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const int k = i * 256 + lane * 8;
          if (k < KC * 128)
            *reinterpret_cast<uint2*>(xs + (k >> 7) * kBox + swz(row, k & 127)) =
                make_uint2(word[i][0], word[i][1]);
        }
      }
    }
    if (cl < kMaxCluster)  // the unused last slot of both round buffers
      for (int i = tid; i < 2 * kSlot / 16; i += kConsumers)
        reinterpret_cast<uint4*>(ybuf + ((i * 16 / kSlot) * kMaxCluster + 3) *
                                            kSlot)[i % (kSlot / 16)] =
            make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
    fence_cluster();
    named_barrier(1, kConsumers);
    if (tid == 0) {
      for (int d = 1; d < cl; ++d) {
        const uint32_t peer = (j + d) % cl;
        for (int kc = 0; kc < KC; ++kc) {
          uint8_t* rows = xs + kc * kBox + x0 * 128;
          bulk_copy_cluster(cluster_addr(rows, peer), rows, (x1 - x0) * 128,
                            cluster_addr(xready, peer));
        }
      }
      for (int d = 0; d < cl; ++d) mbar_arrive_cluster(cluster_addr(xready, d));
    }
    mbar_wait_cluster(xready, 0);

    // the ring, in the producer's order: wait for a stage, multiply this
    // warpgroup's box of it, and release the one before once its products
    // are done
    int it = 0;
    bool pending = false;
    auto stage = [&]() {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      wgmma_fence();
      return smem_u32(ring + s * kStage + c * kBox);
    };
    auto staged = [&]() {
      wgmma_commit();
      wgmma_wait<1>();
      if (pending) mbar_arrive(empty + (it - 1) % kStages);
      pending = true;
      ++it;
    };
    auto drain = [&]() {
      wgmma_wait<0>();
      if (pending) mbar_arrive(empty + (it - 1) % kStages);
      pending = false;
    };

    // inner columns f0 + 64c ..: acc[4i + e] is row 16w + g + 8(e >> 1),
    // column f0 + 64c + 8i + 2q + (e & 1); the chunk's column scales and
    // biases are loaded while its products run
    int acc[32];
    float cs_v[16], b_v[16];
    auto inner_chunk = [&](int f0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = f0 + 64 * c + 8 * (i >> 1) + 2 * q4 + (i & 1);
        cs_v[i] = n < p.F ? p.cs1[n] : 0.f;
        b_v[i] = p.b1 && n < p.F ? p.b1[n] : 0.f;
      }
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t w_addr = stage();
        const uint32_t x_addr = smem_u32(xs + kc * kBox);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_s8_ss_n64(acc, gmma_desc(x_addr + ks * 32, 16, 1024, 1),
                          gmma_desc(w_addr + ks * 32, 16, 1024, 1),
                          kc > 0 || ks > 0);
        staged();
      }
      drain();
      fence_regs(acc);
    };
    // the epilogue of the chained kernels' first product, and gelu
    auto inner_value = [&](int e, int i, int h) {
      return epilogue_v(acc[4 * i + e], sx[warp * 16 + g + 8 * h],
                        cs_v[2 * i + (e & 1)], p.b1 != nullptr,
                        b_v[2 * i + (e & 1)], 1);
    };

    // 2. pass 1: this warpgroup's partial row amax
    float amax[2] = {0.f, 0.f};
    for (int r = 0; r < rounds; ++r) {
      const int f0 = (r * cl + j) * kChunk;
      if (f0 >= p.F) continue;
      inner_chunk(f0);
      // columns past F have zero scale and bias: gelu(0) = 0 leaves the
      // amax as it is, without a branch per value
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(inner_value(e, i, e >> 1)));
    }
    // the cluster's amax of each row (2 cl partials), then its scale
    float sy[2], sy_rcp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
      if (q4 == 0)
        for (int b = 0; b < cl; ++b)
          st_cluster_f32(cluster_addr(amax_x + (2 * j + c) * kRows + warp * 16 +
                                          g + 8 * h,
                                      b),
                         amax[h]);
    }
    fence_cluster();
    named_barrier(1, kConsumers);
    if (tid == 0)
      for (int b = 0; b < cl; ++b) mbar_arrive_cluster(cluster_addr(afull, b));
    mbar_wait_cluster(afull, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = 0.f;
      for (int b = 0; b < 2 * cl; ++b)
        a = fmaxf(a, amax_x[b * kRows + warp * 16 + g + 8 * h]);
      sy[h] = row_scale(a);
      sy_rcp[h] = refined_rcp(sy[h]);
    }
    const bool fast_rows =
        __all_sync(0xffffffffu, fast_divisor(sy[0]) && fast_divisor(sy[1]));

    // 3. pass 2: round r's 128 cl inner columns, requantized, into the output
    //    accumulators; out[t][4i + e] is row 16w + g + 8(e >> 1), column
    //    (j NT + t) 64 + 8i + 2q + (e & 1), summed over this warpgroup's f
    int out[NT][32];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 32; ++e) out[t][e] = 0;
    for (int r = 0; r < rounds; ++r) {
      const int b = r & 1, f0 = (r * cl + j) * kChunk;
      uint8_t* buf = ybuf + b * kMaxCluster * kSlot;
      uint8_t* mine = buf + j * kSlot;
      if (f0 < p.F) inner_chunk(f0);
      if (r >= 2) mbar_wait_cluster(xempty + b, ((r >> 1) - 1) & 1);
      if (f0 < p.F) {
        // the levels of this thread's 32 values (0 past F)
        uint32_t lv[8][2];
        auto levels = [&](bool fast) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t w = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = inner_value(2 * h + e, i, h);
                const int8_t l = fast ? quant_level_rcp(v, sy[h], sy_rcp[h])
                                      : quant_level(v, sy[h]);
                w |= (uint32_t)(uint8_t)l << (8 * e);
              }
              lv[i][h] = w;
            }
        };
        if (fast_rows)
          levels(true);
        else
          levels(false);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint16_t*>(
                mine + swz(warp * 16 + g + 8 * h, 64 * c + 8 * i + 2 * q4)) =
                (uint16_t)lv[i][h];
      }
      fence_proxy_async();
      named_barrier(1, kConsumers);
      if (tid == 0) {
        mbar_expect_tx(xfull + b, (cl - 1) * kSlot);
        for (int d = 1; d < cl; ++d) {
          const uint32_t peer = (j + d) % cl;
          bulk_copy_cluster(cluster_addr(mine, peer), mine, kSlot,
                            cluster_addr(xfull + b, peer));
        }
      }
      mbar_wait_cluster(xfull + b, (r >> 1) & 1);
      for (int h = 0; h < 2; ++h) {
        const int g0 = r * round_cols + h * 256;
        if (g0 >= p.F || 2 * h >= cl) continue;
        // slot 2h + c; a cluster of 3 has no slot 3, which holds zeros (its
        // stage's box 1 belongs to the next round): a branch around the
        // products would make ptxas serialize them
        const uint32_t y_addr = smem_u32(buf + (2 * h + c) * kSlot);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t >= ntc) continue;
          const uint32_t w_addr = stage();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_s8_ss_n64(out[t], gmma_desc(y_addr + ks * 32, 16, 1024, 1),
                            gmma_desc(w_addr + ks * 32, 16, 1024, 1), 1);
          staged();
        }
      }
      drain();
      named_barrier(1, kConsumers);  // every warp is done with the buffer
      if (tid == 0)
        for (int d = 0; d < cl; ++d)
          mbar_arrive_cluster(cluster_addr(xempty + b, d));
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_regs(out[t]);

    // 4. the two warpgroups' partial sums meet through the ring (every stage
    //    has been multiplied; integers: exact): warpgroup c finishes rows
    //    16w + g + 8c of its warps and hands the other rows to the other.
    //    out = yi @ w2 * sy * cs2 + b2 (+ residual)
    int* part = reinterpret_cast<int*>(ring);  // [2][NT][16][128]
    const int other = 1 - c, lt = tid & 127;  // c picks registers by select
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[((other * NT + t) * 16 + 2 * i + e) * 128 + lt] =
              c ? out[t][4 * i + e] : out[t][4 * i + 2 + e];
    named_barrier(1, kConsumers);
    const int m = m0 + warp * 16 + g + 8 * c;
    if (m < p.M) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (j * NT + t) * 64;
        if (t >= ntc) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = n0 + 8 * i + 2 * q4;  // even; N % 4 == 0
          if (n >= p.N) continue;
          const float2 cs = *reinterpret_cast<const float2*>(p.cs2 + n);
          const float2 bb = p.b2 ? *reinterpret_cast<const float2*>(p.b2 + n)
                                 : make_float2(0.f, 0.f);
          float2 res = make_float2(0.f, 0.f);
          if (p.residual)
            res = p.residual_f32
                      ? *reinterpret_cast<const float2*>(
                            reinterpret_cast<const float*>(p.residual) +
                            (size_t)m * p.N + n)
                      : __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(
                                p.residual + (size_t)m * p.N + n));
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int acc2 = (c ? out[t][4 * i + 2 + e] : out[t][4 * i + e]) +
                             part[((c * NT + t) * 16 + 2 * i + e) * 128 + lt];
            y[e] = epilogue_v(acc2, c ? sy[1] : sy[0], e ? cs.y : cs.x,
                              p.b2 != nullptr,
                              e ? bb.y : bb.x, 0);
            if (p.residual) y[e] = __fadd_rn(y[e], e ? res.y : res.x);
          }
          const size_t o = (size_t)m * p.N + n;
          if (p.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                               o) = __floats2bfloat162_rn(y[0], y[1]);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
                make_float2(y[0], y[1]);
        }
      }
    }
  }
  // no block leaves while another may still copy into it or arrive on it
  cluster_sync();
}

// Let the kernel use all of a block's dynamic shared memory (once).
template <int NT, int CL>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_kernel<NT, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  return err;
}

template <int NT, int CL>
int launch(const CUtensorMap& w1t, const CUtensorMap& w2t, const Params& p,
           cudaStream_t stream) {
  const cudaError_t opted = opt_in<NT, CL>();
  if (opted != cudaSuccess) return (int)opted;
  dim3 grid(CL, (p.M + kRows - 1) / kRows);
  int8_mlp_kernel<NT, CL><<<grid, kThreads, smem_bytes(p.K), stream>>>(w1t, w2t, p);
  return (int)cudaGetLastError();
}

template <int CL>
int launch_cl(const CUtensorMap& w1t, const CUtensorMap& w2t, const Params& p,
              cudaStream_t stream) {
  switch (out_tiles(p.N, CL)) {
    case 1: return launch<1, CL>(w1t, w2t, p, stream);
    case 2: return launch<2, CL>(w1t, w2t, p, stream);
    case 3: return launch<3, CL>(w1t, w2t, p, stream);
    default: return launch<4, CL>(w1t, w2t, p, stream);
  }
}

template <int NT, int CL>
cudaError_t active_clusters(int* n, int bytes) {
  cudaError_t err = opt_in<NT, CL>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  return cudaOccupancyMaxActiveClusters(n, int8_mlp_kernel<NT, CL>, &cfg);
}

}  // namespace

extern "C" {

// The dynamic shared memory the fused kernel needs at widths K -> F -> N
// with clusters of cl (3 or 4) blocks, or 0 where it does not take them (the
// caller then chains the two GEMMs).
int dlm_int8_mlp_smem(int K, int F, int N, int cl) {
  if (K <= 0 || F <= 0 || N <= 0 || cl < 3 || cl > kMaxCluster) return 0;
  if (F > kMaxInner || K > kMaxK || out_tiles(N, cl) > kMaxNT) return 0;
  const int bytes = smem_bytes(K);
  return bytes <= kSmemLimit ? bytes : 0;
}

// How many clusters of cl blocks of the kernel at widths K -> N the card
// runs at once (0 where the kernel does not take the widths).
int dlm_int8_mlp_active_clusters(int K, int N, int cl) {
  if (dlm_int8_mlp_smem(K, 16, N, cl) == 0) return 0;
  const int bytes = smem_bytes(K);
  int n = 0;
  cudaError_t err;
  switch (out_tiles(N, cl) * 8 + cl) {
#define DLM_MLP_CASE(NT_, CL_) \
  case NT_ * 8 + CL_: err = active_clusters<NT_, CL_>(&n, bytes); break;
    DLM_MLP_CASE(1, 3) DLM_MLP_CASE(2, 3) DLM_MLP_CASE(3, 3) DLM_MLP_CASE(4, 3)
    DLM_MLP_CASE(1, 4) DLM_MLP_CASE(2, 4) DLM_MLP_CASE(3, 4) DLM_MLP_CASE(4, 4)
#undef DLM_MLP_CASE
    default: return 0;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// out[M, N] = MLP(x[M, K]) over the K-major int8 weights w1t [F, K] and
// w2t [N, F] (the transposes of the [K, F] and [F, N] matrices), bf16 x, a
// bf16 residual (f32 where residual_f32, 8-byte aligned), f32 column scales
// and biases (either bias may be null), in
// clusters of cl blocks; out is bf16 (out_bf16 = 1) or f32. K % 16 == 0,
// F % 16 == 0, N % 4 == 0, the weights 16-byte aligned, and
// dlm_int8_mlp_smem(K, F, N, cl) > 0 (else cudaErrorInvalidValue).
int dlm_int8_mlp(const void* x, const void* w1t, const void* cs1,
                 const void* b1, const void* w2t, const void* cs2,
                 const void* b2, const void* residual, void* out, int out_bf16,
                 int M, int K, int F, int N, int cl, void* stream,
                 int residual_f32) {
  if (M <= 0) return 0;
  if (dlm_int8_mlp_smem(K, F, N, cl) == 0 || K % 16 || F % 16 || N % 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const uint64_t dims1[2] = {(uint64_t)K, (uint64_t)F};
  const uint64_t dims2[2] = {(uint64_t)F, (uint64_t)N};
  const uint64_t stride1[1] = {(uint64_t)K}, stride2[1] = {(uint64_t)F};
  const uint32_t box[2] = {128, 64};
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w1t, dims1,
                stride1, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w2t, dims2,
                stride2, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const float*>(cs1),
                 static_cast<const float*>(b1),
                 static_cast<const float*>(cs2),
                 static_cast<const float*>(b2),
                 static_cast<const __nv_bfloat16*>(residual),
                 out, out_bf16, M, K, F, N, residual_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cl == 3 ? launch_cl<3>(maps[0], maps[1], p, st)
                 : launch_cl<4>(maps[0], maps[1], p, st);
}

}  // extern "C"
