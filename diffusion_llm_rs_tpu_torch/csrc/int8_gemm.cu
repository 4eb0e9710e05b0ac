// Decoded-int8 linear layer for Hopper (sm_90a): per-row activation
// quantization, then one s8 wgmma GEMM core with a fused f32 epilogue.
//
// Replaces the TPU kernel `_kernel_i8w` (diffusion_llm_rs_tpu/ops/
// pallas_matmul.py, behind `int8w_matmul`), and is the product of
// `_kernel_i8` (`_matmul_a8`) too: there packed_gemm.cu first unpacks the
// packed weight onto its int8 column grid, once a call, and this core
// multiplies. The Python wrappers (ops/int8_matmul.py, ops/packed_matmul.py)
// chain the kernels:
//   int8w_matmul       = quant_rows(x) -> gemm(w^T, epilogue: *sx*cs + b,
//                        gelu, +r)
//   int8w_mlp_chained  = quant_rows(x) -> gemm(w1^T, +b1, gelu, f32 out)
//                        -> quant_rows(inner) -> gemm(w2^T, +b2, +r)
//   matmul_a8          = quant_rows(x) -> unpack_i8(w) -> gemm(+b, gelu)
// which is the arithmetic of the TPU kernels step for step. The chained MLP
// serves only widths the fused kernel of int8_mlp.cu (`_kernel_i8_mlp`)
// does not take; that kernel equals this chain bit for bit: both take their
// arithmetic from int8_common.cuh.
//
// What bounds it on an H100: at the sampler's M = 2048 (B=8 x S=256) and
// serving's M = 8192 the single linears (K = 768) sit at the ridge, where
// the bf16 output stream weighs about as much as the int8 products; at M = 8
// (the time-MLP) the weight's bytes; chip_smoke.py computes both bounds per
// shape.
//
// Design. s8 wgmma reads both operands K-major, and the weights keep JAX's
// [K, N] layout, so the core multiplies xi [M, K] by a K-major copy wt
// [N, K] (int8w_matmul: `_k_major`, made once a weight; matmul_a8: the
// per-call unpack). Then out[M, N] = epilogue(xi . wt^T):
//   - A block owns 128 rows of the A operand (two consumer warpgroups of 64)
//     and BN rows of the B operand. A producer warp streams 128-byte-wide
//     boxes of K of both by TMA (128-byte swizzle, rows and K past the ends
//     read as zero) into a ring of 3-6 stages with one mbarrier each; the
//     consumers run four m64nBNk32 products a stage.
//   - Both operands are K-major, so either can be A. With tokens on the
//     wgmma M side (A = xi) a tile is 128 tokens x 64, 96 or 128 weight
//     columns; with tokens on its N side (A = wt, B = xi) it is 128 weight
//     columns x 8, 16 or 32 tokens, so M = 8 costs one m64n8k32 product a
//     64 columns and k32, not a 128-row tile 94% empty.
//   - `gemm_plan` (below, and ops/int8_matmul.py: gemm_plan, the same
//     arithmetic) picks the orientation, the tile and a split of the K
//     steps over up to 16 blocks where the tiles do not fill the card, by
//     waves of two blocks an SM. Each split writes its int32 partial sums;
//     a second kernel adds them in order and applies the epilogue. int32
//     sums are exact, so every plan gives the same bits (no atomics).
//   - The epilogue stages the tile's int32 sums through the ring's shared
//     memory as [m][n] (rows padded against bank conflicts), so in both
//     orientations each thread then reads four adjacent columns of one row
//     and writes them, and reads the residual, in coalesced 8- or 16-byte
//     pieces.
//
// Arithmetic contract (mirrors the TPU kernels and the plain twins):
//   amax = max |x[m, :]|  (x as given: bf16 for layer inputs, f32 for the
//                          MLP inner activation)
//   sx   = amax > 0 ? amax / 127 : 1;   xi = rint(x / sx)  (half to even)
//   y    = ((float)acc * sx[m]) * cs[n] (+ b[n]) (gelu_tanh) (+ r[m, n])
// every step rounded on its own (no fused multiply-add), as in f32 XLA.

#include "hopper.cuh"
#include "int8_common.cuh"

namespace {

using namespace hopper;
using namespace dlm_int8;

constexpr int kQuantThreads = 256;
constexpr int kQuantRows = kQuantThreads / 32;  // a warp a row

// A warp a row: amax over the whole row, then the int8 levels; 16 bytes of
// x a lane and load where the row allows it (K a multiple of 8 bf16 or 4
// f32 values, rows 16-byte aligned), else one value. The second pass
// reads the row again from L1. The division takes the fast path of
// div.rn.f32 where the scale allows it (int8_common.cuh: quant_level_rcp,
// the same quotient), so a lane's values interleave.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, int M, int K,
                      int8_t* __restrict__ xi, float* __restrict__ sx) {
  constexpr int V = 16 / sizeof(T);
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  int8_t* out = xi + (size_t)row * K;
  const bool vec = K % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float amax = 0.f;
  if (vec) {
    for (int k = lane * V; k < K; k += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(to_f32(v[e])));
    }
  } else {
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax);
  if (lane == 0) sx[row] = s;
  const float r = refined_rcp(s);
  auto levels = [&](bool fast) {
    auto level = [&](float v) {
      return fast ? quant_level_rcp(v, s, r) : quant_level(v, s);
    };
    if (vec) {
      for (int k = lane * V; k < K; k += 32 * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
        const T* v = reinterpret_cast<const T*>(&raw);
        uint32_t w[V / 4];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (e % 4 == 0) w[e / 4] = 0;
          w[e / 4] |= (uint32_t)(uint8_t)level(to_f32(v[e])) << (8 * (e % 4));
        }
        if constexpr (V == 8)
          *reinterpret_cast<uint2*>(out + k) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(out + k) = w[0];
      }
    } else {
      for (int k = lane; k < K; k += 32) out[k] = level(to_f32(xr[k]));
    }
  };
  if (fast_divisor(s))  // the same for the whole warp
    levels(true);
  else
    levels(false);
}

// ---------------------------------------------------------------- GEMM ---

constexpr int kARows = 128;                // A rows a block: 2 warpgroups
constexpr int kKBytes = 128;               // K a stage: one swizzled row
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kRingBytes = 96 * 1024;      // two blocks an SM
constexpr int kMaxStages = 6;
constexpr int kMaxSplits = 16;

struct Gemm {
  const float* sx;                // [M]
  const float* cs;                // [N]
  const float* bias;              // [N] or null
  const __nv_bfloat16* residual;  // [M, N] bf16 (f32 where residual_f32) or null
  void* out;                      // [M, N] bf16 (out_bf16) or f32
  int* ws;                        // [splits, M, N] int32 partials
  int gelu, out_bf16, M, N, K, ksteps, splits;
  int residual_f32;               // the residual is f32, read in finish4
};

// kSwap: tokens on the wgmma N side (A = wt, B = xi); BN: B rows a block
template <bool kSwap, int BN>
struct Tile {
  static constexpr int kStage = (kARows + BN) * kKBytes;
  static constexpr int kStages =
      kRingBytes / kStage < kMaxStages ? kRingBytes / kStage : kMaxStages;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kTM = kSwap ? BN : kARows;  // tokens a tile
  static constexpr int kTN = kSwap ? kARows : BN;  // weight columns a tile
  // staged int32 row, in words: 8 mod 32 spreads the row-major int2 stores
  // of a warp over all banks, 4 mod 32 the transposing scalar ones
  static constexpr int kStride = kTN + (kSwap ? 4 : 8);
  static constexpr int kStaged = kTM * kStride * 4;
  // then the tile's row scales, column scales and biases
  static constexpr int kEpilogue = kStaged + (kTM + 2 * kTN) * 4;
  static constexpr int kBars = kRing > kEpilogue ? kRing : kEpilogue;
  static constexpr int kSmem = 1024 + kBars + 2 * kStages * 8;
};

// y for 4 adjacent columns of one row (o: the first one's offset in out),
// from their sums, the row scale, the column scales and biases, and the
// row's bf16 residual (raw, 4 values; an f32 residual is read here), stored
__device__ __forceinline__ void finish4(const Gemm& p, size_t o, int4 acc,
                                        float s_m, const float* cs,
                                        const float* b, uint2 res) {
  const int a[4] = {acc.x, acc.y, acc.z, acc.w};
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y[e] = epilogue_v(a[e], s_m, cs[e], p.bias != nullptr, b[e], p.gelu);
  if (p.residual) {
    float2 lo, hi;
    if (p.residual_f32) {
      const float4 r = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(p.residual) + o);
      lo = make_float2(r.x, r.y);
      hi = make_float2(r.z, r.w);
    } else {
      lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res.x));
      hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res.y));
    }
    y[0] = __fadd_rn(y[0], lo.x);
    y[1] = __fadd_rn(y[1], lo.y);
    y[2] = __fadd_rn(y[2], hi.x);
    y[3] = __fadd_rn(y[3], hi.y);
  }
  if (p.out_bf16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

__device__ __forceinline__ uint2 residual4(const Gemm& p, size_t o) {
  return p.residual && !p.residual_f32
             ? *reinterpret_cast<const uint2*>(p.residual + o)
             : make_uint2(0u, 0u);
}

// Block (x, y, z): A rows 128 x .., B rows BN y .., K steps of split z.
template <bool kSwap, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const Gemm p) {
  using T = Tile<kSwap, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBars);
  uint64_t* empty = full + T::kStages;
  const int a0 = blockIdx.x * kARows, b0 = blockIdx.y * BN, z = blockIdx.z;
  const int k0 = z * p.ksteps / p.splits, k1 = (z + 1) * p.ksteps / p.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ---------------------------- producer
    if (threadIdx.x == kConsumers)
      for (int kc = k0; kc < k1; ++kc) {
        const int i = kc - k0, s = i % T::kStages;
        mbar_wait(empty + s, ((i / T::kStages) & 1) ^ 1);
        uint8_t* st = smem + s * T::kStage;
        mbar_expect_tx(full + s, T::kStage);
        tma_load_2d(st, &ta, full + s, kc * kKBytes, a0);
        tma_load_2d(st + kARows * kKBytes, &tb, full + s, kc * kKBytes, b0);
      }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int c = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  int acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
  for (int kc = k0; kc < k1; ++kc) {
    const int i = kc - k0, s = i % T::kStages;
    mbar_wait(full + s, (i / T::kStages) & 1);
    const uint32_t a_addr = smem_u32(smem + s * T::kStage + c * 64 * kKBytes);
    const uint32_t b_addr = smem_u32(smem + s * T::kStage + kARows * kKBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_s8_ss<BN>(acc, gmma_desc(a_addr + ks * 32, 16, 1024, 1),
                      gmma_desc(b_addr + ks * 32, 16, 1024, 1),
                      i > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) mbar_arrive(empty + (i - 1) % T::kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // stage the sums as [m][n]: acc[4j + e] is A row 64c + 16w + g + 8(e >> 1),
  // B row 8j + 2q + (e & 1); and the tile's row scales, column scales and
  // biases beside them
  named_barrier(1, kConsumers);  // every product has read the ring
  const int m0 = kSwap ? b0 : a0, n0 = kSwap ? a0 : b0;
  int* stg = reinterpret_cast<int*>(smem);
  float* s_sx = reinterpret_cast<float*>(smem + T::kStaged);
  float* s_cs = s_sx + T::kTM;
  float* s_b = s_cs + T::kTN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ar = c * 64 + warp * 16 + g + 8 * h, br = 8 * j + 2 * q;
      if constexpr (kSwap) {
        stg[br * T::kStride + ar] = acc[4 * j + 2 * h];
        stg[(br + 1) * T::kStride + ar] = acc[4 * j + 2 * h + 1];
      } else {
        *reinterpret_cast<int2*>(stg + ar * T::kStride + br) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  if (p.splits == 1) {
    for (int i = threadIdx.x; i < T::kTM; i += kConsumers)
      s_sx[i] = m0 + i < p.M ? p.sx[m0 + i] : 0.f;
    for (int i = threadIdx.x; i < T::kTN; i += kConsumers) {
      s_cs[i] = n0 + i < p.N ? p.cs[n0 + i] : 0.f;
      s_b[i] = p.bias && n0 + i < p.N ? p.bias[n0 + i] : 0.f;
    }
  }
  named_barrier(1, kConsumers);

  // four adjacent columns of one row a thread and step (N % 4 == 0), in
  // batches whose residual loads all issue before their stores
  constexpr int kQuads = T::kTN / 4;
  constexpr int kIters = T::kTM * kQuads / kConsumers;
  constexpr int kBatch = kIters <= 8 ? kIters : kIters % 8 == 0 ? 8 : 6;
  static_assert(kIters * kConsumers == T::kTM * kQuads, "whole quads");
  static_assert(kIters % kBatch == 0, "whole batches");
#pragma unroll 1
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    int4 v[kBatch];
    uint2 res[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (i0 + u) * kConsumers;
      const int ml = idx / kQuads, nl = (idx % kQuads) * 4;
      const int m = m0 + ml, n = n0 + nl;
      v[u] = *reinterpret_cast<const int4*>(stg + ml * T::kStride + nl);
      res[u] = m < p.M && n < p.N && p.splits == 1
                   ? residual4(p, (size_t)m * p.N + n)
                   : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (i0 + u) * kConsumers;
      const int ml = idx / kQuads, nl = (idx % kQuads) * 4;
      const int m = m0 + ml, n = n0 + nl;
      if (m >= p.M || n >= p.N) continue;
      const size_t o = (size_t)m * p.N + n;
      if (p.splits > 1)
        *reinterpret_cast<int4*>(p.ws + (size_t)z * p.M * p.N + o) = v[u];
      else
        finish4(p, o, v[u], s_sx[ml], s_cs + nl, s_b + nl, res[u]);
    }
  }
}

// out = epilogue(sum of the splits' partials, in order)
__global__ void int8_gemm_reduce(const Gemm p) {
  const size_t quads = (size_t)p.M * p.N / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= quads) return;
  const size_t o = idx * 4, stride = (size_t)p.M * p.N;
  int4 v = *reinterpret_cast<const int4*>(p.ws + o);
  for (int z = 1; z < p.splits; ++z) {
    const int4 u = *reinterpret_cast<const int4*>(p.ws + z * stride + o);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const int m = (int)(o / p.N), n = (int)(o % p.N);
  float cs[4], b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cs[e] = p.cs[n + e];
    b[e] = p.bias ? p.bias[n + e] : 0.f;
  }
  finish4(p, o, v, p.sx[m], cs, b, residual4(p, o));
}

template <bool kSwap, int BN>
int launch(const void* xi, const void* wt, Gemm& p, cudaStream_t stream) {
  using T = Tile<kSwap, BN>;
  auto kernel = int8_gemm_kernel<kSwap, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mx, mw;
  const uint64_t xd[2] = {(uint64_t)p.K, (uint64_t)p.M};
  const uint64_t wd[2] = {(uint64_t)p.K, (uint64_t)p.N};
  const uint64_t stride[1] = {(uint64_t)p.K};
  const uint32_t abox[2] = {kKBytes, kARows}, bbox[2] = {kKBytes, BN};
  if (!make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xi, xd, stride,
                kSwap ? bbox : abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt, wd, stride,
                kSwap ? abox : bbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int rows_a = kSwap ? p.N : p.M, rows_b = kSwap ? p.M : p.N;
  dim3 grid((rows_a + kARows - 1) / kARows, (rows_b + BN - 1) / BN, p.splits);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(kSwap ? mw : mx, kSwap ? mx : mw,
                                               p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t quads = (size_t)p.M * p.N / 4;
  int8_gemm_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The plan of a shape: orientation, B rows a block, blocks along K. A cost
// model fitted to this kernel's times on an H100 (44 shapes, M = 1-8192, N
// and K of the model's linears), in units of one k step of a 128 x 128
// tile: waves of two blocks an SM, each wave its blocks' k steps (a 128 x
// 96 tile 0.7 of one, 128 x 64 0.65, a tile of up to 32 tokens on the wgmma
// N side 0.4) plus 1.5 for the ring's fill and the epilogue; a split adds 3
// for its second launch and its partials' bytes at 1 MB a unit.
// ops/int8_matmul.py: gemm_plan is the same arithmetic.
struct Plan {
  int swap, tile, splits;
};

constexpr int kNormalTiles[3] = {128, 96, 64};
constexpr double kNormalStep[3] = {1.0, 0.7, 0.65};
constexpr int kSwapTiles[3] = {8, 16, 32};
constexpr double kSwapStep = 0.4;
constexpr double kSplitCost = 3.0;

Plan gemm_plan(int M, int N, int K, int sms) {
  const int ksteps = (K + kKBytes - 1) / kKBytes;
  const long long slots = 2LL * sms;
  Plan best{0, 128, 1};
  double best_cost = 1e300;
  auto consider = [&](int swap, int tile, long long tiles, double step) {
    for (int s = 1; s <= kMaxSplits && s <= ksteps; s *= 2) {
      const double waves = (double)((tiles * s + slots - 1) / slots);
      double cost = waves * ((double)((ksteps + s - 1) / s) * step + 1.5);
      if (s > 1) cost += kSplitCost + (double)M * N * 4 * (s + 1) / 1e6;
      if (cost < best_cost) {
        best_cost = cost;
        best = Plan{swap, tile, s};
      }
    }
  };
  if (M <= kSwapTiles[2]) {
    int bt = kSwapTiles[2];
    for (int t : kSwapTiles)
      if (t >= M) {
        bt = t;
        break;
      }
    consider(1, bt, (long long)((N + kARows - 1) / kARows) * ((M + bt - 1) / bt),
             kSwapStep);
  }
  for (int i = 0; i < 3; ++i)
    consider(0, kNormalTiles[i],
             (long long)((M + kARows - 1) / kARows) *
                 ((N + kNormalTiles[i] - 1) / kNormalTiles[i]),
             kNormalStep[i]);
  return best;
}

}  // namespace

extern "C" {

// x: [M, K] bf16 (x_bf16 = 1) or f32 (0) -> xi int8 [M, K], sx f32 [M].
int dlm_quant_rows(const void* x, int x_bf16, void* xi, void* sx, int M,
                   int K, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kQuantRows - 1) / kQuantRows;
  if (x_bf16)
    quant_rows_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, static_cast<int8_t*>(xi),
        static_cast<float*>(sx));
  else
    quant_rows_kernel<float><<<blocks, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), M, K, static_cast<int8_t*>(xi),
        static_cast<float*>(sx));
  return (int)cudaGetLastError();
}

// gemm_plan of a shape on a card of `sms` SMs, as swap * 10000 + tile * 100
// + splits (the wrapper's plan is held to it on the card).
int dlm_int8_gemm_plan(int M, int N, int K, int sms) {
  const Plan p = gemm_plan(M, N, K, sms);
  return p.swap * 10000 + p.tile * 100 + p.splits;
}

// out[M, N] = epilogue(xi[M, K] @ wt[N, K]^T) under the plan (swap, tile,
// splits); K % 16 == 0, N % 4 == 0, xi and wt 16-byte aligned, out and the
// residual 16-byte aligned (a bf16 residual 8); with splits > 1, ws holds
// the int32 partials [splits, M, N]. out is bf16 (out_bf16 = 1) or f32 (the
// MLP's inner activation); the residual bf16, or f32 where residual_f32.
int dlm_int8_gemm(const void* xi, const void* wt, const void* sx,
                  const void* cs, const void* bias, const void* residual,
                  int gelu, void* out, int out_bf16, int M, int N, int K,
                  int swap, int tile, int splits, void* ws, void* stream,
                  int residual_f32) {
  if (M <= 0) return 0;
  const int ksteps = (K + kKBytes - 1) / kKBytes;
  if (K <= 0 || K % 16 || N <= 0 || N % 4 || splits < 1 ||
      splits > kMaxSplits || splits > ksteps || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  Gemm p{static_cast<const float*>(sx),
         static_cast<const float*>(cs),
         static_cast<const float*>(bias),
         static_cast<const __nv_bfloat16*>(residual),
         out,
         static_cast<int*>(ws),
         gelu,
         out_bf16,
         M,
         N,
         K,
         ksteps,
         splits,
         residual_f32};
  auto st = static_cast<cudaStream_t>(stream);
  switch (swap * 1000 + tile) {
    case 128: return launch<false, 128>(xi, wt, p, st);
    case 96: return launch<false, 96>(xi, wt, p, st);
    case 64: return launch<false, 64>(xi, wt, p, st);
    case 1008: return launch<true, 8>(xi, wt, p, st);
    case 1016: return launch<true, 16>(xi, wt, p, st);
    case 1032: return launch<true, 32>(xi, wt, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
