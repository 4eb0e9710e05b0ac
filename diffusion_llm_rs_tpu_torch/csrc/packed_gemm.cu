// Packed-weight linear layers for Hopper (sm_90a): x @ dequant(W) with W kept
// at 1/2/4/8 bits in device memory.
//
// Replaces the TPU kernels of diffusion_llm_rs_tpu/ops/pallas_matmul.py behind
// `matmul`:
//   act_bits = 16: `_kernel_full`, `_kernel`, `_kernel_bias` (helper
//                  `_dequant_column`): bf16 x bf16 -> f32, unpacked inside
//                  the K loop (`packed_gemm16_kernel`),
//   act_bits = 8:  `_kernel_i8` (helper `_fill_w_i8`): int8 x int8 -> int32
//                  over activations quantized per token beforehand. As the
//                  TPU kernel fills its int8 scratch at the first grid step
//                  and every later step reuses it, `unpack_i8_kernel` here
//                  turns the packed weight into its int8 column grid once a
//                  call, K-major ([N, K], what s8 wgmma reads), into a
//                  scratch of K * N bytes the wrapper allocates per call (not
//                  cached: the packed layout exists to save weight memory);
//                  the s8 wgmma core of int8_gemm.cu then multiplies, the
//                  core `int8w_matmul` runs on.
//
// Layout (`MatmulWeight`): byte (kp, n) of the packed [Kp, N] matrix holds, in
// bit-field s, the level of W[s*Kp + kp, n] (Kp = K / vpb, vpb = 8 / bits).
// A tile of packed rows therefore pairs with vpb column ranges of x; the
// K loop walks (packed tile, bit-field) pairs. Scale and zero-point of logical
// row r are row r / group_size of the [K/G, N] sidecars.
//
// Arithmetic contract (mirrors the TPU kernels and the plain versions):
//   act16: w = bf16((lv - zp) * scale)   f32 sub, f32 mul, one rounding;
//          y = sum_k x[m,k] * w[k,n] in f32 (+ b[n]) (gelu_tanh)
//   act8:  inv = 1 / cs[n]               IEEE division
//          w8  = clamp(rint((lv - zp) * (scale * inv)), -127, 127)
//          y   = ((float)acc * sx[m]) * cs[n] (+ b[n]) (gelu_tanh)
// every f32 step rounded on its own (no fused multiply-add).
//
// act_bits = 8, what bounds the unpack: its bytes (the packed levels and
// sidecars read once, K * N int8 written once, which the GEMM then reads
// from L2); chip_smoke.py times it inside matmul_a8.
//
// act_bits = 16 (`packed_gemm16_kernel`). What bounds it on an H100: at M =
// 2048 the bf16 products (989 TFLOP/s), at M <= 256 the packed weight's
// bytes; chip_smoke.py computes both per shape. The design computes the
// transposed product, out^T = W^T x^T, with the dequantized weight as the
// wgmma A operand taken from registers: each consumer thread unpacks exactly
// the weight entries of its own A fragment, so the bf16 weight never makes a
// round trip through shared memory and the token count M becomes the wgmma N,
// a tile of 8, 16, 32, 64, 96 or 128 tokens: M = 8 runs as cheaply as M =
// 2048 runs fully.
//   - A block owns 128 weight columns (two consumer warpgroups of 64) and BM
//     tokens; a producer warp fills a ring of 2-4 shared-memory stages: the x
//     tile (BM x 64 bf16, 128-byte swizzle) and that step's scale and
//     zero-point rows by TMA, the packed tile (64 rows x 128 bytes, stored
//     with the same chunk swizzle so the consumers' 2-byte reads hit distinct
//     banks) by cp.async; one mbarrier per stage counts both.
//   - A step is one (packed tile of 64 rows, bit-field) pair, so the x tile is
//     the 64 logical rows s*Kp + kp0.. and the packed layout stays as JAX
//     writes it. Row A of warp w, lane 4g + q maps to weight column 16w + 2g
//     (row + 8: column + 1), so one 16-bit read gives a thread both of its
//     columns and the output pairs are adjacent.
//   - Levels become floats without a conversion instruction (0x4B000000 | lv
//     is 2^23 + lv), then (lv - zp) * scale and one bf16 rounding per entry.
//     A step's 32 two-byte reads come first, and it unpacks into one of two
//     register sets while the previous step's products run.
//   - The unpacking, not the tensor cores, sets the pace (its latency more
//     than its instruction count: two blocks an SM ran 1.3x faster than
//     one), so the token tile trades tensor work against the card's waves:
//     BM = 96 or 128 above 64 tokens, chosen with the split count by `plan`.
//   - Where the tiles do not fill the card the K steps split over up to 16
//     blocks; each writes its f32 partial and a second kernel sums them in
//     a fixed order and applies the epilogue, so the result is repeatable
//     (no atomics).
//

#include "hopper.cuh"
#include "int8_common.cuh"

namespace {

using namespace hopper;
using dlm_int8::gelu_tanh;

// ------------------------------------------------------------- act_bits = 8

constexpr int kUK = 64;  // packed rows a block
constexpr int kUN = 64;  // columns a block
constexpr int kUThreads = 256;

// wt[n, s*Kp + kp] = the int8 grid value of bit-field s of packed byte (kp,
// n). A block reads a [64 x 64] tile of packed bytes (coalesced along n,
// rows padded a word against bank conflicts); then a thread owns one column
// and 16 consecutive packed rows: per bit-field it writes 16 bytes of the
// column's K-major row (4 threads: 64 contiguous bytes), with the column's
// reciprocal taken once and the sidecars loaded again only where a group
// ends. Needs Kp % 16 == 0, N % 4 == 0.
__global__ void __launch_bounds__(kUThreads)
    unpack_i8_kernel(const uint8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ zp,
                     const float* __restrict__ cs, int8_t* __restrict__ wt,
                     int N, int Kp, int G, int bits) {
  __shared__ uint32_t tile[kUK][kUN / 4 + 1];
  const int kp0 = blockIdx.y * kUK, n0 = blockIdx.x * kUN;
  const int vpb = 8 / bits, K = Kp * vpb;
  const uint32_t mask = (1u << bits) - 1u;
  for (int i = threadIdx.x; i < kUK * kUN / 4; i += kUThreads) {
    const int r = i / (kUN / 4), cw = i % (kUN / 4);
    const int kp = kp0 + r, n = n0 + cw * 4;
    tile[r][cw] = kp < Kp && n < N
                      ? *reinterpret_cast<const uint32_t*>(w + (size_t)kp * N + n)
                      : 0u;
  }
  __syncthreads();
  const int nl = threadIdx.x >> 2, kq = threadIdx.x & 3;
  const int n = n0 + nl, kp = kp0 + 16 * kq;
  if (n >= N || kp >= Kp) return;  // Kp % 16 == 0: all 16 rows valid
  const float inv = __fdiv_rn(1.f, cs[n]);
  for (int s = 0; s < vpb; ++s) {
    const int r0 = s * Kp + kp;  // logical row of the first value
    const int grp = r0 / G;
    int next = (grp + 1) * G - r0;
    size_t side = (size_t)grp * N + n;
    float sc = __fmul_rn(scale[side], inv), z = zp[side];
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j == next) {  // the next group starts at row r0 + j
        next += G;
        side += N;
        sc = __fmul_rn(scale[side], inv);
        z = zp[side];
      }
      const uint32_t byte =
          (tile[16 * kq + j][nl >> 2] >> (8 * (nl & 3))) & 0xffu;
      const float lv = (float)((byte >> (s * bits)) & mask);
      float v = __fmul_rn(__fsub_rn(lv, z), sc);
      v = fminf(fmaxf(rintf(v), -127.f), 127.f);
      word[j / 4] |= ((uint32_t)(int)v & 0xffu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(wt + (size_t)n * K + r0) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// ------------------------------------------------------------ act_bits = 16

constexpr int kWN = 128;         // weight columns a block
constexpr int kWK = 64;          // packed rows a tile = logical rows a step
constexpr int kThreads16 = 288;  // two consumer warpgroups + a producer warp
constexpr int kMaxSmem16 = 220 * 1024;

struct Args16 {
  const uint8_t* w;   // [Kp, N] packed levels
  const float* bias;  // [N] or null
  void* out;          // [M, N]
  float* ws;          // [splits, M, N] partials (splits > 1)
  int out_bf16, gelu;
  int M, N, Kp, G, bits;
  int steps, splits;  // K steps, blocks along K
  int R;              // sidecar rows a step
  int stages, stage_bytes, sc_bytes;
  int n16;            // N % 16 == 0: the packed tile copies 16 bytes at a time
};

__device__ __forceinline__ void store_pair(const Args16& p, size_t at, float y0,
                                           float y1, int n) {
  if (p.bias) {
    y0 = __fadd_rn(y0, p.bias[n]);
    y1 = __fadd_rn(y1, p.bias[n + 1]);
  }
  if (p.gelu) {
    y0 = gelu_tanh(y0);
    y1 = gelu_tanh(y1);
  }
  if (p.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                       at) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
        make_float2(y0, y1);
}

// two blocks an SM (at most 113 registers a thread): the unpacking is
// latency-bound, and a second block's warps hide it
template <int BM, bool kFast>
__global__ void __launch_bounds__(kThreads16, 2)
    packed_gemm16_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tsc,
                         const __grid_constant__ CUtensorMap tzp,
                         const Args16 p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  constexpr int kXBytes = BM * 128;

  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int it0 = (int)((long long)z * p.steps / p.splits);
  const int it1 = (int)((long long)(z + 1) * p.steps / p.splits);
  const int vpb = 8 / p.bits, Kp = p.Kp, G = p.G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA arrival + the warp's cp.asyncs
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ------------------------------------ producer
    const int lane = threadIdx.x & 31;
    for (int it = it0; it < it1; ++it) {
      const int i = it - it0, s = i % p.stages;
      mbar_wait(empty + s, ((i / p.stages) & 1) ^ 1);
      const int kp0 = (it / vpb) * kWK, r0 = (it % vpb) * Kp + kp0;
      uint8_t* xs = smem + s * p.stage_bytes;
      uint8_t* wsm = xs + kXBytes;
      uint8_t* scs = wsm + kWK * kWN;
      if (lane == 0) {
        mbar_expect_tx(full + s, kXBytes + 2 * p.R * kWN * 4);
        tma_load_2d(xs, &tx, full + s, r0, m0);
        tma_load_2d(scs, &tsc, full + s, n0, r0 / G);
        tma_load_2d(scs + p.sc_bytes, &tzp, full + s, n0, r0 / G);
      }
      if (p.n16) {
        for (int c = lane; c < kWK * 8; c += 32) {
          const int row = c >> 3, ch = c & 7, kp = kp0 + row, n = n0 + ch * 16;
          const bool ok = kp < Kp && n < p.N;
          cp_async16(wsm + row * 128 + ((ch ^ (row & 7)) << 4),
                     ok ? p.w + (size_t)kp * p.N + n : p.w, ok ? 16 : 0);
        }
      } else {
        for (int c = lane; c < kWK * 32; c += 32) {
          const int row = c >> 5, b = (c & 31) * 4, kp = kp0 + row, n = n0 + b;
          const bool ok = kp < Kp && n < p.N;
          cp_async4(wsm + row * 128 + ((((b >> 4) ^ (row & 7))) << 4) + (b & 15),
                    ok ? p.w + (size_t)kp * p.N + n : p.w, ok ? 4 : 0);
        }
      }
      cp_async_mbar_arrive(full + s);
    }
  } else {  // ---------------------------------------------------- consumers
    const int cw = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
    const int cc = cw * 64 + warp * 16 + g * 2;  // this thread's two columns
    const uint32_t mask = (1u << p.bits) - 1u;

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

    // Step it unpacks its weights into a (registers) while the products of
    // step it - 1 run; those are waited for, and their stage released, only
    // once step it's products are issued. a alternates between two
    // register sets, so the in-flight products' operands stay untouched.
    auto unpack = [&](uint32_t(&a)[kWK / 16][4], int it) {
      const int i = it - it0, s = i % p.stages;
      const int kp0 = (it / vpb) * kWK, sb = it % vpb, r0 = sb * Kp + kp0;
      const int sh = sb * p.bits;
      const uint8_t* wsm = smem + s * p.stage_bytes + kXBytes;
      const float* scs = reinterpret_cast<const float*>(wsm + kWK * kWN);
      const float* zps = scs + p.sc_bytes / 4;
      mbar_wait(full + s, (i / p.stages) & 1);
      // the step's packed bytes of this thread's two columns, rows kk*16 +
      // 2q + {0, 1, 8, 9}, all read before any arithmetic
      uint32_t u[kWK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kk * 16 + q4 * 2 + (e & 1) + (e >> 1) * 8;
          u[kk][e] = *reinterpret_cast<const uint16_t*>(
              wsm + k * 128 + ((((cc >> 4) ^ (k & 7))) << 4) + (cc & 15));
        }
      // level -> float without a conversion: 0x4B000000 | lv is 2^23 + lv
      auto level = [&](uint32_t v, int shift) {
        return __fsub_rn(__int_as_float(0x4B000000 | ((v >> shift) & mask)),
                         8388608.f);
      };
      // sidecar row of logical row r0 + k: grp (relative to r0 / G), which
      // moves on at k = nb, nb + G, ...; rows past Kp are 0. On the fast
      // path a step's rows share row 0 and all lie below Kp.
      int grp = 0, nb = G - (r0 % G), cur = 0;
      float2 s2 = *reinterpret_cast<const float2*>(scs + cc);
      float2 z2 = *reinterpret_cast<const float2*>(zps + cc);
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        float wv[4][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kk * 16 + q4 * 2 + (e & 1) + (e >> 1) * 8;
          if (!kFast) {
            while (k >= nb) {
              ++grp;
              nb += G;
            }
            if (grp != cur) {
              s2 = *reinterpret_cast<const float2*>(scs + grp * kWN + cc);
              z2 = *reinterpret_cast<const float2*>(zps + grp * kWN + cc);
              cur = grp;
            }
          }
          const bool ok = kFast || kp0 + k < Kp;
          wv[e][0] = ok ? __fmul_rn(__fsub_rn(level(u[kk][e], sh), z2.x), s2.x)
                        : 0.f;
          wv[e][1] = ok ? __fmul_rn(__fsub_rn(level(u[kk][e], sh + 8), z2.y),
                                    s2.y)
                        : 0.f;
        }
        a[kk][0] = pack_bf16(wv[0][0], wv[1][0]);
        a[kk][1] = pack_bf16(wv[0][1], wv[1][1]);
        a[kk][2] = pack_bf16(wv[2][0], wv[3][0]);
        a[kk][3] = pack_bf16(wv[2][1], wv[3][1]);
      }
    };
    auto issue = [&](uint32_t(&a)[kWK / 16][4], int it) {
      const int i = it - it0;
      const uint32_t x_addr = smem_u32(smem + (i % p.stages) * p.stage_bytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        wgmma_rs<BM, 0>(acc, a[kk], gmma_desc(x_addr + kk * 32, 16, 1024, 1),
                        1);
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty + (i - 1) % p.stages);
      }
    };
    uint32_t a0[kWK / 16][4], a1[kWK / 16][4];
#pragma unroll 1
    for (int it = it0; it < it1; it += 2) {
      unpack(a0, it);
      issue(a0, it);
      if (it + 1 < it1) {
        unpack(a1, it + 1);
        issue(a1, it + 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + (it1 - it0 - 1) % p.stages);

    const int n = n0 + cc;
    if (n < p.N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + j * 8 + q4 * 2 + e;
          if (m >= p.M) continue;
          const float y0 = acc[4 * j + e], y1 = acc[4 * j + 2 + e];
          if (p.splits > 1)
            *reinterpret_cast<float2*>(
                p.ws + ((size_t)z * p.M + m) * p.N + n) = make_float2(y0, y1);
          else
            store_pair(p, (size_t)m * p.N + n, y0, y1, n);
        }
      }
    }
  }
}

// out = epilogue(sum over the splits' partials), the splits in order
__global__ void packed_gemm16_reduce(const Args16 p) {
  const size_t pairs = (size_t)p.M * p.N / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const size_t at = idx * 2, stride = (size_t)p.M * p.N;
  float2 y = *reinterpret_cast<const float2*>(p.ws + at);
  for (int z = 1; z < p.splits; ++z) {
    const float2 v = *reinterpret_cast<const float2*>(p.ws + z * stride + at);
    y.x = __fadd_rn(y.x, v.x);
    y.y = __fadd_rn(y.y, v.y);
  }
  store_pair(p, at, y.x, y.y, (int)(at % p.N));
}

// The token tile BM and the blocks along K of a shape. Up to 64 tokens take
// one tile of the next of 8, 16, 32, 64. Above, BM = 96 or 128 and the
// split count come from a cost model fitted to this kernel on an H100
// (chip_smoke.py's shapes): a block holds the SM's issue slots for its
// whole K loop, two blocks an SM run at once, a block alone on its SM
// runs in 0.6 of the time, a 96-token block in 0.9 of a 128-token one
// (less tensor work, the same unpacking), and the second pass over the f32
// partials costs about one step plus their bytes at 5 TB/s over 2.5 us.
struct Plan {
  int bm, splits;
};

Plan plan(int M, int N, int K, int bits) {
  const int steps = (K * bits / 8 + kWK - 1) / kWK * (8 / bits);
  const int slots = 2 * 132;
  Plan best{M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64, 1};
  double best_cost = 1e30;
  for (int bm : {best.bm, 96, 128}) {
    if ((M <= 64) != (bm <= 64)) continue;
    const double tiles = (double)((N + kWN - 1) / kWN) * ((M + bm - 1) / bm);
    for (int s = 1; s <= 16 && s <= steps; s *= 2) {
      const double blocks = tiles * s;
      const double full = (double)(long long)(blocks / slots);
      const double rem = blocks - full * slots;
      const double waves = full + (rem == 0 ? 0 : rem > slots / 2 ? 1 : 0.6);
      double cost = waves * ((steps + s - 1) / s) * (bm == 96 ? 0.9 : 1.0);
      if (s > 1) cost += 1 + (double)M * N * 4 * (s + 1) / (5e12 * 2.5e-6);
      if (cost < best_cost) {
        best_cost = cost;
        best = Plan{bm, s};
      }
    }
  }
  return best;
}

template <int BM, bool kFast>
int launch16_bm(const void* x, Args16& p, const float* scale, const float* zp,
                int K, cudaStream_t stream) {
  auto kernel = packed_gemm16_kernel<BM, kFast>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem16);
  if (attr != cudaSuccess) return (int)attr;
  const int Kg = K / p.G;
  CUtensorMap mx, ms, mz;
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)p.M}, xs[1] = {(uint64_t)K * 2};
  const uint32_t xb[2] = {64, BM};
  const uint64_t sd[2] = {(uint64_t)p.N, (uint64_t)Kg}, ss[1] = {(uint64_t)p.N * 4};
  const uint32_t sbx[2] = {kWN, (uint32_t)p.R};
  if (!make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, sd, ss, sbx,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&mz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, zp, sd, ss, sbx,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  p.sc_bytes = (p.R * kWN * 4 + 1023) / 1024 * 1024;
  p.stage_bytes = BM * 128 + kWK * kWN + 2 * p.sc_bytes;
  p.stages = (kMaxSmem16 - 1024 - 64) / p.stage_bytes;
  if (p.stages > 4) p.stages = 4;
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + p.stages * p.stage_bytes + 2 * p.stages * 8;
  dim3 grid((p.N + kWN - 1) / kWN, (p.M + BM - 1) / BM, p.splits);
  kernel<<<grid, kThreads16, smem, stream>>>(mx, ms, mz, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t pairs = (size_t)p.M * p.N / 2;
  packed_gemm16_reduce<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch16(const void* x, const uint8_t* w, const float* scale,
             const float* zp, const float* bias, int gelu, void* out,
             int out_bf16, float* ws, int splits, int M, int N, int K,
             int bits, int G, cudaStream_t stream) {
  Args16 p{};
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.ws = ws;
  p.out_bf16 = out_bf16;
  p.gelu = gelu;
  p.M = M;
  p.N = N;
  p.Kp = K * bits / 8;
  p.G = G;
  p.bits = bits;
  p.steps = (p.Kp + kWK - 1) / kWK * (8 / bits);
  p.splits = splits;
  // a step's 64 logical rows lie in one group and all below Kp: one sidecar
  // row a step, no row masks
  const bool fast = G % kWK == 0 && p.Kp % kWK == 0;
  p.R = fast ? 1 : 63 / G + 2;
  p.n16 = N % 16 == 0;
  if (splits < 1 || splits > p.steps || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
#define DLM_GEMM16_CASE(BM_)                                               \
  case BM_:                                                                \
    return fast ? launch16_bm<BM_, true>(x, p, scale, zp, K, stream)       \
                : launch16_bm<BM_, false>(x, p, scale, zp, K, stream);
  switch (plan(M, N, K, bits).bm) {
    DLM_GEMM16_CASE(8)
    DLM_GEMM16_CASE(16)
    DLM_GEMM16_CASE(32)
    DLM_GEMM16_CASE(64)
    DLM_GEMM16_CASE(96)
    DLM_GEMM16_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DLM_GEMM16_CASE
}

}  // namespace

extern "C" {

// Blocks along K the act_bits = 16 kernel uses for this shape: where it is
// more than 1 the wrapper allocates the f32 partials [splits, M, N].
int dlm_packed_gemm_splits(int M, int N, int K, int bits) {
  return plan(M, N, K, bits).splits;
}

// out[M, N] = epilogue(x[M, K] @ dequant(w)), x bf16; with `splits` > 1
// (from dlm_packed_gemm_splits) ws holds the splits' f32 partials
// [splits, M, N]. Needs N % 4 == 0 and Kp = K * bits / 8 a multiple of 8;
// all pointers 16-byte aligned.
int dlm_packed_gemm(const void* x, const void* w, const void* scale,
                    const void* zp, const void* bias, int gelu, void* out,
                    int out_bf16, int M, int N, int K, int bits,
                    int group_size, void* ws, int splits, void* stream) {
  if (M <= 0) return 0;
  return launch16(x, static_cast<const uint8_t*>(w),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(zp),
                  static_cast<const float*>(bias), gelu, out, out_bf16,
                  static_cast<float*>(ws), splits, M, N, K, bits, group_size,
                  static_cast<cudaStream_t>(stream));
}

// The packed weight [Kp, N] (act_bits = 8) on its int8 column grid cs[N],
// K-major: wt[N, K] int8 (the operand of int8_gemm.cu's core). Needs
// Kp = K * bits / 8 a multiple of 16, N % 4 == 0, w 4-byte aligned.
int dlm_packed_unpack_i8(const void* w, const void* scale, const void* zp,
                         const void* cs, void* wt, int N, int K, int bits,
                         int group_size, void* stream) {
  const int Kp = K * bits / 8;
  if (N <= 0 || K <= 0) return 0;
  if (N % 4 || Kp % 16) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kUN - 1) / kUN, (Kp + kUK - 1) / kUK);
  unpack_i8_kernel<<<grid, kUThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(zp), static_cast<const float*>(cs),
      static_cast<int8_t*>(wt), N, Kp, group_size, bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
