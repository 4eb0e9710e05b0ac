// Packed-weight linear layer for Hopper (sm_90a): x @ dequant(W) with W kept
// at 1/2/4/8 bits in device memory and unpacked inside the K loop.
//
// Replaces the TPU kernels of diffusion_llm_rs_tpu/ops/pallas_matmul.py behind
// `matmul`:
//   act_bits = 16: `_kernel_full`, `_kernel`, `_kernel_bias` (helper
//                  `_dequant_column`): bf16 x bf16 -> f32,
//   act_bits = 8:  `_kernel_i8` (helper `_fill_w_i8`): int8 x int8 -> int32
//                  over activations quantized per token beforehand.
// Those keep a whole dequantized weight (or a column of it) in on-chip
// scratch, filled at the first grid step and reused by the steps after it. A
// Hopper block has 227 KB and blocks run in no order, so here every block
// unpacks the weight tile it is about to multiply.
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
// act_bits = 8 (`packed_gemm_kernel`) keeps its first design: a plain
// mma.sync s8 tile loop (BM x 128 output tiles, 8 warps, 64 bytes of K per
// row and step staged through shared memory, every block repeating the unpack
// of the weight tiles it needs).

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------- act_bits = 8

constexpr int BN = 128;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int kRowBytes = 64 + 16;  // padded smem row: conflict-free frags
constexpr int kRowWords = kRowBytes / 4;

struct Args {
  const void* x;       // [M, K] int8
  const float* sx;     // [M] activation scales
  const uint8_t* w;    // [Kp, N] packed levels
  const float* scale;  // [K/G, N]
  const float* zp;     // [K/G, N]
  const float* cs;     // [N] column grid
  const float* bias;   // [N] or null
  void* out;           // [M, N]
  int out_bf16;        // out dtype: 1 = bf16, 0 = f32
  int gelu;
  int M, N, K, Kp, G, bits;
};

__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu_tanh(float y) {
  // jax.nn.gelu(approximate=True):
  //   y * (0.5 * (1 + tanh(sqrt(2/pi) * (y + 0.044715 * y^3))))
  const float c = 0.7978845608028654f;
  float y3 = __fmul_rn(__fmul_rn(y, y), y);
  float inner = __fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, y3)));
  float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner)));
  return __fmul_rn(y, cdf);
}

// A step puts 64 int8 values of K per row into shared memory, two mma
// k-steps. The B tile is n-major ([n][k], the .col operand): one 32-bit word
// holds 4 consecutive k of one column.
template <int BM>
__global__ void __launch_bounds__(kThreads) packed_gemm_kernel(Args p) {
  constexpr int RPW = 4;             // k rows per word of the B tile
  constexpr int BKR = 16 * RPW;      // k rows per step
  constexpr int ESZ = 1;             // bytes per activation
  constexpr int MI = BM / 32;        // m16 tiles per warp (warp tile BM/2 x 32)
  constexpr int A_IT = BM * 4 / kThreads;  // 16-byte chunks of x per thread
  using Acc = int;

  __shared__ __align__(16) uint32_t As[BM * kRowWords];
  __shared__ __align__(16) uint32_t Bs[BN * kRowWords];

  const int M = p.M, N = p.N, K = p.K, Kp = p.Kp, G = p.G, bits = p.bits;
  const int vpb = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  // unpack mapping: this thread owns word `rq` (RPW k rows) of the columns
  // 4*cw .. 4*cw+3 for cw = cw0 and cw0 + 2; a warp's stores then fall into
  // 32 different banks
  const int rq = lane & 15;
  const int cw0 = warp * 4 + (lane >> 4);
  const char* xb = static_cast<const char*>(p.x);

  Acc acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // per-thread sidecar cache: the thread's columns never change
  int cur_grow[2] = {-1, -1};
  float sc[2][4], zpv[2][4], inv_cs[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sc[i][c] = 0.f;
      zpv[i][c] = 0.f;
      inv_cs[i][c] = 0.f;
      int n = n0 + (cw0 + 2 * i) * 4 + c;
      if (n < N) inv_cs[i][c] = __fdiv_rn(1.f, p.cs[n]);
    }

  uint4 areg[A_IT];
  uint32_t raw[2][RPW];

  auto load_x = [&](int s, int kp0) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      int c = tid + i * kThreads;
      int row = c >> 2, ke = (c & 3) * (16 / ESZ);
      int m = m0 + row, kp = kp0 + ke;
      areg[i] = (m < M && kp < Kp)
                    ? *reinterpret_cast<const uint4*>(
                          xb + ((size_t)m * K + (size_t)s * Kp + kp) * ESZ)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto load_w = [&](int kp0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int n = n0 + (cw0 + 2 * i) * 4;
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        int kp = kp0 + rq * RPW + j;
        raw[i][j] = (kp < Kp && n < N)
                        ? *reinterpret_cast<const uint32_t*>(
                              p.w + (size_t)kp * N + n)
                        : 0u;
      }
    }
  };

  const int tiles = (Kp + BKR - 1) / BKR;
  const int total = tiles * vpb;
  load_w(0);
  load_x(0, 0);
  for (int it = 0; it < total; ++it) {
    const int kp0 = (it / vpb) * BKR, s = it % vpb;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      int c = tid + i * kThreads;
      int row = c >> 2, kc = (c & 3) * 16;
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(As) +
                                row * kRowBytes + kc) = areg[i];
    }
    // unpack bit-field s of the packed tile into the B tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cw = cw0 + 2 * i;
      const int n = n0 + cw * 4;
      const int kpa = kp0 + rq * RPW;      // first packed row of this word
      const int r0 = s * Kp + kpa;         // its logical row
      int grow = r0 / G, rem = r0 - grow * G;
      float v[RPW][4];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        if (rem >= G) {  // next group (G >= 1)
          grow += rem / G;
          rem = rem % G;
        }
        const bool valid = (kpa + j < Kp) && (n < N);
        if (valid && grow != cur_grow[i]) {
          const float4 s4 = *reinterpret_cast<const float4*>(
              p.scale + (size_t)grow * N + n);
          const float4 z4 = *reinterpret_cast<const float4*>(
              p.zp + (size_t)grow * N + n);
          zpv[i][0] = z4.x; zpv[i][1] = z4.y; zpv[i][2] = z4.z; zpv[i][3] = z4.w;
          sc[i][0] = __fmul_rn(s4.x, inv_cs[i][0]);
          sc[i][1] = __fmul_rn(s4.y, inv_cs[i][1]);
          sc[i][2] = __fmul_rn(s4.z, inv_cs[i][2]);
          sc[i][3] = __fmul_rn(s4.w, inv_cs[i][3]);
          cur_grow[i] = grow;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float lv = (float)((raw[i][j] >> (8 * c + s * bits)) & mask);
          float val = __fmul_rn(__fsub_rn(lv, zpv[i][c]), sc[i][c]);
          val = fminf(fmaxf(rintf(val), -127.f), 127.f);
          v[j][c] = valid ? val : 0.f;
        }
        ++rem;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Bs[(cw * 4 + c) * kRowWords + rq] =
            ((uint32_t)(int)v[0][c] & 0xffu) |
            (((uint32_t)(int)v[1][c] & 0xffu) << 8) |
            (((uint32_t)(int)v[2][c] & 0xffu) << 16) |
            (((uint32_t)(int)v[3][c] & 0xffu) << 24);
      }
    }
    __syncthreads();
    if (it + 1 < total) {
      const int kp1 = ((it + 1) / vpb) * BKR, s1 = (it + 1) % vpb;
      if (s1 == 0) load_w(kp1);  // this tile's bit-fields are all unpacked
      load_x(s1, kp1);
    }
#pragma unroll
    for (int ks = 0; ks < 16; ks += 8) {  // two mma k-steps, in words
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint32_t* base = As + (wm + i * 16 + g) * kRowWords + ks + t;
        a[i][0] = base[0];
        a[i][1] = base[8 * kRowWords];
        a[i][2] = base[4];
        a[i][3] = base[8 * kRowWords + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* base = Bs + (wn + j * 8 + g) * kRowWords + ks + t;
        uint32_t b0 = base[0], b1 = base[4];
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_tile(acc[i][j], a[i], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float s_m = p.sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n >= N) continue;
          float y = (float)acc[i][j][half * 2 + e];
          y = __fmul_rn(__fmul_rn(y, s_m), p.cs[n]);
          if (p.bias) y = __fadd_rn(y, p.bias[n]);
          if (p.gelu) y = gelu_tanh(y);
          const size_t o = (size_t)m * N + n;
          if (p.out_bf16)
            static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(p.out)[o] = y;
        }
      }
    }
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

cudaError_t launch8(const Args& p, cudaStream_t stream) {
  // small M: 64-row tiles put more blocks on the card
  if (p.M <= 256) {
    dim3 grid((p.N + BN - 1) / BN, (p.M + 63) / 64);
    packed_gemm_kernel<64><<<grid, kThreads, 0, stream>>>(p);
  } else {
    dim3 grid((p.N + BN - 1) / BN, (p.M + 127) / 128);
    packed_gemm_kernel<128><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks along K the act_bits = 16 kernel uses for this shape: where it is
// more than 1 the wrapper allocates the f32 partials [splits, M, N].
int dlm_packed_gemm_splits(int M, int N, int K, int bits) {
  return plan(M, N, K, bits).splits;
}

// out[M, N] = epilogue(x[M, K] @ dequant(w)). a8 = 0: x is bf16, sx and cs
// are unused; with `splits` > 1 (from dlm_packed_gemm_splits) ws holds the
// splits' f32 partials [splits, M, N]; a8 = 1: x is int8 with per-row
// scales sx[M] and the column grid cs[N]. Needs N % 4 == 0 and Kp = K * bits
// / 8 a multiple of 8 (a8 = 0) or 16 (a8 = 1); all pointers 16-byte aligned.
int dlm_packed_gemm(const void* x, const void* sx, const void* w,
                    const void* scale, const void* zp, const void* cs,
                    const void* bias, int gelu, void* out, int out_bf16,
                    int a8, int M, int N, int K, int bits, int group_size,
                    void* ws, int splits, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (!a8)
    return launch16(x, static_cast<const uint8_t*>(w),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(zp),
                    static_cast<const float*>(bias), gelu, out, out_bf16,
                    static_cast<float*>(ws), splits, M, N, K, bits,
                    group_size, s);
  Args p{x,
         static_cast<const float*>(sx),
         static_cast<const uint8_t*>(w),
         static_cast<const float*>(scale),
         static_cast<const float*>(zp),
         static_cast<const float*>(cs),
         static_cast<const float*>(bias),
         out,
         out_bf16,
         gelu,
         M,
         N,
         K,
         K * bits / 8,
         group_size,
         bits};
  return (int)launch8(p, s);
}

}  // extern "C"
