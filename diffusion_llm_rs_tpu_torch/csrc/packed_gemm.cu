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
// unpacks the tile it is about to multiply: one kernel, templated on the
// activation type and the M tile, with bits, bias and gelu as arguments.
//
// Layout (`MatmulWeight`): byte (kp, n) of the packed [Kp, N] matrix holds, in
// bit-field s, the level of W[s*Kp + kp, n] (Kp = K / vpb, vpb = 8 / bits).
// A tile of packed rows therefore pairs with vpb column ranges of x; the
// K loop walks (packed tile, bit-field) pairs, reads each packed byte from
// device memory once (it stays in registers across its bit-fields), and for
// each bit-field stages the matching x tile. Scale and zero-point of logical
// row r are row r / group_size of the [K/G, N] sidecars.
//
// What bounds it on an H100: at M = 2048 the bf16 products (989 TFLOP/s) and
// at M <= 256 the bytes of the packed weight plus the activations; the
// script chip_smoke.py computes both per shape. This first version is a
// plain mma.sync tile loop (BM x 128 output tiles, BM = 128 or 64, 8 warps,
// 64 bytes of K per row and step staged through shared memory, the next
// step's global loads in registers while the current one is multiplied).
// Each block repeats the unpack of the weight tiles it needs, so the unpack
// work grows with M / BM; wgmma, TMA and a shared unpack are later work.
//
// Arithmetic contract (mirrors the TPU kernels and the plain versions):
//   act16: w = bf16((lv - zp) * scale)   f32 sub, f32 mul, one rounding;
//          y = sum_k x[m,k] * w[k,n] in f32 (+ b[n]) (gelu_tanh)
//   act8:  inv = 1 / cs[n]               IEEE division
//          w8  = clamp(rint((lv - zp) * (scale * inv)), -127, 127)
//          y   = ((float)acc * sx[m]) * cs[n] (+ b[n]) (gelu_tanh)
// every f32 step rounded on its own (no fused multiply-add).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int kRowBytes = 64 + 16;  // padded smem row: conflict-free frags
constexpr int kRowWords = kRowBytes / 4;

struct Args {
  const void* x;       // [M, K] bf16 (act16) or int8 (act8)
  const float* sx;     // [M] activation scales (act8)
  const uint8_t* w;    // [Kp, N] packed levels
  const float* scale;  // [K/G, N]
  const float* zp;     // [K/G, N]
  const float* cs;     // [N] column grid (act8)
  const float* bias;   // [N] or null
  void* out;           // [M, N]
  int out_bf16;        // out dtype: 1 = bf16, 0 = f32
  int gelu;
  int M, N, K, Kp, G, bits;
};

__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Both activation types put 64 bytes of K per row into a step: 32 bf16 or 64
// int8 values, two mma k-steps either way, and the fragment words sit at the
// same offsets. The B tile is n-major ([n][k], the .col operand): one 32-bit
// word holds RPW consecutive k of one column.
template <bool A8, int BM>
__global__ void __launch_bounds__(kThreads) packed_gemm_kernel(Args p) {
  constexpr int RPW = A8 ? 4 : 2;    // k rows per word of the B tile
  constexpr int BKR = 16 * RPW;      // k rows per step
  constexpr int ESZ = A8 ? 1 : 2;    // bytes per activation
  constexpr int MI = BM / 32;        // m16 tiles per warp (warp tile BM/2 x 32)
  constexpr int A_IT = BM * 4 / kThreads;  // 16-byte chunks of x per thread
  using Acc = typename std::conditional<A8, int, float>::type;

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
      if (A8) {
        int n = n0 + (cw0 + 2 * i) * 4 + c;
        if (n < N) inv_cs[i][c] = __fdiv_rn(1.f, p.cs[n]);
      }
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
          if (A8) {
            sc[i][0] = __fmul_rn(s4.x, inv_cs[i][0]);
            sc[i][1] = __fmul_rn(s4.y, inv_cs[i][1]);
            sc[i][2] = __fmul_rn(s4.z, inv_cs[i][2]);
            sc[i][3] = __fmul_rn(s4.w, inv_cs[i][3]);
          } else {
            sc[i][0] = s4.x; sc[i][1] = s4.y; sc[i][2] = s4.z; sc[i][3] = s4.w;
          }
          cur_grow[i] = grow;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float lv = (float)((raw[i][j] >> (8 * c + s * bits)) & mask);
          float val = __fmul_rn(__fsub_rn(lv, zpv[i][c]), sc[i][c]);
          if (A8) val = fminf(fmaxf(rintf(val), -127.f), 127.f);
          v[j][c] = valid ? val : 0.f;
        }
        ++rem;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t word;
        if (A8) {
          word = ((uint32_t)(int)v[0][c] & 0xffu) |
                 (((uint32_t)(int)v[1][c] & 0xffu) << 8) |
                 (((uint32_t)(int)v[2 % RPW][c] & 0xffu) << 16) |
                 (((uint32_t)(int)v[3 % RPW][c] & 0xffu) << 24);
        } else {
          word = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0][c])) |
                 ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1][c]))
                  << 16);
        }
        Bs[(cw * 4 + c) * kRowWords + rq] = word;
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
      const float s_m = A8 ? p.sx[m] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n >= N) continue;
          float y = (float)acc[i][j][half * 2 + e];
          if (A8) y = __fmul_rn(__fmul_rn(y, s_m), p.cs[n]);
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

template <bool A8>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  // small M: 64-row tiles put more blocks on the card
  if (p.M <= 256) {
    dim3 grid((p.N + BN - 1) / BN, (p.M + 63) / 64);
    packed_gemm_kernel<A8, 64><<<grid, kThreads, 0, stream>>>(p);
  } else {
    dim3 grid((p.N + BN - 1) / BN, (p.M + 127) / 128);
    packed_gemm_kernel<A8, 128><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[M, N] = epilogue(x[M, K] @ dequant(w)). a8 = 0: x is bf16, sx and cs
// are unused; a8 = 1: x is int8 with per-row scales sx[M] and the column
// grid cs[N]. Needs N % 4 == 0 and Kp = K * bits / 8 a multiple of 8 (a8 = 0)
// or 16 (a8 = 1); all pointers 16-byte aligned.
int dlm_packed_gemm(const void* x, const void* sx, const void* w,
                    const void* scale, const void* zp, const void* cs,
                    const void* bias, int gelu, void* out, int out_bf16,
                    int a8, int M, int N, int K, int bits, int group_size,
                    void* stream) {
  if (M <= 0) return 0;
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
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(a8 ? launch<true>(p, s) : launch<false>(p, s));
}

}  // extern "C"
