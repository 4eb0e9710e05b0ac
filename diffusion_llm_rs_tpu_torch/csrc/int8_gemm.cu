// Decoded-int8 linear layer for Hopper (sm_90a): per-row activation
// quantization and an int8 x int8 -> int32 tensor-core GEMM with a fused
// f32 epilogue.
//
// Replaces the TPU kernel `_kernel_i8w` (diffusion_llm_rs_tpu/ops/
// pallas_matmul.py, behind `int8w_matmul`). The Python wrappers in
// diffusion_llm_rs_tpu_torch/ops/int8_matmul.py chain the two kernels below:
//   int8w_matmul       = quant_rows(x) -> gemm(w, epilogue: *sx*cs + b,
//                        gelu, +r)
//   int8w_mlp_chained  = quant_rows(x) -> gemm(w1, +b1, gelu, f32 out)
//                        -> quant_rows(inner) -> gemm(w2, +b2, +r)
// which is the arithmetic of the TPU kernels step for step. The chained MLP
// serves only widths the fused kernel of int8_mlp.cu (`_kernel_i8_mlp`)
// does not take; that kernel keeps the inner activation of 64 rows on the
// SMs of a thread-block cluster and equals this chain bit for bit: both
// take their arithmetic from int8_common.cuh.
//
// What bounds it on an H100: at the sampler's M = 2048 (B=8 x S=256) the
// MLP pair is int8 tensor-core bound (19.3 GOP over ~14 MB); the single
// linears sit at the ridge, where the bf16 output stream weighs about as
// much as the int8 products (chip_smoke.py computes both bounds per shape).
// This first version is a plain mma.sync tile loop: 128x128 output tiles,
// 8 warps of 64x32, K staged 64 at a time through shared memory, the next
// tile's global loads in registers while the current one is multiplied.
// The weight tile is transposed 4x4 bytes at a time with byte permutes on
// its way into shared memory, so B fragments are single 32-bit loads, its
// words swizzled so neither the stores nor the loads meet in a bank.
// wgmma, TMA and a deeper pipeline are later work.
//
// Arithmetic contract (mirrors the TPU kernels and the plain twins):
//   amax = max |x[m, :]|  (x as given: bf16 for layer inputs, f32 for the
//                          MLP inner activation)
//   sx   = amax > 0 ? amax / 127 : 1;   xi = rint(x / sx)  (half to even)
//   y    = ((float)acc * sx[m]) * cs[n] (+ b[n]) (gelu_tanh) (+ r[m, n])
// every step rounded on its own (no fused multiply-add), as in f32 XLA.

#include "int8_common.cuh"

namespace {

using namespace dlm_int8;

constexpr int kQuantThreads = 256;

// One block per row: amax over the whole row, then the int8 levels.
template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ x, int K,
                                  int8_t* __restrict__ xi,
                                  float* __restrict__ sx) {
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  __shared__ float red[kQuantThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    amax = threadIdx.x < kQuantThreads / 32 ? red[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (threadIdx.x == 0) red[0] = amax;
  }
  __syncthreads();
  amax = red[0];
  const float s = row_scale(amax);
  if (threadIdx.x == 0) sx[row] = s;
  int8_t* out = xi + (size_t)row * K;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    out[k] = quant_level(to_f32(xr[k]), s);
}

// ---------------------------------------------------------------- GEMM ---

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kGemmThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kRowBytes = BK + 16;  // padded smem row: conflict-free frags
constexpr int kRowWords = kRowBytes / 4;

struct Epilogue {
  const float* sx;        // [M]
  const float* cs;        // [N]
  const float* bias;      // [N] or null
  const __nv_bfloat16* residual;  // [M, N] bf16 or null
  int gelu;
  void* out;              // [M, N]
  int out_bf16;           // out dtype: 1 = bf16, 0 = f32
};

// A tile: rows of xi, 16-byte chunks (K % 16 == 0). B tile: w is [K, N]
// row-major; each thread moves 4 (k) x 4 (n) byte blocks, transposed so
// shared memory holds it n-major ([n][k]), as the .col B operand wants.
struct TileRegs {
  uint4 a[2];
  uint32_t b[2][4];
};

__device__ __forceinline__ void load_tile(const int8_t* __restrict__ xi,
                                          const int8_t* __restrict__ w,
                                          int M, int N, int K, int m0, int n0,
                                          int k0, TileRegs& r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int c = tid + i * kGemmThreads;  // 512 chunks: 128 rows x 4
    int row = c >> 2, kc = (c & 3) * 16;
    int m = m0 + row, k = k0 + kc;
    r.a[i] = (m < M && k < K)
                 ? *reinterpret_cast<const uint4*>(xi + (size_t)m * K + k)
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int blk = tid + i * kGemmThreads;  // 512 blocks: 16 (k) x 32 (n)
    int kb = blk >> 5, nb = blk & 31;
    int k = k0 + kb * 4, n = n0 + nb * 4;
    bool ok = k < K && n < N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r.b[i][j] = ok ? *reinterpret_cast<const uint32_t*>(
                           w + (size_t)(k + j) * N + n)
                     : 0u;
  }
}

__device__ __forceinline__ void store_tile(const TileRegs& r,
                                           uint32_t* As, uint32_t* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int c = tid + i * kGemmThreads;
    int row = c >> 2, kc = (c & 3) * 16;
    *reinterpret_cast<uint4*>(reinterpret_cast<int8_t*>(As) +
                              row * kRowBytes + kc) = r.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int blk = tid + i * kGemmThreads;
    int kb = blk >> 5, nb = blk & 31;
    store_transposed(r.b[i], Bs + (nb * 4) * kRowWords + (kb ^ swizzle(nb * 4)),
                     kRowWords);
  }
}

__global__ void __launch_bounds__(kGemmThreads)
    int8_gemm_kernel(const int8_t* __restrict__ xi,
                     const int8_t* __restrict__ w, int M, int N, int K,
                     Epilogue ep) {
  __shared__ __align__(16) uint32_t As[BM * kRowWords];
  __shared__ __align__(16) uint32_t Bs[BN * kRowWords];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  TileRegs regs;
  load_tile(xi, w, M, N, K, m0, n0, 0, regs);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    store_tile(regs, As, Bs);
    __syncthreads();
    if (k0 + BK < K) load_tile(xi, w, M, N, K, m0, n0, k0 + BK, regs);
#pragma unroll
    for (int ks = 0; ks < BK / 4; ks += 8) {  // two k32 steps, in words
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* base = As + (wm + i * 16 + g) * kRowWords + ks + t;
        a[i][0] = base[0];
        a[i][1] = base[8 * kRowWords];
        a[i][2] = base[4];
        a[i][3] = base[8 * kRowWords + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        const uint32_t* base = Bs + n * kRowWords;
        uint32_t b0 = base[(ks + t) ^ swizzle(n)];
        uint32_t b1 = base[(ks + t + 4) ^ swizzle(n)];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float s_m = ep.sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n >= N) continue;
          float y = epilogue(acc[i][j][half * 2 + e], s_m, ep.cs[n], ep.bias,
                             n, ep.gelu);
          const size_t o = (size_t)m * N + n;
          if (ep.residual) y = __fadd_rn(y, __bfloat162float(ep.residual[o]));
          if (ep.out_bf16)
            static_cast<__nv_bfloat16*>(ep.out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(ep.out)[o] = y;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: [M, K] bf16 (x_bf16 = 1) or f32 (0) -> xi int8 [M, K], sx f32 [M].
int dlm_quant_rows(const void* x, int x_bf16, void* xi, void* sx, int M,
                   int K, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    quant_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), K, static_cast<int8_t*>(xi),
        static_cast<float*>(sx));
  else
    quant_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), K, static_cast<int8_t*>(xi),
        static_cast<float*>(sx));
  return (int)cudaGetLastError();
}

// out[M, N] = epilogue(xi[M, K] @ w[K, N]); K % 16 == 0, N % 4 == 0. The
// residual, when given, is bf16; out is bf16 (out_bf16 = 1) or f32 (the
// MLP's inner activation).
int dlm_int8_gemm(const void* xi, const void* w, const void* sx,
                  const void* cs, const void* bias, const void* residual,
                  int gelu, void* out, int out_bf16, int M, int N, int K,
                  void* stream) {
  if (M <= 0) return 0;
  Epilogue ep{static_cast<const float*>(sx), static_cast<const float*>(cs),
              static_cast<const float*>(bias),
              static_cast<const __nv_bfloat16*>(residual), gelu, out,
              out_bf16};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(w), M, N, K,
      ep);
  return (int)cudaGetLastError();
}

}  // extern "C"
