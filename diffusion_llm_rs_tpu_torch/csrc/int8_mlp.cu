// Fused decoded-int8 MLP block for Hopper (sm_90a): the [16, F] inner
// activation of a 16-row tile never leaves the SM.
//
// Replaces the TPU kernel `_kernel_i8_mlp` (diffusion_llm_rs_tpu/ops/
// pallas_matmul.py, behind `int8w_mlp`):
//   xi, sx = quant_rows(x)                 x bf16 [M, K]
//   inner  = gelu(xi @ w1 * sx * cs1 + b1) f32 [M, F], kept on chip
//   yi, sy = quant_rows(inner)             amax over the whole inner row
//   out    = yi @ w2 * sy * cs2 + b2 (+ r) [M, N]
// The whole inner row must exist before it is requantized, so no column
// tile of the second product can start before every column of the first is
// done: one block owns 16 rows end to end. Its dynamic shared memory holds
// the f32 inner tile ([16][F + 4], 196,864 bytes at F = 3072), the x tile's
// int8 levels and one staged weight tile; the levels of the inner tile are
// computed into registers and written over it once every thread has read
// its values. Both products run mma.sync m16n8k32 s8 from shared memory,
// 256 output columns at a time (8 warps x 32), K staged 64 deep with the
// next weight tile's loads in registers, as in int8_gemm.cu. The rounding
// steps come from int8_common.cuh, so the result equals the chained
// kernels (quant_rows, gemm, quant_rows, gemm) bit for bit.
//
// What bounds it on an H100: at the sampler's shape (M = 2048, 768 -> 3072
// -> 768) the block does 19.3 GOP of int8 products over ~9 MB of inputs and
// outputs, so the tensor cores bound it (0.0098 ms). This simple version
// gives 128 blocks for 132 SMs, one block an SM (230 KB of shared memory),
// and every block streams both weights (4.7 MB) from L2, 16 KB a tile: with
// one block an SM, the loads one SM keeps in flight, not the products or
// the L2's total bandwidth, set the pace (on an H100 the kernel takes as
// long at M = 512 as at 2048, and deeper register prefetch did not help).
// Clusters sharing weight tiles through distributed shared memory or TMA
// multicast, so each block streams a fraction of the weights for more rows,
// and wgmma, are later work.
// An inner row wider than kMaxInner goes to the chained kernels (the Python
// wrapper dispatches on shape and counts those launches apart).

#include "int8_common.cuh"

namespace {

using namespace dlm_int8;

constexpr int kTM = 16;          // rows of x per block
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 256;         // output columns per pass: 8 warps x 32
constexpr int kBK = 64;          // k per staged weight tile
constexpr int kBRowBytes = kBK + 16;  // padded [n][k] row: conflict-free frags
constexpr int kBRowWords = kBRowBytes / 4;
constexpr int kMaxQuads = 48;    // inner 4-level groups a thread requantizes
constexpr int kMaxInner = kMaxQuads * 4 * kThreads / kTM;  // 3072
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one sm_90 block

__host__ __device__ constexpr int inner_stride(int F) { return F + 4; }    // f32
__host__ __device__ constexpr int level_stride(int F) { return F + 16; }   // int8
__host__ __device__ constexpr int x_stride(int K) { return K + 16; }       // int8

__host__ __device__ constexpr size_t smem_bytes(int K, int F) {
  return (size_t)kTM * inner_stride(F) * 4 + (size_t)kTM * x_stride(K) +
         (size_t)kBN * kBRowBytes + 2 * kTM * sizeof(float);
}

// The weight tile for columns [n0, n0 + 256) and k [k0, k0 + 64): 1,024
// blocks of 4 (k) x 4 (n) bytes, four a thread; zero past K or N.
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int N,
                                       int K, int n0, int k0,
                                       uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int blk = threadIdx.x + i * kThreads;
    int kb = blk >> 6, nb = blk & 63;
    int k = k0 + kb * 4, n = n0 + nb * 4;
    bool ok = k < K && n < N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[i][j] = ok ? *reinterpret_cast<const uint32_t*>(
                         w + (size_t)(k + j) * N + n)
                   : 0u;
  }
}

__device__ __forceinline__ void store_w(const uint32_t (&r)[4][4],
                                        uint32_t* Bs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int blk = threadIdx.x + i * kThreads;
    int kb = blk >> 6, nb = blk & 63;
    store_transposed(r[i], Bs + (nb * 4) * kBRowWords + (kb ^ swizzle(nb * 4)),
                     kBRowWords);
  }
}

// Two k32 steps of this warp's 16 rows x 32 columns from the staged tile.
__device__ __forceinline__ void mma_tile(const uint32_t* As, int a_words,
                                         int k0, const uint32_t* Bs,
                                         int (&acc)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK / 4; ks += 8) {  // in words
    uint32_t a[4];
    const uint32_t* abase = As + g * a_words + k0 / 4 + ks + t;
    a[0] = abase[0];
    a[1] = abase[8 * a_words];
    a[2] = abase[4];
    a[3] = abase[8 * a_words + 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = warp * 32 + j * 8 + g;
      const uint32_t* b = Bs + n * kBRowWords;
      mma_s8(acc[j], a, b[(ks + t) ^ swizzle(n)], b[(ks + t + 4) ^ swizzle(n)]);
    }
  }
}

// acc = this warp's 16 rows x 32 columns [n0 + warp * 32, + 32) of
// A (16 int8 rows in shared memory, `a_words` 32-bit words apart) @ w[K, N],
// the next weight tile's loads in registers while this one is multiplied.
// Columns of A past K meet zero weights, so a partial last k tile adds 0.
__device__ __forceinline__ void gemm_rows16(const uint32_t* As, int a_words,
                                            const int8_t* __restrict__ w,
                                            int N, int K, int n0,
                                            uint32_t* Bs, int (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  uint32_t regs[4][4];
  load_w(w, N, K, n0, 0, regs);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    store_w(regs, Bs);
    __syncthreads();
    if (k0 + kBK < K) load_w(w, N, K, n0, k0 + kBK, regs);
    mma_tile(As, a_words, k0, Bs, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
    int8_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w1, const float* __restrict__ cs1,
                    const float* __restrict__ b1,
                    const int8_t* __restrict__ w2, const float* __restrict__ cs2,
                    const float* __restrict__ b2,
                    const __nv_bfloat16* __restrict__ residual, void* out,
                    int out_bf16, int M, int K, int F, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* inner = reinterpret_cast<float*>(smem);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + (size_t)kTM * inner_stride(F) * 4);
  uint32_t* Bs = reinterpret_cast<uint32_t*>(xs + kTM * x_stride(K));
  float* sx = reinterpret_cast<float*>(Bs + kBN * kBRowWords);
  float* sy = sx + kTM;

  const int m0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. quantize the tile's x rows (warp w: rows 2w, 2w + 1); rows past M
  //    are zero with scale 1
#pragma unroll
  for (int rr = 0; rr < kTM / kWarps; ++rr) {
    const int r = warp * (kTM / kWarps) + rr, m = m0 + r;
    const __nv_bfloat16* xr = x + (size_t)m * K;
    float amax = 0.f;
    if (m < M)
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = row_scale(amax);
    if (lane == 0) sx[r] = s;
    for (int k = lane; k < K; k += 32)
      xs[r * x_stride(K) + k] =
          m < M ? quant_level(__bfloat162float(xr[k]), s) : (int8_t)0;
  }
  __syncthreads();

  // 2. inner = gelu(xi @ w1 * sx * cs1 + b1), f32, into shared memory
  int acc[4][4];
  for (int n0 = 0; n0 < F; n0 += kBN) {
    gemm_rows16(reinterpret_cast<const uint32_t*>(xs), x_stride(K) / 4, w1,
                F, K, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = g + half * 8, n = n0 + warp * 32 + j * 8 + t * 2 + e;
          if (n < F)
            inner[r * inner_stride(F) + n] =
                epilogue(acc[j][half * 2 + e], sx[r], cs1[n], b1, n, 1);
        }
  }
  __syncthreads();

  // 3. requantize each inner row over all F columns: amax, then the levels
  //    into registers; once every thread has read its values, the levels
  //    overwrite the f32 tile as int8 rows of level_stride(F) bytes
#pragma unroll
  for (int rr = 0; rr < kTM / kWarps; ++rr) {
    const int r = warp * (kTM / kWarps) + rr;
    float amax = 0.f;
    for (int c = lane; c < F; c += 32)
      amax = fmaxf(amax, fabsf(inner[r * inner_stride(F) + c]));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) sy[r] = row_scale(amax);
  }
  __syncthreads();
  const int quads = kTM * F / 4;
  uint32_t lv[kMaxQuads];
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = threadIdx.x + i * kThreads;
    lv[i] = 0u;
    if (q < quads) {
      const int r = q * 4 / F, c = q * 4 - r * F;
      const float4 v =
          *reinterpret_cast<const float4*>(inner + r * inner_stride(F) + c);
      const float s = sy[r];
      lv[i] = (uint32_t)(uint8_t)quant_level(v.x, s) |
              ((uint32_t)(uint8_t)quant_level(v.y, s) << 8) |
              ((uint32_t)(uint8_t)quant_level(v.z, s) << 16) |
              ((uint32_t)(uint8_t)quant_level(v.w, s) << 24);
    }
  }
  __syncthreads();
  int8_t* levels = reinterpret_cast<int8_t*>(smem);
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (q < quads) {
      const int r = q * 4 / F, c = q * 4 - r * F;
      *reinterpret_cast<uint32_t*>(levels + r * level_stride(F) + c) = lv[i];
    }
  }
  __syncthreads();

  // 4. out = yi @ w2 * sy * cs2 + b2 (+ residual)
  for (int n0 = 0; n0 < N; n0 += kBN) {
    gemm_rows16(reinterpret_cast<const uint32_t*>(levels), level_stride(F) / 4,
                w2, N, F, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = g + half * 8, m = m0 + r;
          const int n = n0 + warp * 32 + j * 8 + t * 2 + e;
          if (m >= M || n >= N) continue;
          float y = epilogue(acc[j][half * 2 + e], sy[r], cs2[n], b2, n, 0);
          const size_t o = (size_t)m * N + n;
          if (residual) y = __fadd_rn(y, __bfloat162float(residual[o]));
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(out)[o] = y;
        }
  }
}

}  // namespace

extern "C" {

// The dynamic shared memory the fused kernel needs at widths K -> F, or 0
// when the inner row does not fit (the caller then chains the two GEMMs).
int dlm_int8_mlp_smem(int K, int F) {
  if (F > kMaxInner) return 0;
  size_t bytes = smem_bytes(K, F);
  return bytes <= (size_t)kSmemLimit ? (int)bytes : 0;
}

// out[M, N] = MLP(x[M, K]) over int8 w1 [K, F] and w2 [F, N], bf16 x and
// residual, f32 column scales and biases (either bias may be null); out is
// bf16 (out_bf16 = 1) or f32. K % 16 == 0, F % 16 == 0, N % 4 == 0, and
// dlm_int8_mlp_smem(K, F) > 0 (else cudaErrorInvalidValue).
int dlm_int8_mlp(const void* x, const void* w1, const void* cs1,
                 const void* b1, const void* w2, const void* cs2,
                 const void* b2, const void* residual, void* out, int out_bf16,
                 int M, int K, int F, int N, void* stream) {
  if (M <= 0) return 0;
  const int bytes = dlm_int8_mlp_smem(K, F);
  if (bytes == 0 || K % 16 || F % 16 || N % 4) return (int)cudaErrorInvalidValue;
  static int opted_in = 0;  // the largest size asked for so far
  if (bytes > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  int8_mlp_kernel<<<(M + kTM - 1) / kTM, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(cs1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(cs2),
      static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(residual), out, out_bf16, M, K, F, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
