// Fused-QKV bidirectional attention for Hopper (sm_90a): all heads read
// straight from the [B, S, 3D] projection.
//
// Replaces the TPU kernel `_qkv_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py, behind `fused_qkv_attention`). Per (batch row, head):
//   logits = (q . k) * sm_scale              f32, over all S keys
//   m = rowmax(logits); p = exp(logits - m); p = p / rowsum(p)   (IEEE /)
//   out = bf16(p) . v                        bf16 operands, f32 sum
// The row is normalised BEFORE P is rounded to bf16. An online softmax
// rounds bf16(p) against running maxima instead and gives other numbers,
// so this is not a flash kernel. The TPU kernel holds the whole [S, S]
// logit matrix in VMEM; a block here cannot (64 rows at S = 864 alone take
// 221 KB of its 227), so it walks the keys three times and keeps only
// registers between walks: pass 1 takes each row's exact maximum, pass 2
// the sum of exp(logit - max), pass 3 computes p = exp(logit - max) / sum,
// rounds it to bf16 in registers as the A fragments of P.V, and multiplies
// by the value tile. Each pass recomputes the logits of a 64-key tile with
// mma.sync m16n8k16 bf16, so QK^T runs three times; in exchange a block
// needs 27 KB of shared memory at any S and many blocks share an SM.
// One block per (64-query tile, head, batch row); 4 warps own 16 query
// rows each. q, k and v tiles are read from the strided projection in
// 16-byte loads (no head transposes, the point of the kernel), zero-padded
// to 64 keys and 64-wide head-dimension chunks; a head wider than 64 walks
// its chunks (and, for P.V, recomputes P once per output chunk).
//
// What bounds it on an H100: at the sampler's shape (B = 8, S = 256,
// D = 768, 12 heads of 64) the function reads the 9.4 MB projection and
// writes the 3.1 MB output while doing 1.6 GFLOP, so it is bound by bytes
// (0.0038 ms); the three passes read each key tile three times, from L2.
// wgmma and a TMA pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kKT = 64;                 // keys per tile
constexpr int kHC = 64;                 // head-dimension chunk
constexpr int kThreads = 128;           // 4 warps x 16 query rows
constexpr int kTileStride = kHC + 8;    // padded bf16 row of a q/k/v tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + 64) and head-dimension columns [c0, c0 + 64) of one head's
// q, k or v (`src` points at the head's column 0 of sequence row 0; rows
// are `row_stride` elements apart) into a padded tile; zero past S and Hd.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int row_stride, int S, int Hd,
                                          int r0, int c0, __nv_bfloat16* tile) {
  for (int i = threadIdx.x; i < 64 * (kHC / 8); i += kThreads) {
    const int r = i / (kHC / 8), c = (i % (kHC / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S && c0 + c < Hd)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * row_stride +
                                          c0 + c);
    *reinterpret_cast<uint4*>(tile + r * kTileStride + c) = v;
  }
}

struct Head {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int row_stride, S, Hd, q0, chunks;
  float sm_scale;
};

// s = (q . k) * sm_scale for this warp's 16 rows and the 64 keys at kv0;
// keys past S get -inf. A thread holds rows g (e = 0, 1) and g + 8 (e = 2,
// 3) of columns j * 8 + t * 2 + {0, 1}.
__device__ __forceinline__ void logits_tile(const Head& hd, int kv0,
                                            __nv_bfloat16* Qs,
                                            __nv_bfloat16* Ks,
                                            float (&s)[kKT / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int c = 0; c < hd.chunks; ++c) {
    __syncthreads();
    if (hd.chunks > 1)  // one chunk: Q was loaded once, before the passes
      load_tile(hd.q, hd.row_stride, hd.S, hd.Hd, hd.q0, c * kHC, Qs);
    load_tile(hd.k, hd.row_stride, hd.S, hd.Hd, kv0, c * kHC, Ks);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kHC / 16; ++d) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * kTileStride + d * 16 + t * 2;
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(qa),
          *reinterpret_cast<const uint32_t*>(qa + 8 * kTileStride),
          *reinterpret_cast<const uint32_t*>(qa + 8),
          *reinterpret_cast<const uint32_t*>(qa + 8 * kTileStride + 8)};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * kTileStride + d * 16 + t * 2;
        mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = kv0 + j * 8 + t * 2 + (e & 1) < hd.S
                    ? __fmul_rn(s[j][e], hd.sm_scale)
                    : -INFINITY;
}

__global__ void __launch_bounds__(kThreads)
    fused_qkv_kernel(const __nv_bfloat16* __restrict__ qkv, void* out,
                     int out_bf16, int S, int H, int Hd, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ * kTileStride];
  __shared__ __align__(16) __nv_bfloat16 Ks[kKT * kTileStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kKT * kTileStride];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * Hd, row_stride = 3 * D;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * Hd;
  const Head hd{base, base + D, base + 2 * D, row_stride, S, Hd, q0,
                (Hd + kHC - 1) / kHC, sm_scale};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (hd.chunks == 1) load_tile(hd.q, row_stride, S, Hd, q0, 0, Qs);

  float s[kKT / 8][4];
  // 1. the exact row maximum over all S keys (order does not matter)
  float m[2] = {-INFINITY, -INFINITY};
  for (int kv0 = 0; kv0 < S; kv0 += kKT) {
    logits_tile(hd, kv0, Qs, Ks, s);
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // 2. the row sum of exp(logit - max)
  float l[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < S; kv0 += kKT) {
    logits_tile(hd, kv0, Qs, Ks, s);
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[j][e] - m[e >> 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // 3. out = bf16(exp(logit - max) / sum) . v, 64 output columns at a time
  for (int c = 0; c < hd.chunks; ++c) {
    float o[kHC / 8][4];
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kv0 = 0; kv0 < S; kv0 += kKT) {
      logits_tile(hd, kv0, Qs, Ks, s);
      uint32_t pf[kKT / 16][4];  // P as bf16 A fragments
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pf[j >> 1][(j & 1) * 2 + r] =
              pack_bf16(__fdiv_rn(expf(s[j][r * 2] - m[r]), l[r]),
                        __fdiv_rn(expf(s[j][r * 2 + 1] - m[r]), l[r]));
      __syncthreads();
      load_tile(hd.v, row_stride, S, Hd, kv0, c * kHC, Vs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
#pragma unroll
        for (int dj = 0; dj < kHC / 16; ++dj) {
          const int mi = lane >> 3, rr = lane & 7;
          const __nv_bfloat16* addr = Vs + (kk * 16 + rr + (mi & 1) * 8) * kTileStride +
                                      dj * 16 + (mi >> 1) * 8;
          const uint32_t saddr =
              static_cast<uint32_t>(__cvta_generic_to_shared(addr));
          uint32_t b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(saddr)
              : "memory");
          mma_bf16(o[dj * 2], pf[kk], b0, b1);
          mma_bf16(o[dj * 2 + 1], pf[kk], b2, b3);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + r * 8;
      if (row >= S) continue;
      const size_t orow = ((size_t)b * S + row) * D + h * Hd;
#pragma unroll
      for (int j = 0; j < kHC / 8; ++j) {
        const int col = c * kHC + j * 8 + t * 2;  // even; Hd % 8 == 0
        if (col >= Hd) continue;
        const float y0 = o[j][r * 2], y1 = o[j][r * 2 + 1];
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + orow + col) =
              __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + orow + col) =
              make_float2(y0, y1);
      }
    }
  }
}

}  // namespace

extern "C" {

// qkv [B, S, 3 * H * Hd] bf16 (16-byte aligned) -> out [B, S, H * Hd],
// bf16 (out_bf16 = 1) or f32. Hd % 8 == 0 (else cudaErrorInvalidValue).
int dlm_fused_qkv_attention(const void* qkv, void* out, int out_bf16, int B,
                            int S, int H, int Hd, float sm_scale,
                            void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hd <= 0 || Hd % 8 || H <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fused_qkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, out_bf16, S, H, Hd,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
