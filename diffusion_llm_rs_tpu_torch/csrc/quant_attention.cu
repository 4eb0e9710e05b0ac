// Flash attention over contiguous per-token-quantized K/V, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py, behind `attention`), the kernel of the phase-aware
// cached sampler: q [BH, Sq, D] bf16 attends over K and V stored as packed
// 8/4/2/1-bit levels with one f32 scale and zero-point per (bh, token), and
// the packed bytes are never dequantized into device memory. Head widths D =
// 32, 64 and 128 are template parameters.
//
// Layout (`QuantKV`): data uint8 [BH, Skv, D/vpb], block-packed along D: byte
// (s, c) holds the level of channel c + p*(D/vpb) in bit field p (vpb = 8 /
// bits); scale and zero-point f32 [BH, Skv].
//
// One block per (64-query tile, bh); 4 warps own 16 query rows each. KV tiles
// of 64 tokens: each thread reads 8 packed bytes of a row (4 where a packed
// row is 4 bytes: D = 32 at 1 bit) and writes their vpb groups of levels as
// bf16 (levels 0..255 are exact in bf16) into the
// [token][d] tiles in shared memory, QK^T and PV run on mma.sync m16n8k16
// bf16 with f32 sums, and the running max, sum and accumulator stay in
// registers. The affine terms never touch the levels; as in the TPU kernel
// they are row corrections:
//   qsum   = sum_d bf16(q)                                  f32
//   logits = (raw * ks - qsum * (ks * kz)) * sm_scale       f32
//   m' = max(m, rowmax(logits)); p = exp(logits - m'); a = exp(m - m')
//   l   = l * a + rowsum(p)
//   acc = acc * a + bf16(p * vs) . v_lv - sum_t (p * vs) * vz
//   out = acc / l                                           f32
// Tokens past Skv get logits of -1e30; query rows past Sq are not written, so
// every Sq >= 1 and Skv >= 1 is served (the TPU wrapper leaves ragged shapes
// to XLA). The online softmax walks tiles of 64 tokens where the TPU's are
// 128 to 512: the running max under bf16(p * vs) differs, the math does not.
//
// What bounds it on an H100: at the sampler's shape (BH = 96, Sq = Skv = 256,
// 4 bits) the call moves about 11 MB (q, packed K and V, four sidecars, the
// f32 output) for 1.6 GFLOP, so bytes bound it (0.0034 ms); at BH = 24, S =
// 1024 the bf16 tensor cores do (0.0065 ms). This first version re-unpacks
// each KV tile once per 64-query tile, on one shared-memory stage, with
// mma.sync; a ring of tiles and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;  // [BH, Sq, D]
  const uint8_t* k_data;   // [BH, Skv, D/vpb]
  const float* k_scale;    // [BH, Skv]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  float* out;              // [BH, Sq, D]
  int Sq, Skv;
  float sm;
};

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

// Unpack tokens [kv0, kv0 + 64) of one bh's packed rows into a [token][d]
// bf16 tile of levels; tokens past Skv are zero.
template <int BITS, int D>
__device__ __forceinline__ void unpack_tile(const uint8_t* __restrict__ data,
                                            int Skv, int kv0,
                                            __nv_bfloat16* tile) {
  constexpr int kVpb = 8 / BITS, kDp = D / kVpb, kMask = (1 << BITS) - 1;
  constexpr int kStride = D + 8;
  constexpr int kCb = kDp >= 8 ? 8 : kDp;  // bytes a thread reads: 8 or 4
  constexpr int kChunks = kDp / kCb;       // chunks per packed row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * kCb;
    uint2 w = make_uint2(0, 0);
    if (kv0 + r < Skv) {
      const uint8_t* src = data + (size_t)(kv0 + r) * kDp + col;
      if (kCb == 8)
        w = *reinterpret_cast<const uint2*>(src);
      else
        w.x = *reinterpret_cast<const uint32_t*>(src);
    }
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
    for (int p = 0; p < kVpb; ++p) {
      uint32_t lv[4];
#pragma unroll
      for (int i = 0; i < kCb / 2; ++i)
        lv[i] = pack_bf16((float)((b[2 * i] >> (p * BITS)) & kMask),
                          (float)((b[2 * i + 1] >> (p * BITS)) & kMask));
      __nv_bfloat16* dst = tile + r * kStride + p * kDp + col;
      if (kCb == 8)
        *reinterpret_cast<uint4*>(dst) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(lv[0], lv[1]);
    }
  }
}

template <int D>
struct QaShape {
  static constexpr int kStride = D + 8;  // padded rows: conflict-free frags
  static constexpr int kTile = kBQ * kStride * 2;  // bytes of one bf16 tile
  // Q, K and V tiles, then per token of the KV tile: logit scale and offset,
  // V scale, V zero-point; per query row: the channel sum
  static constexpr int kSmem = 3 * kTile + (4 * kBK + kBQ) * 4;
};

template <int BITS, int D>
__global__ void __launch_bounds__(kThreads)
    quant_attention_kernel(const Args a) {
  using Sh = QaShape<D>;
  constexpr int kD = D, kStride = Sh::kStride;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kTile);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * Sh::kTile);
  float* s_ka = reinterpret_cast<float*>(smem + 3 * Sh::kTile);
  float* s_kb = s_ka + kBK;
  float* s_vs = s_kb + kBK;
  float* s_vz = s_vs + kBK;
  float* s_qsum = s_vz + kBK;
  constexpr int kDp = kD / (8 / BITS);

  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y;
  const int Sq = a.Sq, Skv = a.Skv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // q tile (rows past Sq are zero) and each row's channel sum in f32
  const __nv_bfloat16* qb = a.q + (size_t)bh * Sq * kD;
  for (int c = threadIdx.x; c < kBQ * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * kD + col);
    *reinterpret_cast<uint4*>(Qs + r * kStride + col) = v;
  }
  __syncthreads();
  if (threadIdx.x < kBQ) {
    float s = 0.f;
    for (int d = 0; d < kD; ++d)
      s += __bfloat162float(Qs[threadIdx.x * kStride + d]);
    s_qsum[threadIdx.x] = s;
  }
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int d = 0; d < kD / 16; ++d) {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * kStride + d * 16 + t * 2;
    qf[d][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[d][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qf[d][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[d][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
  __syncthreads();
  const float qs[2] = {s_qsum[warp * 16 + g], s_qsum[warp * 16 + g + 8]};

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const size_t side = (size_t)bh * Skv;
  const uint8_t* kd = a.k_data + side * kDp;
  const uint8_t* vd = a.v_data + side * kDp;
  for (int kv0 = 0; kv0 < Skv; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBK; i += kThreads) {
      const bool ok = kv0 + i < Skv;
      const float ks = ok ? a.k_scale[side + kv0 + i] : 0.f;
      const float kz = ok ? a.k_zp[side + kv0 + i] : 0.f;
      s_ka[i] = ks;
      s_kb[i] = __fmul_rn(ks, kz);
      s_vs[i] = ok ? a.v_scale[side + kv0 + i] : 0.f;
      s_vz[i] = ok ? a.v_zp[side + kv0 + i] : 0.f;
    }
    unpack_tile<BITS, D>(kd, Skv, kv0, Ks);
    unpack_tile<BITS, D>(vd, Skv, kv0, Vs);
    __syncthreads();

    // raw = q . k_lv for 16 rows x 64 tokens
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int d = 0; d < kD / 16; ++d) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * kStride + d * 16 + t * 2;
        mma_bf16(s[n], qf[d], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // logits and online softmax; thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3), columns n*8 + t*2 + {0, 1}
    float m_new[2], alpha[2], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + t * 2 + e;
          float x = __fmul_rn(__fsub_rn(__fmul_rn(s[n][r * 2 + e], s_ka[col]),
                                        __fmul_rn(qs[r], s_kb[col])),
                              a.sm);
          x = kv0 + col < Skv ? x : kNegInf;
          s[n][r * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[r] = mx;
      alpha[r] = expf(m_run[r] - mx);
    }
    uint32_t pf[kBK / 16][4];  // bf16(p * vs) as A fragments
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = n * 8 + t * 2;
        const float p0 = expf(s[n][r * 2] - m_new[r]);
        const float p1 = expf(s[n][r * 2 + 1] - m_new[r]);
        rsum[r] += p0 + p1;
        const float w0 = __fmul_rn(p0, s_vs[col]);
        const float w1 = __fmul_rn(p1, s_vs[col + 1]);
        csum[r] += __fmul_rn(w0, s_vz[col]) + __fmul_rn(w1, s_vz[col + 1]);
        pf[n >> 1][(n & 1) * 2 + r] = pack_bf16(w0, w1);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      csum[r] += __shfl_xor_sync(0xffffffffu, csum[r], 1);
      csum[r] += __shfl_xor_sync(0xffffffffu, csum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
      m_run[r] = m_new[r];
    }
    // acc = acc * alpha + pv - corr, with pv summed on top by the mma below
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] = __fsub_rn(__fmul_rn(o[j][0], alpha[0]), csum[0]);
      o[j][1] = __fsub_rn(__fmul_rn(o[j][1], alpha[0]), csum[0]);
      o[j][2] = __fsub_rn(__fmul_rn(o[j][2], alpha[1]), csum[1]);
      o[j][3] = __fsub_rn(__fmul_rn(o[j][3], alpha[1]), csum[1]);
    }

    // o += P . V: k = token (16 per step), n = d (8 per tile); V^T fragments
    // via ldmatrix.trans from the [token][d] tile, two d-tiles per x4 load
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dj = 0; dj < kD / 16; ++dj) {
        const int mi = lane >> 3, rr = lane & 7;
        const __nv_bfloat16* addr =
            Vs + (kk * 16 + rr + (mi & 1) * 8) * kStride + dj * 16 + (mi >> 1) * 8;
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
    if (row >= Sq) continue;
    const float l = l_run[r];
    float* orow = a.out + ((size_t)bh * Sq + row) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8 + t * 2) =
          make_float2(__fdiv_rn(o[j][r * 2], l), __fdiv_rn(o[j][r * 2 + 1], l));
  }
}

template <int BITS, int D>
int launch(const Args& a, int BH, cudaStream_t st) {
  auto kernel = quant_attention_kernel<BITS, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QaShape<D>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, QaShape<D>::kSmem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bits(const Args& a, int BH, int bits, cudaStream_t st) {
  switch (bits) {
    case 8: return launch<8, D>(a, BH, st);
    case 4: return launch<4, D>(a, BH, st);
    case 2: return launch<2, D>(a, BH, st);
    case 1: return launch<1, D>(a, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [BH, Sq, D] bf16; k_data, v_data uint8 [BH, Skv, D * bits / 8];
// k_scale, k_zp, v_scale, v_zp f32 [BH, Skv]; D = 32, 64 or 128; bits 1, 2,
// 4 or 8; Sq, Skv >= 1. Writes out f32 [BH, Sq, D]. Returns
// cudaErrorInvalidValue for a shape it was not built for.
int dlm_quant_attention(const void* q, const void* k_data, const void* k_scale,
                        const void* k_zp, const void* v_data,
                        const void* v_scale, const void* v_zp, void* out,
                        int BH, int Sq, int Skv, int D, int bits,
                        float sm_scale, void* stream) {
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const uint8_t*>(k_data),
         static_cast<const float*>(k_scale),
         static_cast<const float*>(k_zp),
         static_cast<const uint8_t*>(v_data),
         static_cast<const float*>(v_scale),
         static_cast<const float*>(v_zp),
         static_cast<float*>(out),
         Sq, Skv, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bits<32>(a, BH, bits, st);
    case 64: return launch_bits<64>(a, BH, bits, st);
    case 128: return launch_bits<128>(a, BH, bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
