// Flash attention over one paged, quantized KV sequence, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` of diffusion_llm_rs_tpu/ops/
// pallas_paged_attention.py (:34, behind `paged_attention`, :140): one
// sequence's page chain, walked page by page, each page's packed K/V levels
// unpacked and an online softmax run over them. (The batched kernels are
// csrc/paged_unpack.cu and csrc/paged_flash.cuh.)
//
// Pools keep the JAX layout with head groups of one: data uint8 [n_slots,
// BH, P/vpb, D], token-block packed (byte (r, d) holds the levels of tokens
// r + p*P/vpb in bit field p); sidecars f32 [n_slots, BH, P]. Head widths D
// = 32, 64 and 128 are template parameters, and so is the tile's capacity of
// 32, 64 or 128 tokens; the page size P (any multiple of 8 up to 128) is not:
// the smallest tile that holds the page runs, and its 8-token blocks past P
// are skipped. A page that fills its tile (32, 64, 128) runs an instance
// whose loop bounds are all constant: the runtime bounds cost 7-12%.
//
// One block per (64-query tile, head); 4 warps own 16 query rows each. Per
// page: the packed K and V bytes of this head are unpacked into bf16 levels
// in shared memory (levels 0..255 are exact in bf16), the four sidecars of the
// page land beside them, QK^T and PV run on mma.sync m16n8k16 bf16 with f32
// sums, and the running max, sum and accumulator stay in registers. The TPU
// kernel's rounding points:
//   logits = (raw * ks - qsum * (ks * kz)) * sm, tokens >= page_tokens masked
//   acc = acc * alpha + bf16(p * vs) . v_lv - sum_t (p * vs) * vz
//   out = acc / l, lse = m + log(l)
// The products of both dots are exact (bf16 x bf16 in f32); sums run in
// another order than the TPU's and the twin's, and expf is CUDA's.
//
// What bounds it on an H100: at the PagedKVCache shape (BH = 12, Sq = 1024,
// 8 pages of 128, D = 64) the dots are 4*BH*Sq*Skv*D = 3.2 GFLOP, so the bf16
// tensor cores bound it (0.003 ms); it re-reads and re-unpacks each page once
// per 64-query tile (from L2), on one shared-memory stage, with mma.sync: one
// `attend` call is a few tens of microseconds, off every serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kThreads = 128, kPmax = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;  // [BH, Sq, D]
  const int* page_table;   // [n_pages]
  const int* page_tokens;  // [n_pages]
  const uint8_t* k_data;   // [n_slots, BH, P/vpb, D]
  const float* k_scale;    // [n_slots, BH, P]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  float* out;              // [BH, Sq, D]
  float* lse;              // [BH, Sq]
  int Sq, n_pages, n_slots, P;
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

// D: head width; PT: tokens the tiles hold (32, 64 or 128), the page size
// rounded up
template <int D, int PT>
struct PagedShape {
  static constexpr int kStride = D + 8;  // padded rows: conflict-free frags
  static constexpr int kQ = kBQ * kStride * 2, kKv = PT * kStride * 2;
  // Q, K and V tiles; per token of the page: logit scale and offset, V scale,
  // V correction; per query row: the channel sum
  static constexpr int kSmem = kQ + 2 * kKv + (4 * PT + kBQ) * 4;
};

template <int BITS, int D, int PT, bool kFull>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Args a) {
  using Sh = PagedShape<D, PT>;
  constexpr int kD = D, kStride = Sh::kStride;
  constexpr int kVpb = 8 / BITS, kMask = (1 << BITS) - 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kQ);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kQ + Sh::kKv);
  float* s_ka = reinterpret_cast<float*>(smem + Sh::kQ + 2 * Sh::kKv);
  float* s_kb = s_ka + PT;
  float* s_vs = s_kb + PT;
  float* s_vc = s_vs + PT;
  float* s_qsum = s_vc + PT;

  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y, BH = gridDim.y;
  // kFull: the page fills the tile, and every loop bound below is constant
  const int Sq = a.Sq, P = kFull ? PT : a.P;
  const int kPp = P / kVpb, P16 = (P + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // q tile (rows past Sq are zero) and each row's channel sum in f32
  const __nv_bfloat16* qb = a.q + bh * Sq * kD;
  for (int c = threadIdx.x; c < kBQ * (kD / 8); c += kThreads) {
    int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * kD + col);
    *reinterpret_cast<uint4*>(Qs + r * kStride + col) = v;
  }
  // token rows [P, P16) of the K and V tiles are read by the last 16-token
  // step: zero them once (pages never write there)
  for (int c = threadIdx.x; c < (P16 - P) * (kD / 8); c += kThreads) {
    const int r = P + c / (kD / 8), col = (c % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(Ks + r * kStride + col) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(Vs + r * kStride + col) = make_uint4(0, 0, 0, 0);
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

  for (int j = 0; j < a.n_pages; ++j) {
    const int slot = a.page_table[j], valid = a.page_tokens[j];
    if (slot < 0 || slot >= a.n_slots) __trap();
    const size_t side = ((size_t)slot * BH + bh) * P;
    const size_t base = ((size_t)slot * BH + bh) * kPp * kD;
    __syncthreads();  // every warp is done with the previous page
    // sidecars past P are 0: a masked token's p = 0 then adds 0, not NaN
    for (int i = threadIdx.x; i < PT; i += kThreads) {
      float ka = 0.f, kz = 0.f, vs = 0.f, vz = 0.f;
      if (i < P) {
        ka = a.k_scale[side + i];
        kz = a.k_zp[side + i];
        vs = a.v_scale[side + i];
        vz = a.v_zp[side + i];
      }
      s_ka[i] = ka;
      s_kb[i] = __fmul_rn(ka, kz);
      s_vs[i] = vs;
      s_vc[i] = vz;
    }
    // 16 packed bytes of one row -> 16 levels of kVpb token rows each
    for (int c = threadIdx.x; c < kPp * (kD / 16); c += kThreads) {
      const int r = c / (kD / 16), col = (c % (kD / 16)) * 16;
      const size_t off = base + (size_t)r * kD + col;
      const uint4 kw = *reinterpret_cast<const uint4*>(a.k_data + off);
      const uint4 vw = *reinterpret_cast<const uint4*>(a.v_data + off);
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kw);
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vw);
#pragma unroll
      for (int p = 0; p < kVpb; ++p) {
        const int tok = r + p * kPp;
        uint32_t kk[8], vv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float k0 = (float)((kb[2 * i] >> (p * BITS)) & kMask);
          const float k1 = (float)((kb[2 * i + 1] >> (p * BITS)) & kMask);
          const float v0 = (float)((vb[2 * i] >> (p * BITS)) & kMask);
          const float v1 = (float)((vb[2 * i + 1] >> (p * BITS)) & kMask);
          kk[i] = pack_bf16(k0, k1);
          vv[i] = pack_bf16(v0, v1);
        }
        uint4* kdst = reinterpret_cast<uint4*>(Ks + tok * kStride + col);
        uint4* vdst = reinterpret_cast<uint4*>(Vs + tok * kStride + col);
        kdst[0] = make_uint4(kk[0], kk[1], kk[2], kk[3]);
        kdst[1] = make_uint4(kk[4], kk[5], kk[6], kk[7]);
        vdst[0] = make_uint4(vv[0], vv[1], vv[2], vv[3]);
        vdst[1] = make_uint4(vv[4], vv[5], vv[6], vv[7]);
      }
    }
    __syncthreads();

    // raw = q . k_lv for 16 rows x the page's 8-token blocks
    float s[PT / 8][4];
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      if (n * 8 < P) {
#pragma unroll
        for (int d = 0; d < kD / 16; ++d) {
          const __nv_bfloat16* kp = Ks + (n * 8 + g) * kStride + d * 16 + t * 2;
          mma_bf16(s[n], qf[d], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
    }

    // logits and online softmax; thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3), columns n*8 + t*2 + {0, 1}; tokens past `valid` (and past
    // the page) get -1e30
    float m_new[2], alpha[2], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int n = 0; n < PT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + t * 2 + e;
          const float raw = s[n][r * 2 + e];
          float x = __fmul_rn(__fsub_rn(__fmul_rn(raw, s_ka[col]),
                                        __fmul_rn(qs[r], s_kb[col])),
                              a.sm);
          x = col < valid ? x : kNegInf;
          s[n][r * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[r] = mx;
      alpha[r] = expf(m_run[r] - mx);
    }
    // s becomes the P.V weights p * vs
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = n * 8 + t * 2;
        const float p0 = expf(s[n][r * 2] - m_new[r]);
        const float p1 = expf(s[n][r * 2 + 1] - m_new[r]);
        rsum[r] += p0 + p1;
        const float w0 = __fmul_rn(p0, s_vs[col]);
        const float w1 = __fmul_rn(p1, s_vs[col + 1]);
        csum[r] += __fmul_rn(w0, s_vc[col]) + __fmul_rn(w1, s_vc[col + 1]);
        s[n][r * 2] = w0;
        s[n][r * 2 + 1] = w1;
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
    for (int kk = 0; kk < PT / 16; ++kk) {
      if (kk * 16 >= P16) break;
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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
        mma_bf16(o[dj * 2], pf, b0, b1);
        mma_bf16(o[dj * 2 + 1], pf, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const float l = l_run[r];
    float* orow = a.out + (bh * Sq + row) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8 + t * 2) =
          make_float2(__fdiv_rn(o[j][r * 2], l), __fdiv_rn(o[j][r * 2 + 1], l));
    if (t == 0) a.lse[bh * Sq + row] = m_run[r] + logf(l);
  }
}

template <int BITS, int D, int PT, bool kFull>
int launch_one(const Args& a, int BH, cudaStream_t stream) {
  using Sh = PagedShape<D, PT>;
  auto kernel = paged_attention_kernel<BITS, D, PT, kFull>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, Sh::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, int D, int PT>
int launch_fill(const Args& a, int BH, cudaStream_t stream) {
  return a.P == PT ? launch_one<BITS, D, PT, true>(a, BH, stream)
                   : launch_one<BITS, D, PT, false>(a, BH, stream);
}

// the smallest tile of 32, 64 or 128 tokens that holds the page
template <int BITS, int D>
int launch_pt(const Args& a, int BH, cudaStream_t stream) {
  if (a.P <= 32) return launch_fill<BITS, D, 32>(a, BH, stream);
  if (a.P <= 64) return launch_fill<BITS, D, 64>(a, BH, stream);
  return launch_fill<BITS, D, 128>(a, BH, stream);
}

template <int D>
int launch_bits(const Args& a, int BH, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_pt<1, D>(a, BH, stream);
    case 2: return launch_pt<2, D>(a, BH, stream);
    case 4: return launch_pt<4, D>(a, BH, stream);
    case 8: return launch_pt<8, D>(a, BH, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One sequence: q [BH, Sq, D] bf16; page_table, page_tokens int32
// [n_pages] (n_pages >= 1); pools [n_slots, BH, P/vpb, D] and
// [n_slots, BH, P] with D = 32, 64 or 128 and pages of P = 8, 16, ..., 128
// tokens at 1/2/4/8 bits. Writes out f32 [BH, Sq, D] and lse f32 [BH, Sq].
// Returns cudaErrorInvalidValue for a shape it was not built for.
int dlm_paged_attention(const void* q, const void* page_table,
                        const void* page_tokens, const void* k_data,
                        const void* k_scale, const void* k_zp,
                        const void* v_data, const void* v_scale,
                        const void* v_zp, void* out, void* lse, int BH,
                        int Sq, int D, int n_pages, int n_slots, int P,
                        int bits, float sm_scale, void* stream) {
  if (Sq <= 0 || BH <= 0) return 0;
  if (n_pages <= 0 || P < 8 || P > kPmax || P % 8)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const int*>(page_table),
         static_cast<const int*>(page_tokens),
         static_cast<const uint8_t*>(k_data),
         static_cast<const float*>(k_scale),
         static_cast<const float*>(k_zp),
         static_cast<const uint8_t*>(v_data),
         static_cast<const float*>(v_scale),
         static_cast<const float*>(v_zp),
         static_cast<float*>(out),
         static_cast<float*>(lse),
         Sq, n_pages, n_slots, P, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bits<32>(a, BH, bits, st);
    case 64: return launch_bits<64>(a, BH, bits, st);
    case 128: return launch_bits<128>(a, BH, bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
