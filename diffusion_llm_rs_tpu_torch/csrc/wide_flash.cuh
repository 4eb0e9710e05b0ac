// Attention at head widths past 2048, for Hopper (sm_90a): the wide
// instance of contiguous quantized-KV attention and of batched paged
// attention with bf16 activations (dense, fused-QKV and single-sequence
// paged attention, and the batched int8 path, run every width past 256 in
// csrc/wide_cluster_flash.cuh and csrc/fused_qkv_attention_wide.cu).
//
// The instances of csrc/dense_attention.cu, csrc/quant_flash.cuh and
// csrc/paged_flash.cuh hold a whole head row of q, K and V in shared memory
// and o in registers, so their width is a template parameter and stops at
// 256. The TPU kernels they replace take any multiple of 8 that VMEM holds
// (diffusion_llm_rs_tpu/ops/pallas_attention.py:165-176, :262-269;
// pallas_paged_attention.py:174, :757). Here the head width D is a runtime
// argument, and neither shared memory nor registers grow with it. This
// header serves its modes past 2048: from 264 to 2048 every one of them
// runs the cluster design of csrc/wide_cluster_flash.cuh, which issues S
// once.
//   - output columns over blocks: a block owns kDV = 128 output columns of
//     64 query rows; the grid is (query tiles, ceil(D / 128), heads). Every
//     column block of a query tile computes the same S and the same online
//     softmax in the same order, so their m, l and p agree bit for bit; only
//     the first writes the lse. The S product is therefore issued
//     ceil(D / 128) times a KV tile a query tile: 2 * 64 * TK * D *
//     ceil(D / 128) operations, beside P.V's 2 * 64 * TK * D;
//   - S over D in chunks: S = q.k^T accumulates over chunks of 64 head
//     columns, each chunk of q and of the KV tile staged in shared memory;
//     then the block's 128 columns of the V tile are staged (transposed)
//     and P.V runs from registers;
//   - mma.sync m16n8k16 bf16 (f32 sums); 4 warps of 16 query rows, each
//     thread holding its rows' S of one KV tile and 128 columns of o.
// q's channel sum over the whole head, which meets the K zero point, is
// taken once a block, before the chunked S.
//
// The modes and their arithmetic (that of the plain versions in
// ops/attention.py and ops/paged_attention.py):
//   kContig    QuantKV [Z, Skv, D/vpb] packed along D, sidecars [Z, Skv]:
//              logits = (raw * ks - qsum * (ks * kz)) * sm on the levels;
//              acc += bf16(p * vs) . lv - sum(p * vs * vz); out = acc / l
//   kScratch16 the bf16 scratch of csrc/paged_unpack.cu: logits = raw * ka'
//              - kb * qsum; acc += bf16(p) . v_sc - sum(p * vs * vz);
//              out = acc * (1 / l), 0 and lse -1e30 where a slot has no page
// The KV tile is 64 tokens (kContig) or the page's tile of 32, 64 or 128
// tokens (one page a step, kScratch16). Tokens past the page's valid count
// get logits of -1e30, as in the plain versions; tokens past the tile's real
// ones (past Skv, or the page's P) are left out (p = 0).
//
// This is a simple design that is right, not a fast one: S is computed once
// for each column block, q's chunks are read again for every KV tile (from
// L2), and the quantized loaders read a byte an element. PERF.md gives its
// times beside its bound; past 2048 no shipped configuration reaches it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wide_flash {

constexpr int kBM = 64;         // query rows a block: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kKC = 64;         // head columns a chunk of S
constexpr int kDV = 128;        // output columns a block
constexpr float kNegInf = -1e30f;

enum Mode : int { kContig, kScratch16 };

struct Args {
  const __nv_bfloat16* q;  // [Z, Sq, D]
  float* out;              // [Z, Sq, D]
  float* lse;              // [Z, Sq] (kScratch16)
  int Z, Sq, D;
  float sm;
  int Skv;                 // kContig: Skv tokens
  // kContig: packed levels and their f32 sidecars
  const uint8_t* k_data;
  const float* k_scale;
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  // kScratch16: page_tokens [B, n_max], slot_pages [B]; pages of P tokens
  // in tiles of PT, rows of DK
  const int* page_tokens;
  const int* slot_pages;
  int P, H, n_max, DK;
  const __nv_bfloat16* sk;  // K [B, H, n_max, PT, DK]
  const __nv_bfloat16* sv;  // V [.., PT, DK]
  const float* side;        // [B, H, n_max, 3, PT]
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

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one instance: the chunk buffers (q's 64 rows, then the
// tile's TK rows, each padded so that a quad's fragment loads hit distinct
// banks) alias the V^T tile [kDV][TK + pad], which is staged after S.
template <int TK>
struct Layout {
  static constexpr int kRow = 2 * (kKC + 8);   // bytes
  static constexpr int kVRow = 2 * (TK + 8);   // bytes
  static constexpr int kChunk = (kBM + TK) * kRow;
  static constexpr int kV = kDV * kVRow;
  static constexpr int kBytes = kChunk > kV ? kChunk : kV;
};

template <int MODE, int BITS, int TK>
__global__ void __launch_bounds__(kThreads) wide_attention(const Args a) {
  using L = Layout<TK>;
  constexpr bool kQuant = MODE == kContig;
  constexpr int kNT = TK / 8;                    // n-tiles of S
  constexpr int kMask = (1 << BITS) - 1;
  __shared__ __align__(16) uint8_t smem[L::kBytes];
  __shared__ float s_side[4][TK];
  __shared__ float s_row[kBM];                   // qsum of each query row
  uint8_t* s_q = smem;
  uint8_t* s_k = smem + kBM * L::kRow;
  uint8_t* s_vt = smem;

  const int z = blockIdx.z, q0 = blockIdx.x * kBM, c0 = blockIdx.y * kDV;
  const int D = a.D, Sq = a.Sq, ncols = min(kDV, D - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qz = a.q + (size_t)z * Sq * D;

  int n_tiles;
  if constexpr (kQuant)
    n_tiles = (a.Skv + TK - 1) / TK;
  else
    n_tiles = a.slot_pages[z / a.H];

  // q's channel sum over the whole head, one warp a row
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i, row = q0 + r;
    float sum = 0.f;
    if (row < Sq)
      for (int d = lane; d < D; d += 32)
        sum += __bfloat162float(qz[(size_t)row * D + d]);
    sum = warp_sum(sum);
    if (lane == 0) s_row[r] = sum;
  }
  __syncthreads();
  float qsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qsum[r] = s_row[warp * 16 + g + 8 * r];

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDV / 8][4];
#pragma unroll
  for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int Dp = kQuant ? D / (8 / BITS) : 0;    // bytes a contiguous row

  for (int j = 0; j < n_tiles; ++j) {
    // the tile: its tokens, the valid ones, where its rows are
    int n_real, n_valid, tok0 = 0;
    size_t base = 0;
    if constexpr (kQuant) {
      tok0 = j * TK;
      n_real = n_valid = min(TK, a.Skv - tok0);
    } else {
      n_real = a.P;
      n_valid = a.page_tokens[(size_t)(z / a.H) * a.n_max + j];
      base = (size_t)z * a.n_max + j;            // scratch page
    }

    __syncthreads();  // the last tile's V^T and sidecars are read
    for (int i = tid; i < TK; i += kThreads) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if constexpr (kQuant) {
        if (i < n_real) {
          const size_t at = (size_t)z * a.Skv + tok0 + i;
          s0 = a.k_scale[at];
          s1 = a.k_zp[at];
          s2 = a.v_scale[at];
          s3 = a.v_zp[at];
        }
      } else {
        const float* sd = a.side + base * 3 * TK;
        s0 = sd[i];
        s1 = sd[TK + i];
        s2 = sd[2 * TK + i];
      }
      s_side[0][i] = s0;
      s_side[1][i] = s1;
      s_side[2][i] = s2;
      s_side[3][i] = s3;
    }

    // ---- S = q . k^T over D, a chunk of 64 columns at a time
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kKC) {
      if (d0) __syncthreads();  // the last chunk is read
      // q rows [q0, q0 + 64), columns [d0, d0 + 64): 16-byte loads
      for (int i = tid; i < kBM * 8; i += kThreads) {
        const int r = i >> 3, c = (i & 7) * 8, row = q0 + r, d = d0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < Sq && d < D)
          v = *reinterpret_cast<const uint4*>(qz + (size_t)row * D + d);
        *reinterpret_cast<uint4*>(s_q + r * L::kRow + c * 2) = v;
      }
      // the tile's rows, columns [d0, d0 + 64)
      if constexpr (MODE == kScratch16) {
        for (int i = tid; i < TK * 8; i += kThreads) {
          const int r = i >> 3, c = (i & 7) * 8, d = d0 + c;
          // the scratch's rows are DK wide, a multiple of 64
          const uint4 v = *reinterpret_cast<const uint4*>(
              a.sk + (base * TK + r) * a.DK + d);
          *reinterpret_cast<uint4*>(s_k + r * L::kRow + c * 2) = v;
        }
      } else {  // packed levels, a byte an element
        const int dc = tid & (kKC - 1), d = d0 + dc;
        const bool in = d < D;
        const int byte = in ? d % Dp : 0;
        const int shift = in ? (d / Dp) * BITS : 0;
        for (int r = tid / kKC; r < TK; r += kThreads / kKC) {
          int lv = 0;
          if (in && r < n_real)
            lv = (a.k_data[((size_t)z * a.Skv + tok0 + r) * Dp + byte] >>
                  shift) & kMask;
          reinterpret_cast<__nv_bfloat16*>(s_k + r * L::kRow)[dc] =
              __int2bfloat16_rn(lv);
        }
      }
      __syncthreads();
      const uint8_t* qa = s_q + (warp * 16 + g) * L::kRow;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        const int cb = (kk * 16 + 2 * t) * 2;
        const uint32_t af[4] = {lds32(qa + cb), lds32(qa + 8 * L::kRow + cb),
                                lds32(qa + cb + 16),
                                lds32(qa + 8 * L::kRow + cb + 16)};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint8_t* kb = s_k + (n * 8 + g) * L::kRow + cb;
          mma_bf16(s[n], af, lds32(kb), lds32(kb + 16));
        }
      }
    }

    // ---- logits, mask, online softmax
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1), r = e >> 1;
        float x;
        if constexpr (kQuant) {
          const float ks = s_side[0][col], kz = s_side[1][col];
          x = __fmul_rn(__fsub_rn(__fmul_rn(s[n][e], ks),
                                  __fmul_rn(qsum[r], __fmul_rn(ks, kz))),
                        a.sm);
        } else {
          x = __fsub_rn(__fmul_rn(s[n][e], s_side[0][col]),
                        __fmul_rn(s_side[1][col], qsum[r]));
        }
        if (col >= n_real) x = -INFINITY;
        else if (col >= n_valid) x = kNegInf;
        s[n][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    float alpha[2], psum[2] = {0.f, 0.f}, corr[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = expf(s[n][e] - m[r]);
        psum[r] += p;
        if constexpr (kQuant) {
          const float pv = __fmul_rn(p, s_side[2][col]);
          corr[r] += __fmul_rn(pv, s_side[3][col]);
          s[n][e] = pv;                          // bf16(p * vs) meets lv
        } else {
          corr[r] += __fmul_rn(p, s_side[2][col]);
          s[n][e] = p;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(psum[r]));
      corr[r] = quad_sum(corr[r]);
    }

    // ---- this block's columns of the V tile, transposed: [kDV][TK]
    __syncthreads();  // every warp is done with the chunk buffers
    if constexpr (MODE == kScratch16) {
      for (int i = tid; i < TK * (kDV / 8); i += kThreads) {
        const int r = i / (kDV / 8), c = (i % (kDV / 8)) * 8, d = c0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (d < a.DK)
          v = *reinterpret_cast<const uint4*>(a.sv + (base * TK + r) * a.DK +
                                              d);
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          reinterpret_cast<__nv_bfloat16*>(s_vt + (c + e) * L::kVRow)[r] = x[e];
      }
    } else {  // packed levels: a thread a column
      const int d = c0 + tid;
      const bool in = d < D;
      const int byte = in ? d % Dp : 0;
      const int shift = in ? (d / Dp) * BITS : 0;
      __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(s_vt + tid * L::kVRow);
      for (int r = 0; r < TK; ++r) {
        int lv = 0;
        if (in && r < n_real)
          lv = (a.v_data[((size_t)z * a.Skv + tok0 + r) * Dp + byte] >> shift) &
               kMask;
        row[r] = __int2bfloat16_rn(lv);
      }
    }
    __syncthreads();

    // ---- o = o * alpha + P.V - corr, over this block's columns
    uint32_t pa[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n) {
      if (n * 8 >= ncols) break;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
      const uint8_t* vb = s_vt + (n * 8 + g) * L::kVRow + 4 * t;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        mma_bf16(pv, pa[kk], lds32(vb + kk * 32), lds32(vb + kk * 32 + 16));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = __fsub_rn(
            __fadd_rn(__fmul_rn(o[n][e], alpha[e >> 1]), pv[e]),
            corr[e >> 1]);
    }
  }

  // ---- out, and (kScratch16) the lse from the first column block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    const bool has = l[r] > 0.f;
    const float safe = has ? l[r] : 1.f;
    const float inv = __fdiv_rn(1.f, safe);
    const size_t at = ((size_t)z * Sq + row) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n) {
      if (n * 8 >= ncols) break;
      float y0 = o[n][2 * r], y1 = o[n][2 * r + 1];
      if constexpr (kQuant) {
        y0 = __fdiv_rn(y0, l[r]);
        y1 = __fdiv_rn(y1, l[r]);
      } else {
        y0 = __fmul_rn(y0, inv);
        y1 = __fmul_rn(y1, inv);
      }
      *reinterpret_cast<float2*>(a.out + at + n * 8) = make_float2(y0, y1);
    }
    if (MODE == kScratch16 && blockIdx.y == 0 && t == 0)
      a.lse[(size_t)z * Sq + row] = has ? m[r] + logf(safe) : kNegInf;
  }
}

template <int MODE, int BITS, int TK>
int launch(const Args& a, cudaStream_t stream) {
  if (a.Z <= 0 || a.Sq <= 0) return 0;
  dim3 grid((a.Sq + kBM - 1) / kBM, (a.D + kDV - 1) / kDV, a.Z);
  wide_attention<MODE, BITS, TK><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The contiguous quantized mode at `bits`, KV tiles of 64 tokens.
template <int MODE>
int launch_bits(const Args& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch<MODE, 1, 64>(a, stream);
    case 2: return launch<MODE, 2, 64>(a, stream);
    case 4: return launch<MODE, 4, 64>(a, stream);
    case 8: return launch<MODE, 8, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The batched modes over csrc/paged_unpack.cu's scratch, in tiles of PT.
template <int MODE>
int launch_scratch(const Args& a, int PT, cudaStream_t stream) {
  if (PT == 32) return launch<MODE, 8, 32>(a, stream);
  if (PT == 64) return launch<MODE, 8, 64>(a, stream);
  if (PT == 128) return launch<MODE, 8, 128>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace wide_flash
