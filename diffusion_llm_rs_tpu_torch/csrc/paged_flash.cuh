// Batched paged attention over unpacked pages, for Hopper (sm_90a): the
// attention half of the two-launch design of `batched_paged_attention`
// (diffusion_llm_rs_tpu_torch/ops/paged_attention.py). The other half,
// csrc/paged_unpack.cu, has already turned each live page of each (slot,
// head) into the operands below, once per call, in a scratch laid out in slot
// order, page-aligned and padded to the tile:
//   bf16 (A8 = false): K  bf16 [B, H, n_max, PT, DK] levels 0..255 (exact)
//                      V  bf16 [B, H, n_max, PT, DK] bf16(v_lv * vs)
//                      side f32 [B, H, n_max, 3, PT] ka' = ks * sm,
//                                                    kb = ka' * kz, vc = vs * vz
//   int8 (A8 = true):  K  int8 [B, H, n_max, PT, DK] lv - off
//                      Vt int8 [B, H, n_max, DK, PT] lv - off, columns in
//                                                    `vt_col` order
//                      side f32 [B, H, n_max, 4, PT] ka' = ks * sm,
//                                                    kb' = ka' * (kz - off),
//                                                    vs, vz' = vz - off
// with off = 2^(bits-1), PT the tile (32, 64 or 128 tokens, the page size P
// rounded up) and every row, column and sidecar past P zero. So this kernel
// knows nothing of bits or of the pools' packing. A head of D, any multiple
// of 8 up to 256, runs in the instance of the smallest DK of 16, 32, 64,
// 128, 192 and 256 that holds it: the scratch's rows are DK wide and zero
// past D, q's columns past D are zero, and the output's are not stored.
//
// Heads of DK = 192 and 256 (o alone is 96 or 128 f32 registers a thread):
//   bf16: q goes to a shared-memory tile and S reads it from there, a page
//         of more than 64 tokens runs as two tiles of 64 (its sidecar rows
//         halved by three bulk copies), the consumers take 240 registers,
//         and at DK = 256 the ring has two stages;
//   int8: two blocks share each query tile, each computes S and the
//         softmax in full and P.V for half the columns (DK / 2), so o and
//         the P.V sum fit; q's and K's rows at DK = 192 are two 128-byte
//         chunks wide, zero past 192.
//
// Design (FlashAttention-3 in outline, after csrc/dense_attention.cu): one
// block per (query tile, head, slot), the query tile fastest, so the tiles of
// one (slot, head) run together and find that head's unpacked pages in L2.
// Warpgroup 0 is the producer: one thread streams each live page (a K tile
// and a V tile by TMA, its sidecar rows by a bulk copy) through a ring of
// three stages guarded by full/empty mbarriers; its registers go to the
// consumers (setmaxnreg). The consumer warpgroups own 64 query rows each,
// loaded once: three (192 queries, 160 registers) where heads and tiles are
// at most 64, else two (128 queries, 232 registers). A tile is one page,
// never two: the int8 path scales each page's P.V sum by that page's own sw.
//   bf16: q goes straight into the register A operand of S = q K^T; P.V of
//         page t runs under the S of page t + 1.
//   int8: q is quantized into a shared-memory tile swizzled as TMA swizzles
//         K, and S reads both operands from shared memory. An s8 product
//         takes 32 bytes of k a step, so at D = 16 the q tile and the K
//         tile are 32 bytes wide and zero past d = 16 (the TMA box runs
//         past the scratch's rows of 16 and reads zeros there). (With q in
//         registers, ptxas gave the P.V product's register operand q's
//         registers whenever the two products had one shape, D = PT, and S
//         went wrong from the second page on: measured on the card.) P.V of
//         page t and S of page t + 1 go out together after page t's softmax,
//         and page t's int32 sum folds into o when both are back.
// The arithmetic:
//   bf16: q bf16, qsum = sum_d q in f32 (4 lanes' partial sums)
//         S = wgmma(q regs, K^T) f32; logits = raw * ka' - kb * qsum, -1e30
//         past page_tokens; online softmax; o = o * alpha - sum_t p * vc;
//         o += wgmma(bf16(p) regs, V read MN-major)
//   int8: sq = amax|q| / 127 (1 where 0), qi = rint(q / sq), qsum =
//         sum(qi) * sq; S = wgmma s8 (qi tile, K^T) s32; logits = (raw_i *
//         sq) * ka' - kb' * qsum; w = p * vs (0 past page_tokens); sw =
//         max_t w / 127 (1 where 0); wi = rint(w / sw); pv_i = wgmma s8 (wi
//         regs, Vt) restarted every page; o = o * alpha + pv_i * sw -
//         sum_t w * vz'
//   out = o * (1/l); l = 0 (no page) -> out 0, lse -1e30; lse = m + log(l).
// The rounding points are the TPU kernel's and the plain twins'; sums run in
// another order. exp(x - m) is 2^(x log2 e - m log2 e) on the ex2 unit. Both
// divisions of the int8 path by 127 are IEEE divisions; w / sw is IEEE too,
// taken as the correctly rounded reciprocal of sw and two Newton steps with
// fma (Markstein): three multiply-adds a weight after one reciprocal a row.
// A row whose every key so far is masked has p = 0 on those keys: with
// serving's pages, each live page holds a token, so no row meets that case.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace paged_flash {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;  // [B, H, Sq, D]
  const int* page_tokens;  // [B, n_max]
  const int* n_pages;      // [B]
  const float* side;       // [B, H, n_max, kSide, PT]
  float* out;              // [B, H, Sq, D]
  float* lse;              // [B, H, Sq]
  int H, Sq, n_max, D;     // D <= the instance's width DK
};

template <bool A8, int DK, int PT>
struct Tile {
  static constexpr int kEb = A8 ? 1 : 2;          // bytes an element
  // the width of q and K in S = q K^T: DK, or, int8, whole s8 k-steps of 32
  // bytes in whole 128-byte swizzle chunks: 32 at DK = 16 and 256 at DK =
  // 192 (the TMA box runs past the scratch's rows and reads zeros)
  static constexpr int kDS = A8 ? (DK < 32 ? 32 : DK == 192 ? 256 : DK) : DK;
  // int8 at DK >= 192: o and the P.V sum would take 2 x DK / 2 registers a
  // thread, so two blocks share a query tile, each computing S and the
  // softmax and kDV = DK / 2 of the output's columns
  static constexpr int kNV = A8 && DK >= 192 ? 2 : 1;
  static constexpr int kDV = DK / kNV;
  // tokens a tile: a page, or, bf16 at DK >= 192, half a page of 128 (the
  // int8 path quantizes P.V's weights per page, so its tile is the page)
  static constexpr int kTK = !A8 && DK >= 192 && PT > 64 ? 64 : PT;
  static constexpr int kSplit = PT / kTK;         // tiles a page
  // q in shared memory: always in int8; in bf16 at DK >= 192, where its
  // register A operand would take DK / 2 registers a thread
  static constexpr bool kQSmem = A8 || DK >= 192;
  // the ring: at DK = 256 (bf16) q's tile and two stages fill the block's
  // shared memory
  static constexpr int kStages = !A8 && DK == 256 ? 2 : 3;
  static constexpr int kKSw = swizzle_of(kDS * kEb);  // K rows: kDS elements
  static constexpr int kKEpr = kKSw / kEb;        // elements a chunk row
  static constexpr int kKChunks = kDS / kKEpr;
  // bf16 V [kTK][DK] is laid out as K; int8 V^T [kDV][PT] has rows of PT
  // bytes
  static constexpr int kVSw = A8 ? swizzle_of(PT) : kKSw;
  static constexpr int kKBytes = kTK * kDS * kEb;  // a K tile
  static constexpr int kVBytes = A8 ? kDV * PT : kTK * DK * 2;  // a V (V^T) tile
  static constexpr int kVSlot = kNV == 1 ? kKBytes : kVBytes;
  static constexpr int kStageBytes = kKBytes + kVSlot;
  // consumer warpgroups of 64 query rows: three where heads and tiles of up
  // to 64 fit their registers in 160 a thread, else two (232; 240 at DK >=
  // 192, the producer's single thread then keeping 24)
  static constexpr int kWG = DK <= 64 && PT <= 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kWG, kThreads = 128 * (kWG + 1);
  static constexpr int kProdRegs = kWG == 3 || DK >= 192 ? 24 : 40;
  static constexpr int kConsRegs = kWG == 3 ? 160 : DK >= 192 ? 240 : 232;
  // each consumer warpgroup's q, 64 rows laid out as K
  static constexpr int kQBytes = kQSmem ? kWG * 64 * kDS * kEb : 0;
  static constexpr int kSide = A8 ? 4 : 3;
  static constexpr int kSideFloats = kSide * kTK;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kQBytes +
                               kStages * kSideFloats * 4 + 2 * kStages * 8;
  // one block an SM: the consumers take the producer's registers
  static constexpr int kAlloc = kSmem > 120 * 1024 ? kSmem : 120 * 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// w / sw correctly rounded, from rs = RN(1 / sw): q within 2 ulp, then two
// fma corrections (each exact remainder, Markstein's theorem)
__device__ __forceinline__ float div_by(float w, float sw, float rs) {
  float q = __fmul_rn(w, rs);
  q = __fmaf_rn(__fmaf_rn(-q, sw, w), rs, q);
  return __fmaf_rn(__fmaf_rn(-q, sw, w), rs, q);
}

// An int32 of magnitude below 2^22 as a float, exactly, without the
// quarter-rate conversion unit: its bits added to those of 1.5 * 2^23 are
// the float 1.5 * 2^23 + x
__device__ __forceinline__ float i2f(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.f);
}

// rint(x) for 0 <= x < 2^22 in the low bits of the result (x + 1.5 * 2^23
// rounds to an integer, ties to even, and 1.5 * 2^23's low byte is 0): the
// low byte is the int8 level, again without the conversion unit
__device__ __forceinline__ int rint_bits(float x) {
  return __float_as_int(__fadd_rn(x, 12582912.f));
}

__device__ __forceinline__ uint32_t pack_s8(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float quad_sum(float x) {  // over the 4 lanes of a row
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The logits of one tile into x: raw * ka' - kb * qsum (raw = raw_i * sq in
// the int8 path), and with kMask -1e30 at tokens past `valid` (a tile whose
// every token is valid compiles no compare). This thread holds rows g (e < 2) and g + 8 of its warp's 16, tokens
// 8j + 2*q4 + (e & 1) of entry 4j + e. Then the running max: m_run, alpha =
// exp(m_old - m_new) and msc = m_new * log2(e) (0 while every key so far is
// masked).
template <bool A8, bool kMask, int PT, typename Acc>
__device__ __forceinline__ void logits(const Acc (&sc)[PT / 2],
                                       float (&x)[PT / 2], const float* sd,
                                       const float (&sq)[2],
                                       const float (&qs)[2], int q4, int valid,
                                       float (&m_run)[2], float (&alpha)[2],
                                       float (&msc)[2]) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < PT / 8; ++j) {
    const int col = 8 * j + 2 * q4;
    const float2 ka = *reinterpret_cast<const float2*>(sd + col);
    const float2 kb = *reinterpret_cast<const float2*>(sd + PT + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float raw;
      if constexpr (A8)
        raw = __fmul_rn(i2f(sc[4 * j + e]), sq[r]);
      else
        raw = sc[4 * j + e];
      float y = __fsub_rn(__fmul_rn(raw, (e & 1) ? ka.y : ka.x),
                          __fmul_rn((e & 1) ? kb.y : kb.x, qs[r]));
      if (kMask && col + (e & 1) >= valid) y = kNegInf;
      x[4 * j + e] = y;
      mx[r] = fmaxf(mx[r], y);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m_run[r] - mx[r]) * kLog2e);
    msc[r] = mx[r] == kNegInf ? 0.f : mx[r] * kLog2e;
    m_run[r] = mx[r];
  }
}

template <bool A8, int DK, int PT>
__global__ void __launch_bounds__(Tile<A8, DK, PT>::kThreads, 1)
    paged_flash_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Tile<A8, DK, PT>;
  constexpr int kStages = T::kStages, TK = T::kTK, DV = T::kDV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = smem;  // stage s: K, then V
  uint8_t* q_tiles = tiles + kStages * T::kStageBytes;
  float* sides = reinterpret_cast<float*>(q_tiles + T::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sides + kStages * T::kSideFloats);
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  // query tile, and the first of this block's kDV output columns
  const int qtile = blockIdx.x / T::kNV, v0 = (blockIdx.x % T::kNV) * DV;
  const int count = a.n_pages[b] * T::kSplit;  // tiles
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * T::kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<T::kProdRegs>();
    if (tid == 0) {
      const float* side = a.side + (size_t)bh * a.n_max * T::kSide * PT;
      for (int t = 0; t < count; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, T::kKBytes + T::kVBytes + T::kSideFloats * 4);
        uint8_t* Ks = tiles + s * T::kStageBytes;
        uint8_t* Vs = Ks + T::kKBytes;
        // tile t's rows of the scratch: t * TK (a page's tiles are adjacent)
#pragma unroll
        for (int c = 0; c < T::kKChunks; ++c) {
          tma_load_3d(Ks + c * TK * T::kKSw, &tk, full + s, c * T::kKEpr,
                      t * TK, bh);
          if (!A8)
            tma_load_3d(Vs + c * TK * T::kKSw, &tv, full + s, c * T::kKEpr,
                        t * TK, bh);
        }
        if (A8) tma_load_3d(Vs, &tv, full + s, 0, t * DK + v0, bh);
        float* sd = sides + s * T::kSideFloats;
        if (T::kSplit == 1) {
          bulk_load(sd, side + (size_t)t * T::kSideFloats, T::kSideFloats * 4,
                    full + s);
        } else {  // each sidecar row's half: kTK of the page's PT floats
          const float* from = side + (size_t)(t / T::kSplit) * T::kSide * PT +
                              (t % T::kSplit) * TK;
          for (int i = 0; i < T::kSide; ++i)
            bulk_load(sd + i * TK, from + i * PT, TK * 4, full + s);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<T::kConsRegs>();
  const int c = wg - 1;  // rows 64c .. 64c + 63 of the query tile
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int row0 = qtile * T::kBQ + c * 64 + warp * 16 + g;  // and + 8
  const __nv_bfloat16* qg = a.q + (size_t)bh * a.Sq * a.D;
  const int* ntb = a.page_tokens + (size_t)b * a.n_max;
  // the tokens of tile t whose logits count
  auto valid_of = [&](int t) {
    if (T::kSplit == 1) return ntb[t];
    const int h0 = (t % T::kSplit) * TK;
    return min(max(ntb[t / T::kSplit] - h0, 0), TK);
  };
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float qs[2], sq[2] = {1.f, 1.f};
  auto k_desc = [&](int s, int kk) {  // K of stage s, 32 bytes of d a step
    const int chunk = kk * 32 / T::kKSw, in = kk * 32 % T::kKSw;
    return gmma_desc(smem_u32(tiles + s * T::kStageBytes) + chunk * TK * T::kKSw
                         + in, 16, 8 * T::kKSw, layout_of(T::kKSw));
  };

  if constexpr (!A8) {
    // q rows g, g + 8 of this warp (rows past Sq and columns past D are 0),
    // and their channel sums: into the register A operand of S, or at DK >=
    // 192 into the warpgroup's shared-memory tile, laid out as K
    constexpr int kQRegs = T::kQSmem ? 1 : DK / 16;
    uint32_t qf[kQRegs][4];
    uint8_t* qt = q_tiles + c * 64 * DK * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const __nv_bfloat16* qr = qg + (size_t)row * a.D;
      float sum = 0.f;
      if constexpr (T::kQSmem) {
        // each lane of the quad 16 bytes of every fourth unit
        const int lr = warp * 16 + g + 8 * r;
#pragma unroll
        for (int i = 0; i < DK / 32; ++i) {
          const int u = q4 + 4 * i;
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (row < a.Sq && u < a.D / 8)
            w = *reinterpret_cast<const uint4*>(qr + 8 * u);
          const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum += __bfloat162float(hw[e].x) + __bfloat162float(hw[e].y);
          *reinterpret_cast<uint4*>(qt + unit_offset<DK * 2, 64>(lr, u)) = w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t w = 0u;
            if (row < a.Sq && kk * 16 + half * 8 < a.D)
              w = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + half * 8 +
                                                     q4 * 2);
            qf[kk][half * 2 + r] = w;
            const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
            sum += __bfloat162float(v.x) + __bfloat162float(v.y);
          }
      }
      qs[r] = quad_sum(sum);
    }
    if constexpr (T::kQSmem) {
      fence_proxy_async();
      named_barrier(1 + c, 128);
    }
    const uint32_t q_addr = smem_u32(qt);

#pragma unroll 1
    for (int t = 0; t < count; ++t) {
      const int s = t % kStages;
      const int valid = valid_of(t);
      mbar_wait(full + s, (t / kStages) & 1);
      const float* sd = sides + s * T::kSideFloats;
      // S = q K^T: 64 rows x TK tokens
      float sc[TK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        if constexpr (T::kQSmem) {
          const int chunk = kk * 32 / T::kKSw, in = kk * 32 % T::kKSw;
          wgmma_ss<TK>(sc,
                       gmma_desc(q_addr + chunk * 64 * T::kKSw + in, 16,
                                 8 * T::kKSw, layout_of(T::kKSw)),
                       k_desc(s, kk), kk > 0);
        } else {
          wgmma_rs<TK, 0>(sc, qf[kk], k_desc(s, kk), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();  // and the P.V of the tile before
      fence_regs(sc);
      if (t > 0) {
        fence_regs(o);
        mbar_arrive(empty + (t - 1) % kStages);
      }
      float x[TK / 2], alpha[2], msc[2];
      if (valid < TK)
        logits<false, true, TK>(sc, x, sd, sq, qs, q4, valid, m_run, alpha, msc);
      else
        logits<false, false, TK>(sc, x, sd, sq, qs, q4, valid, m_run, alpha,
                                 msc);
      // p, its row sum, sum_t p * vc, and the P.V A operand: the tokens of
      // n-block j go to register (j & 1) * 2 + r of step j / 2
      float rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
      uint32_t pf[TK / 16][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        const float2 vc = *reinterpret_cast<const float2*>(sd + 2 * TK + 8 * j +
                                                           2 * q4);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p[e] = ex2(fmaf(x[4 * j + e], kLog2e, -msc[r]));
          rsum[r] += p[e];
          csum[r] = fmaf(p[e], (e & 1) ? vc.y : vc.x, csum[r]);
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = l_run[r] * alpha[r] + quad_sum(rsum[r]);
        csum[r] = quad_sum(csum[r]);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i)
        o[i] = o[i] * alpha[(i >> 1) & 1] - csum[(i >> 1) & 1];
      // o += P V: 16 tokens a step; V is the MN-major B operand
      const uint32_t v_addr = smem_u32(tiles + s * T::kStageBytes + T::kKBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<DK, 1>(o, pf[kk],
                        gmma_desc(v_addr + kk * 16 * T::kVSw, TK * T::kVSw,
                                  8 * T::kVSw, layout_of(T::kVSw)),
                        1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
  } else {
    // q rows g, g + 8 of this warp quantized to int8 into the warpgroup's q
    // tile (rows of kDS bytes, swizzled as TMA swizzles K), read by S = q
    // K^T from shared memory: columns ch*16 + 4*q4 .. + 3 a word
    uint8_t* qt = q_tiles + c * 64 * T::kDS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, lr = warp * 16 + g + 8 * r;
      const __nv_bfloat16* qr = qg + (size_t)row * a.D;
      // columns ch*16 + 4*q4 .. + 3 of chunk ch (0 past D)
      float v[T::kDS / 16][4];
      float amax = 0.f;
#pragma unroll
      for (int ch = 0; ch < T::kDS / 16; ++ch) {
        uint2 w = make_uint2(0u, 0u);
        if (ch * 16 + q4 * 4 < a.D && row < a.Sq)
          w = *reinterpret_cast<const uint2*>(qr + ch * 16 + q4 * 4);
        const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&w.x);
        const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&w.y);
        v[ch][0] = __bfloat162float(lo.x);
        v[ch][1] = __bfloat162float(lo.y);
        v[ch][2] = __bfloat162float(hi.x);
        v[ch][3] = __bfloat162float(hi.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[ch][e]));
      }
      amax = quad_max(amax);
      const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
      float sum = 0.f;  // integers up to 256 * 127: exact in any order
#pragma unroll
      for (int ch = 0; ch < T::kDS / 16; ++ch) {
        int lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = rintf(__fdiv_rn(v[ch][e], scale));
          sum += y;
          lv[e] = (int)y;
        }
        const int col = ch * 16 + q4 * 4;
        *reinterpret_cast<uint32_t*>(
            qt + unit_offset<T::kDS, 64>(lr, col >> 4) + (col & 15)) =
            pack_s8(lv[0], lv[1], lv[2], lv[3]);
      }
      sq[r] = scale;
      qs[r] = __fmul_rn(quad_sum(sum), scale);
    }
    fence_proxy_async();
    named_barrier(1 + c, 128);
    const uint32_t q_addr = smem_u32(qt);

    // S of page t into sc: 64 rows x PT tokens, 32 d a step
    int sc[PT / 2];
    auto issue_s = [&](int t) {
      const int s = t % kStages;
      mbar_wait(full + s, (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kDS / 32; ++kk) {
        const int chunk = kk * 32 / T::kKSw, in = kk * 32 % T::kKSw;
        wgmma_s8_ss<PT>(sc, gmma_desc(q_addr + chunk * 64 * T::kKSw + in, 16,
                                      8 * T::kKSw, layout_of(T::kKSw)),
                        k_desc(s, kk), kk > 0);
      }
      wgmma_commit();
    };
    // Page t: its softmax runs while nothing of this warpgroup is in flight;
    // then its P.V product and the next page's S go out together, and page
    // t's int32 P.V sum folds into o once both are back.
    int oi[DV / 2];
    float f_alpha[2], f_sw[2], f_csum[2];  // the fold of the page before
    auto fold = [&]() {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        const int r = (i >> 1) & 1;
        o[i] = __fsub_rn(
            __fmaf_rn(i2f(oi[i]), f_sw[r], __fmul_rn(o[i], f_alpha[r])),
            f_csum[r]);
      }
    };
    if (count > 0) issue_s(0);
#pragma unroll 1
    for (int t = 0; t < count; ++t) {
      const int s = t % kStages;
      const int valid = ntb[t];  // the int8 tile is the page
      const float* sd = sides + s * T::kSideFloats;
      wgmma_wait<0>();  // S of page t, P.V of page t - 1
      fence_regs(sc);
      if (t > 0) {
        fence_regs(oi);
        fold();
        mbar_arrive(empty + (t - 1) % kStages);
      }
      float x[PT / 2], alpha[2], msc[2];
      float rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f}, wmax[2] = {0.f, 0.f};
      // the logits, then w = p * vs (0 past `valid`), its page maximum and
      // sum_t w * vz'
      auto softmax = [&](auto mask) {
        constexpr bool kMask = decltype(mask)::value;
        logits<true, kMask, PT>(sc, x, sd, sq, qs, q4, valid, m_run, alpha,
                                msc);
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) {
          const int col = 8 * j + 2 * q4;
          const float2 vs = *reinterpret_cast<const float2*>(sd + 2 * PT + col);
          const float2 vz = *reinterpret_cast<const float2*>(sd + 3 * PT + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = ex2(fmaf(x[4 * j + e], kLog2e, -msc[r]));
            rsum[r] += p;
            float w = __fmul_rn(p, (e & 1) ? vs.y : vs.x);
            if (kMask && col + (e & 1) >= valid) w = 0.f;
            csum[r] = fmaf(w, (e & 1) ? vz.y : vz.x, csum[r]);
            wmax[r] = fmaxf(wmax[r], w);
            x[4 * j + e] = w;
          }
        }
      };
      if (valid < PT)
        softmax(std::true_type{});
      else
        softmax(std::false_type{});
      float rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = l_run[r] * alpha[r] + quad_sum(rsum[r]);
        wmax[r] = quad_max(wmax[r]);
        f_sw[r] = wmax[r] > 0.f ? __fdiv_rn(wmax[r], 127.f) : 1.f;
        rs[r] = __frcp_rn(f_sw[r]);
        f_csum[r] = quad_sum(csum[r]);
        f_alpha[r] = alpha[r];
      }
      // wi = rint(w / sw), 0..127. Step kk of 32 tokens: register 0 holds
      // row g's tokens of n-blocks 4kk and 4kk + 1, register 2 those of
      // 4kk + 2 and 4kk + 3, registers 1 and 3 row g + 8's (the `vt_col`
      // order of the V^T columns)
      uint32_t pf[PT / 32][4];
#pragma unroll
      for (int kk = 0; kk < PT / 32; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n0 = 4 * kk + 2 * hf;
            int wi[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wi[e] = rint_bits(div_by(
                  x[4 * (n0 + (e >> 1)) + 2 * r + (e & 1)], f_sw[r], rs[r]));
            pf[kk][hf * 2 + r] = pack_s8(wi[0], wi[1], wi[2], wi[3]);
          }
      // pv_i = wi . v_lv, 32 tokens a step, restarted every page
      const uint32_t v_addr = smem_u32(tiles + s * T::kStageBytes + T::kKBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PT / 32; ++kk)
        wgmma_s8<DV>(oi, pf[kk],
                    gmma_desc(v_addr + kk * 32, 16, 8 * T::kVSw,
                              layout_of(T::kVSw)),
                    kk > 0);
      wgmma_commit();
      if (t + 1 < count) issue_s(t + 1);
    }
    if (count > 0) {
      wgmma_wait<0>();
      fence_regs(oi);
      fold();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
    const float l = l_run[r];
    const float inv = __frcp_rn(l > 0.f ? l : 1.f);
    float* orow = a.out + ((size_t)bh * a.Sq + row) * a.D + v0;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (v0 + 8 * j >= a.D) break;  // columns past D are not stored
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * q4) = make_float2(
          __fmul_rn(o[4 * j + 2 * r], inv), __fmul_rn(o[4 * j + 2 * r + 1], inv));
    }
    if (q4 == 0 && v0 == 0)
      a.lse[(size_t)bh * a.Sq + row] = l > 0.f ? m_run[r] + logf(l) : kNegInf;
  }
}

// The scratch's K (and bf16 V) as [B*H, n_max*PT, DK] and int8 V^T as
// [B*H, n_max*DK, PT], each TMA box one tile (a chunk of 128 bytes of its
// rows at a time; int8 V^T the kDV rows of this block's columns), swizzled
// as the wgmma descriptors read it. The int8 K box at DK = 16 is 32 bytes
// wide and at DK = 192 two chunks of 128: past the scratch's rows it reads
// zeros.
template <bool A8, int DK, int PT>
int launch(const Args& a, int B, const void* k, const void* v,
           cudaStream_t stream) {
  using T = Tile<A8, DK, PT>;
  auto kernel = paged_flash_kernel<A8, DK, PT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kAlloc);
  if (attr != cudaSuccess) return (int)attr;
  const CUtensorMapDataType type =
      A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t BH = (uint64_t)B * a.H, n = (uint64_t)a.n_max;
  CUtensorMap maps[2];
  {
    const uint64_t dims[3] = {(uint64_t)DK, n * PT, BH};
    const uint64_t strides[2] = {(uint64_t)DK * T::kEb, n * PT * DK * T::kEb};
    const uint32_t box[3] = {(uint32_t)T::kKEpr, (uint32_t)T::kTK, 1};
    if (!make_map(&maps[0], type, 3, k, dims, strides, box,
                  tma_swizzle(T::kKSw)) ||
        (!A8 && !make_map(&maps[1], type, 3, v, dims, strides, box,
                          tma_swizzle(T::kKSw))))
      return (int)cudaErrorInvalidValue;
  }
  if (A8) {
    const uint64_t dims[3] = {(uint64_t)PT, n * DK, BH};
    const uint64_t strides[2] = {(uint64_t)PT, n * DK * PT};
    const uint32_t box[3] = {(uint32_t)PT, (uint32_t)T::kDV, 1};
    if (!make_map(&maps[1], type, 3, v, dims, strides, box,
                  tma_swizzle(T::kVSw)))
      return (int)cudaErrorInvalidValue;
  }
  dim3 grid((a.Sq + T::kBQ - 1) / T::kBQ * T::kNV, a.H, B);
  kernel<<<grid, T::kThreads, T::kAlloc, stream>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

template <bool A8, int DK>
int launch_pt(const Args& a, int B, int PT, const void* k, const void* v,
              cudaStream_t stream) {
  switch (PT) {
    case 32: return launch<A8, DK, 32>(a, B, k, v, stream);
    case 64: return launch<A8, DK, 64>(a, B, k, v, stream);
    case 128: return launch<A8, DK, 128>(a, B, k, v, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// D a multiple of 8 up to 256, over a scratch of rows of DK = 16, 32, 64,
// 128, 192 or 256 (the smallest that holds D); PT = 32, 64 or 128
template <bool A8>
int run(const void* q, const void* page_tokens, const void* n_pages,
        const void* k, const void* v, const void* side, void* out, void* lse,
        int B, int H, int Sq, int D, int n_max, int PT, void* stream) {
  if (Sq <= 0 || B <= 0 || H <= 0) return 0;
  if (n_max <= 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const int*>(page_tokens),
         static_cast<const int*>(n_pages),
         static_cast<const float*>(side),
         static_cast<float*>(out),
         static_cast<float*>(lse),
         H, Sq, n_max, D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 256 || D % 8) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch_pt<A8, 16>(a, B, PT, k, v, st);
  if (D <= 32) return launch_pt<A8, 32>(a, B, PT, k, v, st);
  if (D <= 64) return launch_pt<A8, 64>(a, B, PT, k, v, st);
  if (D <= 128) return launch_pt<A8, 128>(a, B, PT, k, v, st);
  if (D <= 192) return launch_pt<A8, 192>(a, B, PT, k, v, st);
  return launch_pt<A8, 256>(a, B, PT, k, v, st);
}

}  // namespace paged_flash
