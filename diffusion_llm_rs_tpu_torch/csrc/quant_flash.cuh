// Flash attention over per-token quantized K/V, for Hopper (sm_90a): one
// design behind two kernels, which differ only in how they address K and V.
//   - csrc/quant_flash_contig.cu replaces `_attn_kernel`
//     (diffusion_llm_rs_tpu/ops/pallas_attention.py:99, behind `attention`,
//     :155): contiguous rows, data uint8 [BH, Skv, D/vpb] packed along D (byte
//     (s, c) holds channel c + p*D/vpb in bit field p, vpb = 8 / bits) and
//     sidecars f32 [BH, Skv].
//   - csrc/quant_flash_paged.cu replaces `_kernel`
//     (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:34, behind
//     `paged_attention`, :140): one sequence's page chain over pools uint8
//     [n_slots, BH, P/vpb, D] packed along tokens (byte (r, d) holds the
//     levels of tokens r + p*P/vpb) and f32 [n_slots, BH, P], tokens past
//     page_tokens[j] masked; it also writes the lse.
// The loaders (`Contig`, `Paged`) are the only code that knows the packing.
//
// What it computes, at the TPU kernels' rounding points: q rounded to bf16
// and qsum = sum_d q in f32; K and V levels as bf16 (exact); per KV tile
//   S = q . K_lv^T                                f32 (exact products)
//   logits = raw * ka' - kb * qsum               ka' = ks * sm, kb = ka' * kz
//   m' = max(m, rowmax); p = exp(logits - m'); alpha = exp(m - m')
//   l = l * alpha + rowsum(p)
//   acc = acc * alpha - sum_t p * vs * vz + bf16(p * vs) . V_lv
//   out = acc * (1 / l), and lse = m + log(l)     f32
// The V scale is folded into P before its bf16 rounding, as both TPU kernels
// fold it. The logits are reassociated as csrc/paged_flash.cuh reassociates
// them (the TPU computes (raw * ks - qsum * (ks * kz)) * sm): one ulp of a
// logit at most. exp(x - m) is 2^(x log2 e - m log2 e) on the ex2 unit; sums
// run in another order than the plain versions'. Tokens past the data (Skv,
// or the page size P) read zero levels and sidecars and take p = 0; tokens
// past page_tokens[j] take logits of -1e30, so while every key a row has
// seen is masked they weigh exp(0) = 1, as in the TPU kernel and the plain
// version. Query rows past Sq are not written.
//
// The KV tile: 64 tokens for the contiguous kernel, one page for the paged
// kernel (its tile holds 32, 64 or 128 tokens, the page size rounded up).
// The TPU's contiguous tile is 512, 256 or 128 tokens: a tile of 256 alone
// would hold 128 logits a thread, beside o, P and the softmax state, where
// two resident blocks leave a consumer thread 96 registers. So the running
// max under bf16(p * vs) moves (ROADMAP C19: up to 3.6e-3 of the output,
// bound 5e-3); `KERNEL_KV_TILE` in ops/attention.py is this tile.
//
// Design. One block of 384 threads per (128-query tile, bh), the query
// tiles of one bh adjacent so that they find its K/V in L2. Warpgroup 2 is
// the producer: each KV tile's packed bytes are read once a block (at most
// twice a call at the sampler's S = 256) and unpacked straight into a ring
// of two stages in shared memory, bf16 K and V level tiles in the 128-, 64-
// or 32-byte swizzled layout that wgmma reads (rows of D = 16 are 32 bytes:
// S is one k-step, P.V an m64n16k16), with the tile's sidecar rows
// (ka', kb, vs, vz) beside them; full and empty mbarriers guard each stage.
// Warpgroups 0 and 1 are the consumers, 64 query rows each: q is loaded once
// into a swizzled shared-memory tile, S = q K^T is a wgmma with both
// operands in shared memory, the softmax runs on its accumulator registers,
// bf16(p * vs) is built in registers as the A operand of the P.V wgmma
// (V read MN-major), and sum_t p * vs * vz is a per-row fma beside it. The
// P.V product of tile t runs under the wait for tile t + 1 and its S. Heads
// of up to 64 with tiles of up to 64 run two blocks an SM (a consumer thread
// 96 registers, the producer's 40); the rest one (232 and 40).
//
// Head widths. An instance is built for each DK of 16, 32, 64, 128, 192
// and 256; a head of D, any multiple of 8 up to 256 (the widths at which
// the TPU wrappers take D % 8 == 0), runs in the smallest DK >= D. Its
// tiles keep DK's layout, zero in the columns past D: the producer zeroes
// the ring once and writes columns below D only, the q loader writes zeros
// past D, so q . k over them adds nothing, and the output columns past D
// are not stored. The loaders then read rows of the true D: a contiguous
// packed row is D/vpb bytes (12 at D = 48 and 4 bits, 1 at D = 8 and 1
// bit: the largest power of two up to 8 that divides it is the read), and
// block packing puts channel c + p * D/vpb in field p of byte c; a paged
// row is D bytes, read 8 at a time. Those loaders (`PAD`) are instances of
// their own, in sources of their own (csrc/*_padded.cu); at D = DK the
// loaders keep their compile-time sizes. At DK = 192 and 256 a consumer
// thread holds 96 or 128
// f32 of o, so those run one block an SM, and pages of more than 64 tokens
// run as two tiles of 64 (two stages of 128-token tiles do not fit).
//
// Where the time goes (PERF.md): the sampler's two shapes run the same 192
// blocks, two an SM, over 4 and 16 tiles, so their times split into about
// 2 us a tile (the consumers' chain of S, softmax and P.V, four warps a
// scheduler) and 5 us outside the loop. A producer warp instead of a
// warpgroup was the bottleneck; a deeper ring, cp.async staging three
// tiles ahead, 32- or 128-token tiles, and S of the next tile issued under
// this tile's softmax (one block an SM) were tried on the card and made it
// no faster, so the design keeps none of them.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace quant_flash {

using namespace hopper;

constexpr int kWG = 2;                     // consumer warpgroups
constexpr int kBQ = 64 * kWG;              // queries a block
constexpr int kThreads = 128 * (kWG + 1);  // and the producer warpgroup
constexpr int kStages = 2;                 // the ring of unpacked tiles
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout of an instance: heads of D (the instance's
// width; a call's heads may be narrower), tiles of TK tokens.
// A [rows][D] bf16 tile is stored in chunks of kEpr columns (64, or all D
// below 64), each chunk [rows][kSw bytes] swizzled as TMA would write it.
template <int D, int TK>
struct Tile {
  static constexpr int kSw = swizzle_of(D * 2);   // bytes of a chunk row
  static constexpr int kEpr = kSw / 2;            // columns of a chunk
  static constexpr int kLayout = layout_of(kSw);
  static constexpr int kTileBytes = TK * D * 2;   // a K or V tile
  static constexpr int kQBytes = 64 * D * 2;      // a warpgroup's q
  static constexpr int kSideFloats = 4 * TK;      // ka', kb, vs, vz
  // the ring (K, V and sidecars a stage, two mbarriers), then the q tiles
  static constexpr int kSmem = 1024 + kStages * (2 * kTileBytes + kSideFloats * 4) +
                               kWG * kQBytes + 2 * kStages * 8;
  // two blocks an SM where a consumer thread fits in 96 registers (80 a
  // thread at launch, the producer's 40 handed over by setmaxnreg), else
  // one (168 at launch, 232 a consumer thread)
  static constexpr int kMinBlocks = D <= 64 && TK <= 64 ? 2 : 1;
  static constexpr int kProdRegs = 40;
  static constexpr int kConsRegs = kMinBlocks == 2 ? 96 : 232;
};

// Byte offset of the 16-byte unit u (columns 8u .. 8u + 7) of row r in a
// swizzled [ROWS][D] tile.
template <int D, int ROWS>
__device__ __forceinline__ int unit_at(int r, int u) {
  return unit_offset<D * 2, ROWS>(r, u);
}

// Bit field p of 4 packed bytes: one level a byte.
template <int BITS>
__device__ __forceinline__ uint32_t field(uint32_t w, int p) {
  if constexpr (BITS == 8) return w;
  return (w >> (p * BITS)) & (0x01010101u * ((1u << BITS) - 1));
}

// 4 levels, one a byte of x, as two words of bf16 pairs (byte 0 in the low
// half of the first). Levels below 16: the bf16 0x4300 | lv is 128 + lv,
// less 128 exactly. 8-bit levels: the f32 0x4B000000 | lv is 2^23 + lv.
template <int BITS>
__device__ __forceinline__ uint2 bf16_levels(uint32_t x) {
  if constexpr (BITS == 8) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __fsub_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)),
                       8388608.f);
    return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
  } else {
    const __nv_bfloat162 k128 = __float2bfloat162_rn(128.f);
    uint32_t w[2] = {__byte_perm(x, 0x43434343u, 0x4140),
                     __byte_perm(x, 0x43434343u, 0x4342)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 v =
          __hsub2(*reinterpret_cast<__nv_bfloat162*>(&w[i]), k128);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ void st_shared(uint8_t* p, uint16_t v) {
  *reinterpret_cast<uint16_t*>(p) = v;
}
__device__ __forceinline__ void st_shared(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ void st_shared(uint8_t* p, uint2 v) {
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void st_shared(uint8_t* p, uint2 lo, uint2 hi) {
  *reinterpret_cast<uint4*>(p) = make_uint4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {  // the 4 lanes of a row
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

struct Out {
  const __nv_bfloat16* q;  // [BH, Sq, D]
  float* out;              // [BH, Sq, D]
  float* lse;              // [BH, Sq], or null
  int Sq, D;               // D <= the instance's width DK
  float sm;
};

// ------------------------------------------------------------- loaders

struct ContigArgs {
  const uint8_t* k_data;  // [BH, Skv, D/vpb]
  const float* k_scale;   // [BH, Skv]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  int Skv, D;
};

struct PagedArgs {
  const int* page_table;   // [n_pages]
  const int* page_tokens;  // [n_pages]
  const uint8_t* k_data;   // [n_slots, BH, P/vpb, D]
  const float* k_scale;    // [n_slots, BH, P]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  int n_pages, n_slots, BH, P, D;
};

// Zero every K and V tile of the ring: where D < DK, load() writes columns
// below D only, so those past D stay 0 (q . k adds nothing over them, and
// the output columns they give are not stored).
template <int DK, int TK>
__device__ __forceinline__ void clear_tiles(uint8_t* tiles, int tid) {
  constexpr int kUnits = 2 * kStages * TK * DK * 2 / 16;
  for (int c = tid; c < kUnits; c += 128)
    reinterpret_cast<uint4*>(tiles)[c] = make_uint4(0, 0, 0, 0);
}

// A loader serves one bh: tiles(), and for tile t the tokens whose logits
// count (valid) and the tokens that hold data (present, >= valid); load()
// is run by the 128 threads of the producer warpgroup and fills one stage.
// The instance's width is DK. A loader with PAD serves heads of D < DK (the
// pools' and the packed rows' true width, a runtime value); without, D =
// DK and every size is known at compile time. The two are separate
// instances, built from separate sources (csrc/*_padded.cu), so that the
// exact widths' code is what it was before padding existed.

// Contiguous rows [BH, Skv, D/vpb], packed along D; tiles of 64 tokens. A
// thread reads CB bytes of a row at once: the largest power of two up to 8
// that divides the row of D/vpb bytes (at D = DK: 8, or the whole row of 4
// or 2 at D = 32 at 1 bit and D = 16 at 2 and 1 bits), as aligned as the
// row.
template <int BITS, int DK, bool PAD>
struct Contig {
  static constexpr int TK = 64;
  static constexpr bool kPad = PAD;
  static constexpr int kDp = DK * BITS / 8;         // bytes a packed row
  static constexpr int kCb = kDp >= 8 ? 8 : kDp;    // bytes a thread reads
  static constexpr int kPer = (TK * (kDp / kCb) + 127) / 128;  // reads a thread
  static constexpr int kBatch = kPer < 4 ? kPer : 4;
  using Args = ContigArgs;
  const uint8_t* kd;
  const uint8_t* vd;
  const float* side[4];
  int Skv, Dp;

  __device__ Contig(const Args& a, int bh)
      : Skv(a.Skv), Dp(PAD ? a.D * BITS / 8 : kDp) {
    const size_t s = (size_t)bh * a.Skv;
    kd = a.k_data + s * (PAD ? Dp : kDp);
    vd = a.v_data + s * (PAD ? Dp : kDp);
    side[0] = a.k_scale + s;
    side[1] = a.k_zp + s;
    side[2] = a.v_scale + s;
    side[3] = a.v_zp + s;
  }
  __device__ int tiles() const { return (Skv + TK - 1) / TK; }
  __device__ int valid(int t) const { return min(TK, Skv - t * TK); }
  __device__ int present(int t) const { return valid(t); }
  // the rows of a tile past Skv are written as zeros by load(); the columns
  // past D (D < DK) never are
  __device__ void clear(uint8_t* tiles, int tid) const {
    if constexpr (PAD) clear_tiles<DK, TK>(tiles, tid);
  }

  // The packed rows of tile t, dp bytes each, CB bytes a read, BATCH reads
  // in flight a thread, unpacked into the swizzled K and V tiles; rows past
  // Skv as zeros.
  template <int CB, int BATCH>
  __device__ __forceinline__ void rows(int t, uint8_t* Ks, uint8_t* Vs,
                                       int tid, int dp) const {
    const int t0 = t * TK, n = valid(t);
    const int nc = dp / CB, reads = TK * nc, per = (reads + 127) / 128;
#pragma unroll 1
    for (int b = 0; b < per; b += BATCH) {
      uint2 kw[BATCH], vw[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = tid + 128 * (b + i), r = c / nc;
        const size_t at = (size_t)(t0 + r) * dp + (c % nc) * CB;
        kw[i] = vw[i] = make_uint2(0u, 0u);
        if (c < reads && r < n) {
          if (CB == 8) {
            kw[i] = *reinterpret_cast<const uint2*>(kd + at);
            vw[i] = *reinterpret_cast<const uint2*>(vd + at);
          } else if (CB == 4) {
            kw[i].x = *reinterpret_cast<const uint32_t*>(kd + at);
            vw[i].x = *reinterpret_cast<const uint32_t*>(vd + at);
          } else if (CB == 2) {
            kw[i].x = *reinterpret_cast<const uint16_t*>(kd + at);
            vw[i].x = *reinterpret_cast<const uint16_t*>(vd + at);
          } else {
            kw[i].x = kd[at];
            vw[i].x = vd[at];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = tid + 128 * (b + i), r = c / nc, col = (c % nc) * CB;
        if ((reads % 128 || per % BATCH) && c >= reads) break;
#pragma unroll
        for (int p = 0; p < 8 / BITS; ++p) {
          const int ch = p * dp + col;  // the first of CB channels
          const int at = unit_at<DK, TK>(r, ch >> 3) + (ch & 7) * 2;
          if (CB == 8) {
            st_shared(Ks + at, bf16_levels<BITS>(field<BITS>(kw[i].x, p)),
                      bf16_levels<BITS>(field<BITS>(kw[i].y, p)));
            st_shared(Vs + at, bf16_levels<BITS>(field<BITS>(vw[i].x, p)),
                      bf16_levels<BITS>(field<BITS>(vw[i].y, p)));
          } else if (CB == 4) {
            st_shared(Ks + at, bf16_levels<BITS>(field<BITS>(kw[i].x, p)));
            st_shared(Vs + at, bf16_levels<BITS>(field<BITS>(vw[i].x, p)));
          } else if (CB == 2) {
            st_shared(Ks + at, bf16_levels<BITS>(field<BITS>(kw[i].x, p)).x);
            st_shared(Vs + at, bf16_levels<BITS>(field<BITS>(vw[i].x, p)).x);
          } else {
            st_shared(Ks + at, (uint16_t)bf16_levels<BITS>(
                                   field<BITS>(kw[i].x, p)).x);
            st_shared(Vs + at, (uint16_t)bf16_levels<BITS>(
                                   field<BITS>(vw[i].x, p)).x);
          }
        }
      }
    }
  }

  __device__ void load(int t, uint8_t* Ks, uint8_t* Vs, float* sd, float sm,
                       int tid) const {
    const int t0 = t * TK, n = valid(t);
    if (tid < TK) {
      float ka = 0.f, kz = 0.f, vs = 0.f, vz = 0.f;
      if (tid < n) {
        ka = __fmul_rn(side[0][t0 + tid], sm);
        kz = side[1][t0 + tid];
        vs = side[2][t0 + tid];
        vz = side[3][t0 + tid];
      }
      sd[tid] = ka;
      sd[TK + tid] = __fmul_rn(ka, kz);
      sd[2 * TK + tid] = vs;
      sd[3 * TK + tid] = vz;
    }
    if constexpr (!PAD) {  // D = DK: every size known here
      rows<kCb, kBatch>(t, Ks, Vs, tid, kDp);
    } else if (Dp % 8 == 0) {
      rows<8, 4>(t, Ks, Vs, tid, Dp);
    } else if constexpr (BITS <= 4) {  // D % 8 == 0: Dp % (8 / vpb) == 0
      if (Dp % 4 == 0) {
        rows<4, 4>(t, Ks, Vs, tid, Dp);
      } else if constexpr (BITS <= 2) {
        if (Dp % 2 == 0)
          rows<2, 4>(t, Ks, Vs, tid, Dp);
        else if constexpr (BITS == 1)
          rows<1, 4>(t, Ks, Vs, tid, Dp);
      }
    }
  }
};

// One sequence's pages over pools [n_slots, BH, P/vpb, D], packed along
// tokens; a tile of TK tokens holds one page of P <= PT, or at DK >= 192
// and pages over 64 tokens half a page (TK = 64, kSplit = 2 tiles a page:
// two stages of 128-token tiles of heads of 192 or 256 do not fit).
template <int BITS, int DK, int PT, bool PAD>
struct Paged {
  static constexpr int TK = DK >= 192 && PT > 64 ? 64 : PT;
  static constexpr bool kPad = PAD;
  static constexpr int kSplit = PT / TK;  // tiles a page
  static constexpr int kVpb = 8 / BITS;
  static constexpr int kBatch = 2;
  using Args = PagedArgs;
  const Args a;
  int bh;

  __device__ Paged(const Args& args, int bh_) : a(args), bh(bh_) {}
  __device__ int tiles() const { return a.n_pages * kSplit; }
  __device__ int valid(int t) const {
    if (kSplit == 1) return min(max(a.page_tokens[t], 0), a.P);
    const int h0 = (t % kSplit) * TK;
    return min(max(min(a.page_tokens[t / kSplit], a.P) - h0, 0), TK);
  }
  __device__ int present(int t) const {
    if (kSplit == 1) return a.P;
    return min(max(a.P - (t % kSplit) * TK, 0), TK);
  }

  // rows [P, TK) of both stages' K and V tiles are read by the products and
  // never written by load(): zero them once; with D < DK or half pages,
  // zero the whole tiles (columns past D; rows a half page leaves)
  __device__ void clear(uint8_t* tiles, int tid) const {
    if (PAD || kSplit > 1) {
      clear_tiles<DK, TK>(tiles, tid);
      return;
    }
    constexpr int kRow = DK * 2 / 16;  // units a row
    for (int s = 0; s < 2 * kStages; ++s)
      for (int c = tid; c < (TK - a.P) * kRow; c += 128)
        *reinterpret_cast<uint4*>(
            tiles + s * TK * DK * 2 +
            unit_at<DK, TK>(a.P + c / kRow, c % kRow)) = make_uint4(0, 0, 0, 0);
  }

  // The page's packed rows of d bytes, CB (16 or 8) bytes a read -> CB
  // columns of kVpb tokens each, the tokens of this tile (from h0) stored.
  template <int CB>
  __device__ __forceinline__ void rows(size_t pg, int h0, uint8_t* Ks,
                                       uint8_t* Vs, int tid, int d) const {
    using W = typename std::conditional<CB == 16, uint4, uint2>::type;
    const int Pp = a.P / kVpb, upr = d / CB, chunks = Pp * upr;
    const uint8_t* kd = a.k_data + pg * Pp * d;
    const uint8_t* vd = a.v_data + pg * Pp * d;
#pragma unroll 1
    for (int c0 = tid; c0 < chunks; c0 += 128 * kBatch) {
      W kw[kBatch], vw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = c0 + 128 * i;
        kw[i] = vw[i] = W{};
        if (c < chunks) {
          kw[i] = *reinterpret_cast<const W*>(kd + (size_t)c * CB);
          vw[i] = *reinterpret_cast<const W*>(vd + (size_t)c * CB);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = c0 + 128 * i;
        if (c >= chunks) break;
        const int r = c / upr, u = (c % upr) * (CB / 8);
#pragma unroll
        for (int p = 0; p < kVpb; ++p) {
          const int tok = r + p * Pp - h0;
          if (kSplit > 1 && (tok < 0 || tok >= TK)) continue;
          st_shared(Ks + unit_at<DK, TK>(tok, u),
                    bf16_levels<BITS>(field<BITS>(kw[i].x, p)),
                    bf16_levels<BITS>(field<BITS>(kw[i].y, p)));
          if constexpr (CB == 16)
            st_shared(Ks + unit_at<DK, TK>(tok, u + 1),
                      bf16_levels<BITS>(field<BITS>(kw[i].z, p)),
                      bf16_levels<BITS>(field<BITS>(kw[i].w, p)));
          st_shared(Vs + unit_at<DK, TK>(tok, u),
                    bf16_levels<BITS>(field<BITS>(vw[i].x, p)),
                    bf16_levels<BITS>(field<BITS>(vw[i].y, p)));
          if constexpr (CB == 16)
            st_shared(Vs + unit_at<DK, TK>(tok, u + 1),
                      bf16_levels<BITS>(field<BITS>(vw[i].z, p)),
                      bf16_levels<BITS>(field<BITS>(vw[i].w, p)));
        }
      }
    }
  }

  __device__ void load(int t, uint8_t* Ks, uint8_t* Vs, float* sd, float sm,
                       int tid) const {
    const int page = t / kSplit, h0 = (t % kSplit) * TK;
    const int slot = a.page_table[page], P = a.P;
    if (slot < 0 || slot >= a.n_slots) __trap();
    const size_t pg = (size_t)slot * a.BH + bh;
    if (tid < TK) {
      const int tok = h0 + tid;
      float ka = 0.f, kz = 0.f, vs = 0.f, vz = 0.f;
      if (tok < P) {
        ka = __fmul_rn(a.k_scale[pg * P + tok], sm);
        kz = a.k_zp[pg * P + tok];
        vs = a.v_scale[pg * P + tok];
        vz = a.v_zp[pg * P + tok];
      }
      sd[tid] = ka;
      sd[TK + tid] = __fmul_rn(ka, kz);
      sd[2 * TK + tid] = vs;
      sd[3 * TK + tid] = vz;
    }
    if constexpr (!PAD)
      rows<16>(pg, h0, Ks, Vs, tid, DK);
    else  // rows of D bytes: whole 8-byte reads (D % 8 == 0)
      rows<8>(pg, h0, Ks, Vs, tid, a.D);
  }
};

// ------------------------------------------------------------- softmax

// The logits of one tile, in place: raw * ka' - kb * qsum, and with kMask
// -1e30 at tokens past `valid`. This thread holds rows g (e < 2) and g + 8
// of its warp's 16, tokens 8j + 2*q4 + (e & 1) of entry 4j + e. Then the
// running max: m_run, alpha = exp(m_old - m_new) and msc = m_new * log2(e).
template <bool kMask, int TK>
__device__ __forceinline__ void logits(float (&x)[TK / 2], const float* sd,
                                       const float (&qs)[2], int q4, int valid,
                                       float (&m_run)[2], float (&alpha)[2],
                                       float (&msc)[2]) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
    const int col = 8 * j + 2 * q4;
    const float2 ka = *reinterpret_cast<const float2*>(sd + col);
    const float2 kb = *reinterpret_cast<const float2*>(sd + TK + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float y = __fmaf_rn(x[4 * j + e], (e & 1) ? ka.y : ka.x,
                          -__fmul_rn((e & 1) ? kb.y : kb.x, qs[r]));
      if (kMask && col + (e & 1) >= valid) y = kNegInf;
      x[4 * j + e] = y;
      mx[r] = fmaxf(mx[r], y);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m_run[r] - mx[r]) * kLog2e);
    msc[r] = mx[r] * kLog2e;
    m_run[r] = mx[r];
  }
}

// p = exp(logit - m), its row sum, w = p * vs in place of the logit, and
// sum_t w * vz. A masked token (kMask, past `valid`) weighs 1 while its
// row's max is still -1e30 and it holds data (before `present`), else 0.
template <bool kMask, int TK>
__device__ __forceinline__ void weights(float (&x)[TK / 2], const float* sd,
                                        int q4, int valid, int present,
                                        const float (&m_run)[2],
                                        const float (&msc)[2],
                                        float (&rsum)[2], float (&csum)[2]) {
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
    const int col = 8 * j + 2 * q4;
    const float2 vs = *reinterpret_cast<const float2*>(sd + 2 * TK + col);
    const float2 vz = *reinterpret_cast<const float2*>(sd + 3 * TK + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, tok = col + (e & 1);
      float p = ex2(__fmaf_rn(x[4 * j + e], kLog2e, -msc[r]));
      if (kMask && tok >= valid)
        p = m_run[r] == kNegInf && tok < present ? 1.f : 0.f;
      rsum[r] += p;
      const float w = __fmul_rn(p, (e & 1) ? vs.y : vs.x);
      csum[r] = __fmaf_rn(w, (e & 1) ? vz.y : vz.x, csum[r]);
      x[4 * j + e] = w;
    }
  }
}

// ------------------------------------------------------------- kernel

template <class L, int D>
__global__ void __launch_bounds__(kThreads, Tile<D, L::TK>::kMinBlocks)
    quant_flash_kernel(const typename L::Args la, const Out oa) {
  constexpr int TK = L::TK;
  using T = Tile<D, TK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = smem;  // stage s: K at 2s, V at 2s + 1
  uint8_t* q_tiles = tiles + kStages * 2 * T::kTileBytes;
  float* sides = reinterpret_cast<float*>(q_tiles + kWG * T::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sides + kStages * T::kSideFloats);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y, Sq = oa.Sq;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // consumer warpgroups with a query row below Sq
  const int active = min(kWG, (Sq - q0 + 63) / 64);
  const L ld(la, bh);
  const int n = ld.tiles();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 128 * active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kWG) {  // ------------------------------------------- producer
    setmaxnreg_dec<T::kProdRegs>();
    ld.clear(tiles, tid);
#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      const int s = t % kStages;
      mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      fence_proxy_async();
      uint8_t* Ks = tiles + 2 * s * T::kTileBytes;
      ld.load(t, Ks, Ks + T::kTileBytes, sides + s * T::kSideFloats, oa.sm,
              tid);
      fence_proxy_async();
      mbar_arrive(full + s);
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<T::kConsRegs>();
  if (wg >= active) return;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;  // and row0 + 8
  uint8_t* qt = q_tiles + wg * T::kQBytes;

  // q rows row0, row0 + 8 (0 past Sq, and past oa.D) into the warpgroup's
  // swizzled tile, each lane of the quad 16 bytes of every fourth unit (at
  // D = 16, the two units of a row go to lanes 0 and 1), and their sums
  float qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r, lr = warp * 16 + g + 8 * r;
    const int dq = L::kPad ? oa.D : D;  // q's and out's rows
    const __nv_bfloat16* qr = oa.q + ((size_t)bh * Sq + row) * dq;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < (D / 8 + 3) / 4; ++i) {
      const int u = q4 + 4 * i;
      if (D % 32 && u >= D / 8) break;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (row < Sq && (!L::kPad || u < dq / 8))
        w = *reinterpret_cast<const uint4*>(qr + 8 * u);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum += __bfloat162float(h[e].x) + __bfloat162float(h[e].y);
      *reinterpret_cast<uint4*>(qt + unit_at<D, 64>(lr, u)) = w;
    }
    qs[r] = quad_sum(sum);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  const uint32_t q_addr = smem_u32(qt);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    const int valid = ld.valid(t), present = ld.present(t);
    const float* sd = sides + s * T::kSideFloats;
    const uint32_t k_addr = smem_u32(tiles + 2 * s * T::kTileBytes);
    mbar_wait(full + s, (t / kStages) & 1);
    // S = q K^T: 64 rows x TK tokens, 16 columns of q a step
    float x[TK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk * 16 / T::kEpr, in = (kk * 16 % T::kEpr) * 2;
      wgmma_ss<TK>(x,
                   gmma_desc(q_addr + chunk * 64 * T::kSw + in, 16,
                             8 * T::kSw, T::kLayout),
                   gmma_desc(k_addr + chunk * TK * T::kSw + in, 16,
                             8 * T::kSw, T::kLayout),
                   kk > 0);
    }
    wgmma_commit();
    if (t > 0) {  // the P.V of the tile before is done: its stage is free
      wgmma_wait<1>();
      fence_regs(o);
      mbar_arrive(empty + (t - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_regs(x);
    float alpha[2], msc[2], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
    if (valid < TK) {
      logits<true, TK>(x, sd, qs, q4, valid, m_run, alpha, msc);
      weights<true, TK>(x, sd, q4, valid, present, m_run, msc, rsum, csum);
    } else {
      logits<false, TK>(x, sd, qs, q4, valid, m_run, alpha, msc);
      weights<false, TK>(x, sd, q4, valid, present, m_run, msc, rsum, csum);
    }
    // bf16(p * vs) as the P.V A operand: the tokens of n-block j go to
    // register (j & 1) * 2 + r of step j / 2
    uint32_t pf[TK / 16][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      pf[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quad_sum(rsum[r]);
      csum[r] = quad_sum(csum[r]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], -csum[(i >> 1) & 1]);
    // o += P V: 16 tokens a step; V is the MN-major B operand
    const uint32_t v_addr = k_addr + T::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<D, 1>(o, pf[kk],
                     gmma_desc(v_addr + kk * 16 * T::kSw, TK * T::kSw,
                               8 * T::kSw, T::kLayout),
                     1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float l = l_run[r], inv = __frcp_rn(l);
    const int dq = L::kPad ? oa.D : D;
    float* orow = oa.out + ((size_t)bh * Sq + row) * dq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (L::kPad && 8 * j >= dq) break;  // columns past D are not stored
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * q4) =
          make_float2(__fmul_rn(o[4 * j + 2 * r], inv),
                      __fmul_rn(o[4 * j + 2 * r + 1], inv));
    }
    if (oa.lse != nullptr && q4 == 0)
      oa.lse[(size_t)bh * Sq + row] = m_run[r] + logf(l);
  }
}

template <class L, int D>
int launch(const typename L::Args& la, const Out& oa, int BH,
           cudaStream_t stream) {
  using T = Tile<D, L::TK>;
  auto kernel = quant_flash_kernel<L, D>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    // shared memory for two resident blocks where the registers allow them
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((oa.Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(la, oa);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ entry points

// A head of D (a multiple of 8 up to 256) runs in the instance of the
// smallest DK of 16, 32, 64, 128, 192 and 256 that holds it: f(DK) as an
// integral constant. Without PAD only D = DK is taken.
template <bool PAD, class F>
int by_width(int D, F&& f) {
  if (D < 8 || D > 256 || D % 8) return (int)cudaErrorInvalidValue;
  const int dk = D <= 16    ? 16
                 : D <= 32  ? 32
                 : D <= 64  ? 64
                 : D <= 128 ? 128
                 : D <= 192 ? 192
                            : 256;
  if (!PAD && D != dk) return (int)cudaErrorInvalidValue;
  switch (dk) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

// dlm_quant_attention(_padded): see csrc/quant_flash_contig.cu
template <bool PAD>
int quant_attention(const void* q, const void* k_data, const void* k_scale,
                    const void* k_zp, const void* v_data, const void* v_scale,
                    const void* v_zp, void* out, int BH, int Sq, int Skv,
                    int D, int bits, float sm_scale, void* stream) {
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  const ContigArgs la{static_cast<const uint8_t*>(k_data),
                      static_cast<const float*>(k_scale),
                      static_cast<const float*>(k_zp),
                      static_cast<const uint8_t*>(v_data),
                      static_cast<const float*>(v_scale),
                      static_cast<const float*>(v_zp), Skv, D};
  const Out oa{static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out),
               nullptr, Sq, D, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_width<PAD>(D, [&](auto dk) {
    constexpr int DK = decltype(dk)::value;
    switch (bits) {
      case 1: return launch<Contig<1, DK, PAD>, DK>(la, oa, BH, st);
      case 2: return launch<Contig<2, DK, PAD>, DK>(la, oa, BH, st);
      case 4: return launch<Contig<4, DK, PAD>, DK>(la, oa, BH, st);
      case 8: return launch<Contig<8, DK, PAD>, DK>(la, oa, BH, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

template <int BITS, int DK, bool PAD>
int paged_pt(const PagedArgs& la, const Out& oa, int BH, cudaStream_t st) {
  if (la.P <= 32) return launch<Paged<BITS, DK, 32, PAD>, DK>(la, oa, BH, st);
  if (la.P <= 64) return launch<Paged<BITS, DK, 64, PAD>, DK>(la, oa, BH, st);
  return launch<Paged<BITS, DK, 128, PAD>, DK>(la, oa, BH, st);
}

// dlm_paged_attention(_padded): see csrc/quant_flash_paged.cu
template <bool PAD>
int paged_attention(const void* q, const void* page_table,
                    const void* page_tokens, const void* k_data,
                    const void* k_scale, const void* k_zp, const void* v_data,
                    const void* v_scale, const void* v_zp, void* out,
                    void* lse, int BH, int Sq, int D, int n_pages, int n_slots,
                    int P, int bits, float sm_scale, void* stream) {
  if (Sq <= 0 || BH <= 0) return 0;
  if (n_pages <= 0 || P < 8 || P > 128 || P % 8)
    return (int)cudaErrorInvalidValue;
  const PagedArgs la{static_cast<const int*>(page_table),
                     static_cast<const int*>(page_tokens),
                     static_cast<const uint8_t*>(k_data),
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(k_zp),
                     static_cast<const uint8_t*>(v_data),
                     static_cast<const float*>(v_scale),
                     static_cast<const float*>(v_zp),
                     n_pages, n_slots, BH, P, D};
  const Out oa{static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out),
               static_cast<float*>(lse), Sq, D, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_width<PAD>(D, [&](auto dk) {
    constexpr int DK = decltype(dk)::value;
    switch (bits) {
      case 1: return paged_pt<1, DK, PAD>(la, oa, BH, st);
      case 2: return paged_pt<2, DK, PAD>(la, oa, BH, st);
      case 4: return paged_pt<4, DK, PAD>(la, oa, BH, st);
      case 8: return paged_pt<8, DK, PAD>(la, oa, BH, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // namespace quant_flash
