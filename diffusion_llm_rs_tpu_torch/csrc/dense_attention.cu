// Dense bf16 flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dense_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py, behind `dense_attention`): q/k/v [BH, S, D] bf16 ->
// out [BH, Sq, D] in bf16 or f32, for every head width D that is a multiple
// of 8 up to 256, as the TPU wrapper takes D % 8 == 0. An instance is built
// for each width DK of 16, 32, 64, 128, 192 and 256 (a template parameter,
// as is the output type); a head of D runs in the smallest DK >= D, whose
// columns past D read as zeros: TMA fills a box that runs past a row of D
// with zeros, so q . k over them adds nothing and the output columns past D
// are never stored. sm_scale is the caller's (1/sqrt(D) of the true D). As
// in the TPU kernel:
//   logits = (q . k) * sm_scale                   f32
//   m' = max(m, rowmax(logits)); p = exp(logits - m'); a = exp(m - m')
//   l  = l * a + rowsum(p)                         f32, p before rounding
//   acc = acc * a + bf16(p) . v                    bf16 operands, f32 sum
//   out = acc / l
// KV rows past Skv get logits of -1e30 (p = 0); query rows past Sq are not
// written. The KV tile is 128 keys (64 at DK >= 192) where the TPU's is 128
// to 512: the running max under bf16(p) differs, the math does not.
//
// What bounds it on an H100: at the long-sequence shape of the sampler (BH =
// 96, S = 1024, D = 64) attention does 4*BH*S^2*D = 25.8 GFLOP over ~50 MB,
// so it is bf16 tensor-core bound (0.026 ms at 989 TFLOP/s); at heads of 16
// (BH = 128) this design's exps weigh more: one a logit on the MUFU ex2
// unit, 16 a clock an SM, 0.032 ms against the tensor cores' 0.0087, a floor
// of this design and not of the card (exp2 can also run as a polynomial on
// the FMA pipes). The design is FlashAttention-3 in outline:
//   - one block per (128-query tile, bh): warpgroup 0 is the producer (one
//     thread issues TMA loads, its registers handed to the consumers with
//     setmaxnreg), warpgroups 1 and 2 each own 64 query rows;
//   - Q is loaded once, K/V tiles of 128 keys stream through a ring of three
//     stages guarded by full/empty mbarriers, so the next tiles' copies
//     overlap this tile's math, and one warpgroup's softmax overlaps the
//     other's products;
//   - S = Q K^T is a wgmma with both operands in shared memory (K-major,
//     128-, 64- or 32-byte swizzle as TMA writes it); the online softmax
//     runs on the accumulator registers; P is rounded to bf16 in registers
//     and is the A operand of the P.V wgmma, whose V operand is read
//     MN-major;
//   - within a warpgroup, S of the next tile and P.V of this one run under
//     this tile's and the next tile's softmax (two logit register sets).
// Heads of DK = 192 and 256: a consumer thread holds 96 or 128 f32 of o, so
// the KV tile is 64 keys and the consumers take 240 registers (the
// producer 24). At DK = 256 q's tile (64 KiB) and a stage of K and V (64
// KiB) leave room for two stages, not three; issuing S of tile t + 1 before
// the stage of tile t - 1 is released would then wait on itself, so there
// S of tile t + 1 goes out after P.V of tile t and the release.
// exp(x - m) is taken as 2^(x log2(e) - m log2(e)) on the fast exp2 unit.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128, kThreads = 384;
constexpr float kNegInf = -1e30f;
// one block an SM: the consumers take the producer's registers (setmaxnreg),
// which a second resident block would hold
constexpr int kMinSmem = 120 * 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An instance's shape: heads of DK (D <= DK in use), tiles of kBK keys.
template <int DK>
struct Shape {
  static constexpr int kBK = DK >= 192 ? 64 : 128;  // keys a tile
  static constexpr int kStages = DK == 256 ? 2 : 3;
  // S of tile t + 1 issued before P.V of tile t - 1 is waited for
  static constexpr bool kOverlap = kStages == 3;
  static constexpr int kProdRegs = DK >= 192 ? 24 : 40;
  static constexpr int kConsRegs = DK >= 192 ? 240 : 232;
  static constexpr int kSw = swizzle_of(DK * 2);  // swizzle span, bytes
  static constexpr int kEpr = kSw / 2;            // elements per chunk row
  static constexpr int kChunks = DK / kEpr;       // column chunks of a row
  static constexpr int kLayout = layout_of(kSw);
  static constexpr int kQBytes = kBQ * DK * 2;
  static constexpr int kKvBytes = kBK * DK * 2;   // one K (or V) tile
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKvBytes + 64;
  static constexpr int kAlloc = kSmem > kMinSmem ? kSmem : kMinSmem;
};

template <int DK, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 1)
    dense_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, void* out,
                           int Sq, int Skv, int D, float sm_scale) {
  using S = Shape<DK>;
  constexpr int kBK = S::kBK, kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KV = smem + S::kQBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(KV + kStages * 2 * S::kKvBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y;
  const int tiles = (Skv + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<S::kProdRegs>();
    if (tid == 0) {
      mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        tma_load_3d(Qs + c * kBQ * S::kSw, &tq, q_full, c * S::kEpr, q0, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * S::kKvBytes);
        uint8_t* Ks = KV + (2 * s) * S::kKvBytes;
        uint8_t* Vs = Ks + S::kKvBytes;
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c) {
          tma_load_3d(Ks + c * kBK * S::kSw, &tk, full + s, c * S::kEpr,
                      t * kBK, bh);
          tma_load_3d(Vs + c * kBK * S::kSw, &tv, full + s, c * S::kEpr,
                      t * kBK, bh);
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<S::kConsRegs>();
    const int c = wg - 1;  // rows 64c .. 64c + 63 of the query tile
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
    const uint32_t q_addr = smem_u32(Qs) + c * 64 * S::kSw;

    float o[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
    // running max in log2 units (logits times log2(e)), running sum
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    const float sl2 = sm_scale * 1.4426950408889634f;

    // S = Q K^T of tile t into sc: 64 rows x kBK keys, DK / 16 steps of 16
    auto issue_s = [&](float(&sc)[kBK / 2], int t) {
      const int s = t % kStages;
      mbar_wait(full + s, (t / kStages) & 1);
      const uint32_t k_addr = smem_u32(KV + (2 * s) * S::kKvBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int chunk = kk * 16 / S::kEpr;
        const uint32_t in = (kk * 16 % S::kEpr) * 2;
        const uint64_t da = gmma_desc(q_addr + chunk * kBQ * S::kSw + in, 16,
                                      8 * S::kSw, S::kLayout);
        const uint64_t db = gmma_desc(k_addr + chunk * kBK * S::kSw + in, 16,
                                      8 * S::kSw, S::kLayout);
        wgmma_ss<kBK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };

    // Tile t, whose logits are in cur: S of tile t + 1 into nxt goes out
    // first, so it runs under this tile's softmax; P.V of tile t - 1 is
    // waited for only before o is rescaled, and P.V of tile t runs under the
    // next tile's softmax. Without kOverlap, P.V of tile t - 1 is done when
    // tile t starts, and S of tile t + 1 goes out beside P.V of tile t.
    auto step = [&](float(&cur)[kBK / 2], float(&nxt)[kBK / 2], int t) {
      const bool more = t + 1 < tiles;
      if (S::kOverlap && more) issue_s(nxt, t + 1);

      // online softmax; this thread holds rows g (e < 2) and g + 8 of its
      // warp's 16, keys 8j + 2q + (e & 1). exp(x - m) is taken as
      // 2^(x log2(e) - m log2(e)).
      const int kv0 = t * kBK;
      float mx[2] = {kNegInf, kNegInf};
      if (kv0 + kBK > Skv) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          if (kv0 + (i >> 2) * 8 + q4 * 2 + (i & 1) >= Skv) cur[i] = kNegInf;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], cur[i]);
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h] * sl2);
        alpha[h] = ex2(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = ex2(fmaf(cur[i], sl2, -m_run[h]));
        const float p1 = ex2(fmaf(cur[i + 1], sl2, -m_run[h]));
        rsum[h] += p0 + p1;
        // keys of n-block j = i / 4 -> A register (j & 1) * 2 + h of step j/2
        pf[i >> 3][((i >> 2) & 1) * 2 + h] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + rsum[h];
      }

      if (t > 0) {  // P.V of tile t - 1 is done: o is ours, its stage free
        if (S::kOverlap) {
          if (more)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_regs(o);
        }
        mbar_arrive(empty + (t - 1) % kStages);
      }
#pragma unroll
      for (int i = 0; i < DK / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: 16 keys a step; V is the MN-major B operand
      const uint32_t v_addr =
          smem_u32(KV + (2 * (t % kStages) + 1) * S::kKvBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = gmma_desc(v_addr + kk * 16 * S::kSw,
                                      kBK * S::kSw, 8 * S::kSw, S::kLayout);
        wgmma_rs<DK, 1>(o, pf[kk], db, 1);
      }
      wgmma_commit();
      if (S::kOverlap) {
        if (more) {  // S of tile t + 1 is done
          wgmma_wait<1>();
          fence_regs(nxt);
        }
      } else {
        if (more) issue_s(nxt, t + 1);
        wgmma_wait<0>();
        fence_regs(o);
        if (more) fence_regs(nxt);
      }
    };

    float sa[kBK / 2], sb[kBK / 2];
    mbar_wait(q_full, 0);
    issue_s(sa, 0);
    wgmma_wait<0>();
    fence_regs(sa);
#pragma unroll 1
    for (int t = 0; t < tiles; t += 2) {
      step(sa, sb, t);
      if (t + 1 < tiles) step(sb, sa, t + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + (tiles - 1) % kStages);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + c * 64 + warp * 16 + g + h * 8;
      if (row >= Sq) continue;
      const size_t base = ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < DK / 8; ++j) {
        if (j * 8 >= D) break;  // columns past D are not stored
        const float y0 = __fdiv_rn(o[4 * j + 2 * h], l_run[h]);
        const float y1 = __fdiv_rn(o[4 * j + 2 * h + 1], l_run[h]);
        const size_t at = base + j * 8 + q4 * 2;
        if (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                             at) = __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(y0, y1);
      }
    }
  }
}

template <int DK, bool OUT_BF16>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Skv, int D, float sm_scale, cudaStream_t stream) {
  using S = Shape<DK>;
  auto kernel = dense_attention_kernel<DK, OUT_BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t rows = i == 0 ? Sq : Skv;
    const uint64_t dims[3] = {(uint64_t)D, rows, (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)D * 2, rows * D * 2};
    const uint32_t box[3] = {(uint32_t)S::kEpr,
                             (uint32_t)(i == 0 ? kBQ : S::kBK), 1};
    if (!make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims,
                  strides, box, tma_swizzle(S::kSw)))
      return (int)cudaErrorInvalidValue;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, S::kAlloc, stream>>>(maps[0], maps[1], maps[2], out,
                                                Sq, Skv, D, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [BH, Sq, D], k/v [BH, Skv, D] bf16 (16-byte aligned) -> out [BH, Sq, D]
// in bf16 (out_bf16 = 1) or f32; D a multiple of 8 from 8 to 256 (returns
// cudaErrorInvalidValue for any other D).
int dlm_dense_attention(const void* q, const void* k, const void* v, void* out,
                        int out_bf16, int BH, int Sq, int Skv, int D,
                        float sm_scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  if (D < 8 || D > 256 || D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLM_DENSE_CASE(DK)                                                   \
  if (D <= DK)                                                               \
    return out_bf16                                                          \
               ? launch<DK, true>(q, k, v, out, BH, Sq, Skv, D, sm_scale, st) \
               : launch<DK, false>(q, k, v, out, BH, Sq, Skv, D, sm_scale, st);
  DLM_DENSE_CASE(16)
  DLM_DENSE_CASE(32)
  DLM_DENSE_CASE(64)
  DLM_DENSE_CASE(128)
  DLM_DENSE_CASE(192)
  DLM_DENSE_CASE(256)
#undef DLM_DENSE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
