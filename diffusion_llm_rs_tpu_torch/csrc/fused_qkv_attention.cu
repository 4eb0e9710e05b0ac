// Fused-QKV bidirectional attention for Hopper (sm_90a): all heads read
// straight from the [B, S, 3D] projection.
//
// Replaces the TPU kernel `_qkv_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_attention.py, behind `fused_qkv_attention`). Per (batch row, head):
//   logits = (q . k) * sm_scale              f32, over all S keys
//   m = rowmax(logits); p = exp(logits - m); p = p / rowsum(p)
//   out = bf16(p) . v                        bf16 operands, f32 sum
// The row is normalised BEFORE P is rounded to bf16. An online softmax
// rounds bf16(p) against running maxima and rescales afterwards, which
// gives other numbers, so this is not a flash kernel: the TPU kernel holds
// the whole [S, S] logit matrix in VMEM, and a block here cannot.
//
// Design (heads of up to 256; `fused_qkv_wgmma_kernel`): two passes over
// the keys. Pass 1 takes each row's exact maximum and the sum of
// exp(logit - max) online (the maximum is exact in any order; the sum
// differs from the two-walk sum only in f32 rounding). Pass 2 recomputes the
// logits and forms p = exp(logit - max) / sum as one power of two,
// 2^(logit log2(e) - (max log2(e) + log2(sum))), before the bf16 rounding;
// P.V follows. Two passes, rather than K held resident in shared memory,
// because a resident K does not fit at every shape the predicate admits
// (heads of 128 at S = 864 take 221 KB) and the re-read tiles come from L2.
//   - A 4-D TMA tensor map views the projection as [B][S][3H][Hd]: a box of
//     (64 rows x Hd) at head index h, H + h or 2H + h cuts out one head's
//     q, k or v with no split or transpose in device memory. The head
//     dimension of the map is Hd itself, so a box padded to the kernel's
//     head width (32, 64, 128, 192 or 256: heads of 8, 24, 40 ... 136 ...
//     200 ...) reads zeros past Hd, as rows past S do.
//   - One warpgroup a block owns 64 query rows of one (batch row, head);
//     its thread 0 keeps a ring of 2 stages of 64-key K (and, in pass 2, V)
//     tiles in flight by TMA, refilling a stage once the warpgroup has
//     multiplied it. Small blocks (20-80 KB of shared memory, 90 registers
//     a thread at heads of 64) let up to 5 share an SM and hide one
//     another's latencies. At heads of 192 and 256 a block takes 121 or 161
//     KB and o 96 or 128 registers a thread (154 and 186 in all, no
//     spill), one block an SM: tiles of 32 keys, two blocks an SM at 256,
//     ran 20% slower at S = 256 and 5-11% faster or slower at S = 864 on an
//     H100 (PERF.md).
//   - S = Q K^T is a wgmma with both operands in shared memory (K-major, 128-
//     or 64-byte swizzle); P lives in registers as the A operand of the P.V
//     wgmma, whose V operand is read MN-major. Keys past S get -1e30 in the
//     last tile only.
// Heads wider than 256 would need more accumulator registers than a thread
// has: they run in csrc/fused_qkv_attention_wide.cu (this design's two
// passes over a thread-block cluster, each block one 256-column slice of
// the head from 264 to 2048, several past it).
//
// What bounds it on an H100: at the sampler's shape (B = 8, S = 256,
// D = 768, 12 heads of 64) the function reads the 9.4 MB projection and
// writes the 3.1 MB output while doing 1.6 GFLOP, so it is bound by bytes
// (0.0038 ms); at S = 864 by the bf16 tensor cores (0.0185 ms). Pass 2's
// second QK^T adds half again to the tensor work.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;     // query rows a block; keys a tile
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>  // the kernel's head width: 32, 64, 128, 192 or 256
struct Shape {
  static constexpr int kSw = HD >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int kEpr = kSw / 2;             // elements per chunk row
  static constexpr int kChunks = HD / kEpr;
  static constexpr int kLayout = kSw == 128 ? 1 : 2;
  static constexpr int kTile = kRows * HD * 2;     // a q, k or v tile
  // two stages: a third or fourth made no block faster and fewer blocks
  // share an SM, which is where the latencies hide
  static constexpr int kStages = 2;
  static constexpr int kSmem = 1024 + kTile + kStages * 2 * kTile + 64;
};

template <int HD, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
    fused_qkv_wgmma_kernel(const __grid_constant__ CUtensorMap map, void* out,
                           int S, int H, int Hd, float sm_scale) {
  using T = Shape<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* ring = smem + T::kTile;  // stage s: K at 2s, V at 2s + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + T::kStages * 2 * T::kTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (S + kRows - 1) / kRows;
  const int loads = 2 * tiles;  // pass 1: K of each tile; pass 2: K and V
  const int tid = threadIdx.x;

  // load i of the sequence into stage i % kStages
  auto issue = [&](int i) {
    const int s = i % T::kStages, t = i < tiles ? i : i - tiles;
    uint8_t* Ks = ring + 2 * s * T::kTile;
    mbar_expect_tx(full + s, (i < tiles ? 1 : 2) * T::kTile);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
      tma_load_4d(Ks + c * kRows * T::kSw, &map, full + s, c * T::kEpr, H + h,
                  t * kRows, b);
      if (i >= tiles)
        tma_load_4d(Ks + T::kTile + c * kRows * T::kSw, &map, full + s,
                    c * T::kEpr, 2 * H + h, t * kRows, b);
    }
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
    mbar_expect_tx(q_full, T::kTile);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      tma_load_4d(Qs + c * kRows * T::kSw, &map, q_full, c * T::kEpr, h, q0, b);
    for (int i = 0; i < T::kStages && i < loads; ++i) issue(i);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const float sl2 = sm_scale * 1.4426950408889634f;
  const uint32_t q_addr = smem_u32(Qs);

  // logits of load i (64 rows x 64 keys, unscaled) into sc; the stage is
  // the caller's until it calls release(i)
  float sc[32];
  auto logits = [&](int i) {
    const int s = i % T::kStages;
    mbar_wait(full + s, (i / T::kStages) & 1);
    const uint32_t k_addr = smem_u32(ring + 2 * s * T::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int chunk = kk * 16 / T::kEpr;
      const uint32_t in = (kk * 16 % T::kEpr) * 2;
      wgmma_ss_n64(sc,
                   gmma_desc(q_addr + chunk * kRows * T::kSw + in, 16,
                             8 * T::kSw, T::kLayout),
                   gmma_desc(k_addr + chunk * kRows * T::kSw + in, 16,
                             8 * T::kSw, T::kLayout),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const int kv0 = (i < tiles ? i : i - tiles) * kRows;
    if (kv0 + kRows > S) {  // keys past S (zero rows of the box)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (kv0 + (e >> 2) * 8 + q4 * 2 + (e & 1) >= S) sc[e] = kNegInf;
    }
  };
  // every warp is done with load i's stage: refill it
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + T::kStages < loads) issue(i + T::kStages);
  };

  mbar_wait(q_full, 0);

  // pass 1: this thread's rows g (e & 2 == 0) and g + 8 of its warp's 16:
  // running maximum of logit * log2(e) and sum of 2^(that - maximum)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < tiles; ++i) {
    logits(i);
    release(i);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], mx[r] * sl2);
      l_run[r] *= ex2(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      l_run[r] += ex2(fmaf(sc[e], sl2, -m_run[r]));
    }
  }
  // merge the four lanes of a row; bias = max + log2(sum), both log2 units
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = m_run[r];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = l_run[r] * ex2(m_run[r] - m);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    bias[r] = m + log2f(l);
  }

  // pass 2: p = 2^(logit log2(e) - bias), normalised, then rounded to bf16
  // as the A operand of o += P V
  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
#pragma unroll 1
  for (int i = tiles; i < loads; ++i) {
    logits(i);
    uint32_t pf[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e >> 1) & 1;
      // keys of n-block j = e / 4 -> A register (j & 1) * 2 + r of step j / 2
      pf[e >> 3][((e >> 2) & 1) * 2 + r] =
          pack_bf16(ex2(fmaf(sc[e], sl2, -bias[r])),
                    ex2(fmaf(sc[e + 1], sl2, -bias[r])));
    }
    const uint32_t v_addr =
        smem_u32(ring + (2 * (i % T::kStages) + 1) * T::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD, 1>(o, pf[kk],
                      gmma_desc(v_addr + kk * 16 * T::kSw, kRows * T::kSw,
                                8 * T::kSw, T::kLayout),
                      1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(i);
  }

  const int D = H * Hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * D + (size_t)h * Hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + q4 * 2;  // even; Hd % 8 == 0
      if (col >= Hd) continue;
      const float y0 = o[4 * j + 2 * r], y1 = o[4 * j + 2 * r + 1];
      if (OUT_BF16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           base + col) =
            __floats2bfloat162_rn(y0, y1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + base + col) =
            make_float2(y0, y1);
    }
  }
}

template <int HD, bool OUT_BF16>
int launch(const void* qkv, void* out, int B, int S, int H, int Hd,
           float sm_scale, cudaStream_t stream) {
  using T = Shape<HD>;
  auto kernel = fused_qkv_wgmma_kernel<HD, OUT_BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  // [B][S][3H][Hd] bf16, Hd innermost; the box is one head's 64 rows
  const uint64_t dims[4] = {(uint64_t)Hd, (uint64_t)(3 * H), (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Hd * 2, (uint64_t)3 * H * Hd * 2,
                               (uint64_t)S * 3 * H * Hd * 2};
  const uint32_t box[4] = {(uint32_t)T::kEpr, 1, (uint32_t)kRows, 1};
  CUtensorMap map;
  if (!make_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qkv, dims, strides,
                box,
                T::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(map, out, S, H, Hd, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// The kernel's head width for heads of Hd: 32, 64, 128, 192 or 256, or 0
// for heads wider than 256 (dlm_fused_qkv_attention_cluster's).
// ops/attention.py: fused_qkv_head_width is the same.
int head_width(int Hd) {
  return Hd <= 32    ? 32
         : Hd <= 64  ? 64
         : Hd <= 128 ? 128
         : Hd <= 192 ? 192
         : Hd <= 256 ? 256
                     : 0;
}

}  // namespace

extern "C" {

// qkv [B, S, 3 * H * Hd] bf16 (16-byte aligned) -> out [B, S, H * Hd],
// bf16 (out_bf16 = 1) or f32. Hd % 8 == 0 and Hd <= 256 (else
// cudaErrorInvalidValue: dlm_fused_qkv_attention_cluster serves every
// multiple of 8 past 256).
int dlm_fused_qkv_attention(const void* qkv, void* out, int out_bf16, int B,
                            int S, int H, int Hd, float sm_scale,
                            void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hd <= 0 || Hd % 8 || H <= 0 || head_width(Hd) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_width(Hd)) {
#define DLM_QKV_CASE(HD_)                                                   \
  case HD_:                                                                 \
    return out_bf16 ? launch<HD_, true>(qkv, out, B, S, H, Hd, sm_scale, st) \
                    : launch<HD_, false>(qkv, out, B, S, H, Hd, sm_scale, st);
    DLM_QKV_CASE(32)
    DLM_QKV_CASE(64)
    DLM_QKV_CASE(128)
    DLM_QKV_CASE(192)
    DLM_QKV_CASE(256)
#undef DLM_QKV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
