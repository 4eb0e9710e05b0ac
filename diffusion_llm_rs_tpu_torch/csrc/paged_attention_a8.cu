// Flash attention over paged, quantized KV pools with int8 activations, for
// Hopper (sm_90a).
//
// Replaces the `act_bits=8` path of the TPU kernel `_batched_kernel`
// (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py, behind
// `batched_paged_attention(act_bits=8)`): both products of attention run on
// the int8 tensor cores. The packed K/V levels are integers already; q is
// quantized per (head, row) once, and the softmax weights folded with the V
// scale are quantized per (page, query).
//
// Pools keep the JAX layout (see paged_attention.cu): data uint8 [n_slots,
// H/G, P/vpb, G*D], token-block packed (byte (r, d) holds the levels of
// tokens r + p*P/vpb in bit field p); sidecars f32 [n_slots, H/G, G*P].
// Head widths D = 32, 64 and 128 are template parameters, and so is the
// tile's capacity of 32, 64 or 128 tokens (the smallest that holds the
// page); the page size P (a multiple of 8 up to 128) and the head group G
// are not. A page that fills its tile runs an instance whose loop bounds are
// all constant: the runtime bounds cost up to 26%.
//
// One block per (64-query tile, head, slot); 4 warps own 16 query rows each,
// so a query row's tokens of a page sit in 4 lanes of one warp and the
// per-query maxima are two shuffles. Per block, once: q rows -> int8 with
//   sq = amax|bf16 q| / 127 (1 where 0); qi = rint(q / sq); qsum = sum(qi) * sq
// Per page of P tokens, with off = 2^(bits-1):
//   k_lv, v_lv = levels - off as int8 (K as [token][d]; V transposed to
//     [d][token], the K-major B operand mma.sync s8 wants)
//   ks' = ks * sm; kz' = kz - off; vz' = vz - off
//   logits = (raw_i * sq) * ks' - (ks' * kz') * qsum     raw_i int32, exact
//   tokens >= page_tokens: logits -1e30
//   m' = max(m, max logits); p = exp(logits - m'); a = exp(m - m')
//   l = l * a + sum p
//   w = p * vs (0 on invalid tokens); sw = max_t w / 127 (1 where 0)
//   wi = rint(w / sw)                                    int8, 0..127
//   acc = acc * a + (v_lv^T . wi) * sw - sum_t w * vz'   int32 dot, exact
// out = acc * (1/l); l = 0 (no page) -> out 0, lse -1e30. The int32 PV sum is
// scaled by the page's own sw, so it cannot stay in the mma accumulators
// across pages: it is zeroed per page and folded into the f32 accumulator.
// Both divisions by 127 are IEEE divisions, as in the TPU kernel.
//
// The AV product contracts over tokens, and a thread holds the weights of
// tokens n*8 + t*2 + {0, 1} of each 8-token tile n, not the 4 consecutive
// tokens an A fragment of m16n8k32 takes. A sum over tokens may run in any
// order, so V^T is stored with each 32-token group's columns permuted to the
// order the threads hold them (`vt_col`), and both fragments are plain words.
//
// What bounds it on an H100: at the serving shape (B = 2, H = 12, Sq = Skv =
// 4096, D = 64, 4-bit pages of 128) the dots are 103 G int8 operations over
// ~30 MB, so the int8 tensor cores bound it (0.052 ms, half the bf16 path's
// bound). Like the bf16 kernel this first version re-unpacks each page once
// per 64-query tile on one shared-memory stage, with mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kThreads = 128, kPmax = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;  // [B, H, Sq, D]
  const int* page_tables;  // [B, n_max]
  const int* page_tokens;  // [B, n_max]
  const int* n_pages;      // [B]
  const uint8_t* k_data;   // [n_slots, H/G, P/vpb, G*D]
  const float* k_scale;    // [n_slots, H/G, G*P]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  float* out;              // [B, H, Sq, D]
  float* lse;              // [B, H, Sq]
  int H, Sq, n_max, n_slots, G, P;
  float sm;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column of token `tok` in a V^T row: within each group of 32 tokens, token
// i2*8 + t*2 + e (tile i2 of 4, lane t of 4, element e of 2) moves to
// (i2/2)*16 + t*4 + (i2%2)*2 + e, so that a thread's weights of tiles
// (0, 1) and (2, 3) are the bytes of A registers a0/a1 and a2/a3.
__device__ __forceinline__ int vt_col(int tok) {
  const int i2 = (tok >> 3) & 3, tt = (tok >> 1) & 3, e = tok & 1;
  return (tok & ~31) + (i2 >> 1) * 16 + tt * 4 + (i2 & 1) * 2 + e;
}

__device__ __forceinline__ uint32_t pack_s8(float x0, float x1, float x2,
                                            float x3) {
  return ((uint32_t)(uint8_t)(int8_t)(int)x0) |
         ((uint32_t)(uint8_t)(int8_t)(int)x1 << 8) |
         ((uint32_t)(uint8_t)(int8_t)(int)x2 << 16) |
         ((uint32_t)(uint8_t)(int8_t)(int)x3 << 24);
}

// D: head width; PT: tokens the tiles hold (32, 64 or 128), the page size
// rounded up
template <int D, int PT>
struct A8Shape {
  static constexpr int kQStride = D + 8;    // bf16 q tile, in elements
  static constexpr int kRowBytes = D + 16;  // int8 rows of D: conflict-free
  static constexpr int kVtBytes = PT + 16;  // V^T rows of PT tokens
  static constexpr int kQ = kBQ * kQStride * 2, kQi = kBQ * kRowBytes;
  static constexpr int kK = PT * kRowBytes, kVt = D * kVtBytes;
  // bf16 q, int8 q, K [token][d], V^T [d][token]; per token of the page:
  // logit scale and offset, V scale, V zero-point; per query row: sq, qsum
  static constexpr int kSmem = kQ + kQi + kK + kVt + (4 * PT + 2 * kBQ) * 4;
};

template <int BITS, int D, int PT, bool kFull>
__global__ void __launch_bounds__(kThreads)
    paged_attention_a8_kernel(const Args a) {
  using Sh = A8Shape<D, PT>;
  constexpr int kD = D, kQStride = Sh::kQStride, kRowBytes = Sh::kRowBytes;
  constexpr int kVtBytes = Sh::kVtBytes;
  constexpr int kVpb = 8 / BITS;
  constexpr uint32_t kMask4 = 0x01010101u * ((1u << BITS) - 1u);
  constexpr uint32_t kOff4 = 0x01010101u * (1u << (BITS - 1));
  constexpr float kOff = (float)(1 << (BITS - 1));
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Qi = smem + Sh::kQ;
  uint8_t* Ks = Qi + Sh::kQi;
  uint8_t* Vt = Ks + Sh::kK;
  float* s_ka = reinterpret_cast<float*>(Vt + Sh::kVt);
  float* s_kb = s_ka + PT;
  float* s_vs = s_kb + PT;
  float* s_vz = s_vs + PT;
  float* s_sq = s_vz + PT;
  float* s_qsum = s_sq + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  // kFull: the page fills the tile, and every loop bound below is constant
  const int H = a.H, Sq = a.Sq, G = a.G, HG = H / G, P = kFull ? PT : a.P;
  const int kPp = P / kVpb;  // packed rows of a page: even (P % 8 == 0)
  const int hg = h / G, hl = h % G, GD = G * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;

  // q tile (rows past Sq are zero), then each row quantized to int8
  const __nv_bfloat16* qb = a.q + bh * Sq * kD;
  for (int c = threadIdx.x; c < kBQ * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * kD + col);
    *reinterpret_cast<uint4*>(Qs + r * kQStride + col) = v;
  }
  __syncthreads();
  if (threadIdx.x < kBQ) {
    const __nv_bfloat16* row = Qs + threadIdx.x * kQStride;
    float amax = 0.f;
    for (int d = 0; d < kD; ++d)
      amax = fmaxf(amax, fabsf(__bfloat162float(row[d])));
    const float sq = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    float sum = 0.f;
    for (int d = 0; d < kD; ++d) {
      const float lv = rintf(__fdiv_rn(__bfloat162float(row[d]), sq));
      sum += lv;  // integers up to 128 * 127: exact
      Qi[threadIdx.x * kRowBytes + d] = (uint8_t)(int8_t)(int)lv;
    }
    s_sq[threadIdx.x] = sq;
    s_qsum[threadIdx.x] = __fmul_rn(sum, sq);
  }
  __syncthreads();
  uint32_t qf[kD / 32][4];  // A fragments: rows g, g + 8; 32 d per step
#pragma unroll
  for (int d = 0; d < kD / 32; ++d) {
    const uint8_t* base = Qi + (warp * 16 + g) * kRowBytes + d * 32 + t * 4;
    qf[d][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[d][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRowBytes);
    qf[d][2] = *reinterpret_cast<const uint32_t*>(base + 16);
    qf[d][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRowBytes + 16);
  }
  const float sq[2] = {s_sq[warp * 16 + g], s_sq[warp * 16 + g + 8]};
  const float qs[2] = {s_qsum[warp * 16 + g], s_qsum[warp * 16 + g + 8]};

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int count = a.n_pages[b];
  const int* pt = a.page_tables + (size_t)b * a.n_max;
  const int* nt = a.page_tokens + (size_t)b * a.n_max;
  for (int j = 0; j < count; ++j) {
    const int slot = pt[j], valid = nt[j];
    if (slot < 0 || slot >= a.n_slots) __trap();
    const size_t side = ((size_t)slot * HG + hg) * G * P + (size_t)hl * P;
    const size_t base = ((size_t)slot * HG + hg) * kPp * GD + (size_t)hl * kD;
    __syncthreads();  // every warp is done with the previous page
    // sidecars past P are 0: a masked token's weight 0 then adds 0, not NaN
    for (int i = threadIdx.x; i < PT; i += kThreads) {
      const bool in = i < P;
      const float ka = in ? __fmul_rn(a.k_scale[side + i], a.sm) : 0.f;
      s_ka[i] = ka;
      s_kb[i] = in ? __fmul_rn(ka, __fsub_rn(a.k_zp[side + i], kOff)) : 0.f;
      s_vs[i] = in ? a.v_scale[side + i] : 0.f;
      s_vz[i] = in ? __fsub_rn(a.v_zp[side + i], kOff) : 0.f;
    }
    // up to 4 packed rows x 4 d at a time: centered levels of 4 tokens x 4 d
    // per bit field; K keeps [token][d], V is transposed to [d][token]. A
    // group of rows may end after 2 (kPp is even)
    for (int c = threadIdx.x; c < ((kPp + 3) / 4) * (kD / 4); c += kThreads) {
      const int r = (c / (kD / 4)) * 4, col = (c % (kD / 4)) * 4;
      const bool four = kPp % 4 == 0 || r + 2 < kPp;
      uint32_t kw[4], vw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kw[i] = vw[i] = 0u;
        if (i < 2 || four) {
          const size_t off = base + (size_t)(r + i) * GD + col;
          kw[i] = *reinterpret_cast<const uint32_t*>(a.k_data + off);
          vw[i] = *reinterpret_cast<const uint32_t*>(a.v_data + off);
        }
      }
#pragma unroll
      for (int p = 0; p < kVpb; ++p) {
        const int tok = r + p * kPp;
        uint32_t vc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t kc = __vsub4((kw[i] >> (p * BITS)) & kMask4, kOff4);
          if (i < 2 || four)
            *reinterpret_cast<uint32_t*>(Ks + (tok + i) * kRowBytes + col) = kc;
          vc[i] = __vsub4((vw[i] >> (p * BITS)) & kMask4, kOff4);
        }
        // vc[i] holds d col..col+3 of token tok+i; row d takes tokens
        // tok..tok+3 as two halfwords (tok, tok+1) and (tok+2, tok+3)
        const uint32_t lo01 = __byte_perm(vc[0], vc[1], 0x5140);  // d0 d1
        const uint32_t hi01 = __byte_perm(vc[0], vc[1], 0x7362);  // d2 d3
        const int c0 = vt_col(tok);
        uint8_t* vrow = Vt + col * kVtBytes;
        *reinterpret_cast<uint16_t*>(vrow + c0) = (uint16_t)(lo01 & 0xffffu);
        *reinterpret_cast<uint16_t*>(vrow + kVtBytes + c0) = (uint16_t)(lo01 >> 16);
        *reinterpret_cast<uint16_t*>(vrow + 2 * kVtBytes + c0) = (uint16_t)(hi01 & 0xffffu);
        *reinterpret_cast<uint16_t*>(vrow + 3 * kVtBytes + c0) = (uint16_t)(hi01 >> 16);
        if (four) {
          const uint32_t lo23 = __byte_perm(vc[2], vc[3], 0x5140);
          const uint32_t hi23 = __byte_perm(vc[2], vc[3], 0x7362);
          const int c2 = vt_col(tok + 2);
          *reinterpret_cast<uint16_t*>(vrow + c2) = (uint16_t)(lo23 & 0xffffu);
          *reinterpret_cast<uint16_t*>(vrow + kVtBytes + c2) = (uint16_t)(lo23 >> 16);
          *reinterpret_cast<uint16_t*>(vrow + 2 * kVtBytes + c2) = (uint16_t)(hi23 & 0xffffu);
          *reinterpret_cast<uint16_t*>(vrow + 3 * kVtBytes + c2) = (uint16_t)(hi23 >> 16);
        }
      }
    }
    __syncthreads();

    // raw_i = qi . k_lv for 16 rows x the page's 8-token blocks, int32
    float s[PT / 8][4];
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      int acc[4] = {0, 0, 0, 0};
      if (n * 8 < P) {
#pragma unroll
        for (int d = 0; d < kD / 32; ++d) {
          const uint8_t* kp = Ks + (n * 8 + g) * kRowBytes + d * 32 + t * 4;
          mma_s8(acc, qf[d], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 16));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = (float)acc[e];
    }

    // logits and online softmax; thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3), tokens n*8 + t*2 + {0, 1}; tokens past `valid` get -1e30
    float m_new[2], alpha[2], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
    float wmax[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int n = 0; n < PT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + t * 2 + e;
          const float raw = __fmul_rn(s[n][r * 2 + e], sq[r]);
          float x = __fsub_rn(__fmul_rn(raw, s_ka[col]),
                              __fmul_rn(s_kb[col], qs[r]));
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
    // s becomes w = p * vs (0 on invalid tokens)
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + t * 2 + e;
          const float p = expf(s[n][r * 2 + e] - m_new[r]);
          rsum[r] += p;
          const float w = col < valid ? __fmul_rn(p, s_vs[col]) : 0.f;
          csum[r] += __fmul_rn(w, s_vz[col]);
          wmax[r] = fmaxf(wmax[r], w);
          s[n][r * 2 + e] = w;
        }
      }
    }
    float sw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      csum[r] += __shfl_xor_sync(0xffffffffu, csum[r], 1);
      csum[r] += __shfl_xor_sync(0xffffffffu, csum[r], 2);
      wmax[r] = fmaxf(wmax[r], __shfl_xor_sync(0xffffffffu, wmax[r], 1));
      wmax[r] = fmaxf(wmax[r], __shfl_xor_sync(0xffffffffu, wmax[r], 2));
      sw[r] = wmax[r] > 0.f ? __fdiv_rn(wmax[r], 127.f) : 1.f;
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
      m_run[r] = m_new[r];
    }

    // pv_i = wi . v_lv: k = token (32 per step, in vt_col order), n = d;
    // tokens past P in the last step have wi = 0
    int oi[kD / 8][4];
#pragma unroll
    for (int dj = 0; dj < kD / 8; ++dj)
#pragma unroll
      for (int e = 0; e < 4; ++e) oi[dj][e] = 0;
#pragma unroll
    for (int kk = 0; kk < PT / 32; ++kk) {
      if (kk * 32 >= P) break;
      uint32_t wf[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {    // tiles (0, 1) then (2, 3)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n0 = kk * 4 + hf * 2;
          wf[hf * 2 + r] = pack_s8(
              rintf(__fdiv_rn(s[n0][r * 2], sw[r])),
              rintf(__fdiv_rn(s[n0][r * 2 + 1], sw[r])),
              rintf(__fdiv_rn(s[n0 + 1][r * 2], sw[r])),
              rintf(__fdiv_rn(s[n0 + 1][r * 2 + 1], sw[r])));
        }
      }
#pragma unroll
      for (int dj = 0; dj < kD / 8; ++dj) {
        const uint8_t* vp = Vt + (dj * 8 + g) * kVtBytes + kk * 32 + t * 4;
        mma_s8(oi[dj], wf, *reinterpret_cast<const uint32_t*>(vp),
               *reinterpret_cast<const uint32_t*>(vp + 16));
      }
    }
    // acc = acc * alpha + pv_i * sw - corr
#pragma unroll
    for (int dj = 0; dj < kD / 8; ++dj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        o[dj][e] = __fsub_rn(
            __fadd_rn(__fmul_rn(o[dj][e], alpha[r]),
                      __fmul_rn((float)oi[dj][e], sw[r])),
            csum[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const float l = l_run[r];
    float* orow = a.out + (bh * Sq + row) * kD;
    const float inv = __frcp_rn(l > 0.f ? l : 1.f);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8 + t * 2) =
          make_float2(__fmul_rn(o[j][r * 2], inv), __fmul_rn(o[j][r * 2 + 1], inv));
    if (t == 0) a.lse[bh * Sq + row] = l > 0.f ? m_run[r] + logf(l) : kNegInf;
  }
}

template <int BITS, int D, int PT, bool kFull>
int launch_one(const Args& a, int B, cudaStream_t st) {
  using Sh = A8Shape<D, PT>;
  auto kernel = paged_attention_a8_kernel<BITS, D, PT, kFull>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  kernel<<<grid, kThreads, Sh::kSmem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, int D, int PT>
int launch_fill(const Args& a, int B, cudaStream_t st) {
  return a.P == PT ? launch_one<BITS, D, PT, true>(a, B, st)
                   : launch_one<BITS, D, PT, false>(a, B, st);
}

// the smallest tile of 32, 64 or 128 tokens that holds the page
template <int BITS, int D>
int launch_pt(const Args& a, int B, cudaStream_t st) {
  if (a.P <= 32) return launch_fill<BITS, D, 32>(a, B, st);
  if (a.P <= 64) return launch_fill<BITS, D, 64>(a, B, st);
  return launch_fill<BITS, D, 128>(a, B, st);
}

template <int D>
int launch_bits(const Args& a, int B, int bits, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_pt<2, D>(a, B, st);
    case 4: return launch_pt<4, D>(a, B, st);
    case 8: return launch_pt<8, D>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B slots over one pool with int8 activations: q [B, H, Sq, D] bf16;
// page_tables, page_tokens int32 [B, n_max]; n_pages int32 [B]; pools as
// above with any head group G dividing H, D = 32, 64 or 128, pages of P = 8,
// 16, ..., 128 tokens at 2/4/8 bits (1-bit pages take the bf16 kernel).
// Writes out f32 [B, H, Sq, D] and lse f32 [B, H, Sq]. Returns
// cudaErrorInvalidValue for a shape it was not built for.
int dlm_batched_paged_attention_a8(
    const void* q, const void* page_tables, const void* page_tokens,
    const void* n_pages, const void* k_data, const void* k_scale,
    const void* k_zp, const void* v_data, const void* v_scale,
    const void* v_zp, void* out, void* lse, int B, int H, int Sq, int D,
    int n_max, int n_slots, int G, int P, int bits, float sm_scale,
    void* stream) {
  if (G < 1 || H % G != 0 || P < 8 || P > kPmax || P % 8)
    return (int)cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0 || H <= 0) return 0;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const int*>(page_tables),
         static_cast<const int*>(page_tokens),
         static_cast<const int*>(n_pages),
         static_cast<const uint8_t*>(k_data),
         static_cast<const float*>(k_scale),
         static_cast<const float*>(k_zp),
         static_cast<const uint8_t*>(v_data),
         static_cast<const float*>(v_scale),
         static_cast<const float*>(v_zp),
         static_cast<float*>(out),
         static_cast<float*>(lse),
         H, Sq, n_max, n_slots, G, P, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bits<32>(a, B, bits, st);
    case 64: return launch_bits<64>(a, B, bits, st);
    case 128: return launch_bits<128>(a, B, bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
