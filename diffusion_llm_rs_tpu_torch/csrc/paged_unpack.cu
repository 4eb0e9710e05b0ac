// The unpack pass of batched paged attention, for Hopper (sm_90a).
//
// Together with csrc/batched_paged_attention.cu (bf16 activations) and
// csrc/paged_attention_a8.cu (int8 activations) it replaces the TPU kernel
// `_batched_kernel` (diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:288,
// behind `batched_paged_attention`, :686). The TPU kernel keeps a slot's whole
// query sequence in one grid cell "so each page is DMA'd and unpacked exactly
// ONCE per (slot, head-group)"; on the card a block holds 128 or 192
// queries, so this pass unpacks each live page of each (slot, head) once per
// call into a scratch that every query tile's block then streams by TMA (the
// layouts are in csrc/paged_flash.cuh). It is the only kernel of the path that knows
// the bit width and the pools' packing:
//   pools: data uint8 [n_slots, H/G, P/vpb, G*D], token-block packed (byte
//   (r, d) holds the levels of tokens r + p*P/vpb in bit field p); sidecars
//   f32 [n_slots, H/G, G*P]; head h reads lanes (h%G)*D.. and sidecar columns
//   (h%G)*P.. of group h/G.
// Every value is rounded as the plain twin (`paged_unpack_plain`) rounds it,
// so the two agree bit for bit: bf16 mode writes K levels as bf16 (exact),
// V as bf16(f32(v_lv * vs)), and ka' = ks * sm, kb = ka' * kz, vc = vs * vz;
// int8 mode writes lv - off as int8 (K [token][d], V^T [d][token] with the
// columns of each 32 tokens in `vt_col` order), and ka' = ks * sm, kb' = ka'
// * (kz - off), vs, vz - off. Rows, columns and sidecars past P are 0; pages
// past n_pages[b] are not written. A slot id outside the pool traps. Heads
// of D (any multiple of 8) are written as rows of DK, the smallest of 16,
// 32, 64, 128, 192 and 256 that holds D (the width of the attention
// kernel's instance), or past 256 D rounded up to 64 (the chunk of the wide
// instance, csrc/wide_flash.cuh), zero past D; a pool row of D bytes is
// read 16 bytes at a time, or 8 where D % 16 != 0.
//
// One block of 128 threads per (page, head, slot). What bounds it: bytes. At
// serve_paged (B = 2, H = 12, 32 pages of 128 tokens, D = 64, 4 bits) it
// reads 3.1 MB of packed levels and 1.6 MB of sidecars and writes a 25 MiB
// (bf16 layout) or 13.5 MiB (int8) scratch: 0.010 / 0.007 ms at 3.35 TB/s,
// against about 0.02 / 0.009 ms measured (PERF.md). The int8 layout's V^T
// is transposed through shared memory so its rows go out as 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128, kPmax = 128;

struct Args {
  const int* page_tables;  // [B, n_max]
  const int* n_pages;      // [B]
  const uint8_t* k_data;   // [n_slots, H/G, P/vpb, G*D]
  const float* k_scale;    // [n_slots, H/G, G*P]
  const float* k_zp;
  const uint8_t* v_data;
  const float* v_scale;
  const float* v_zp;
  void* k_out;             // [B, H, n_max, PT, DK]
  void* v_out;             // bf16 [B, H, n_max, PT, DK]; int8 [.., DK, PT]
  float* side_out;         // [B, H, n_max, 3 or 4, PT]
  int H, D, n_max, n_slots, G, P, PT;
  float sm;
  int DK;                  // last: the exact instances' parameters keep
                           // their offsets (and code) from before padding
};

// Column of token `tok` in a V^T row: within each group of 32 tokens, token
// i2*8 + t*2 + e (n-block i2 of 4, lane t of 4, element e of 2) moves to
// (i2/2)*16 + t*4 + (i2%2)*2 + e: the order in which a thread of the int8
// P.V product holds its weights in the register A operand.
__device__ __forceinline__ int vt_col(int tok) {
  const int i2 = (tok >> 3) & 3, tt = (tok >> 1) & 3, e = tok & 1;
  return (tok & ~31) + (i2 >> 1) * 16 + tt * 4 + (i2 & 1) * 2 + e;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// CW: bytes of a pool row read at once (16, or 8 where D % 16 != 0). PAD:
// D < DK, so the columns past D are zeroed; without it D = DK and the
// kernel is the one that served the kernel widths alone.
template <int BITS, bool A8, int CW, bool PAD>
__global__ void __launch_bounds__(kThreads) paged_unpack_kernel(const Args a) {
  constexpr int kVpb = 8 / BITS, kMask = (1 << BITS) - 1;
  constexpr uint32_t kMask4 = 0x01010101u * kMask;
  constexpr uint32_t kOff4 = 0x01010101u * (1u << (BITS - 1));
  constexpr float kOff = (float)(1 << (BITS - 1));
  extern __shared__ __align__(16) uint8_t smem[];  // int8: V^T [DK][PT]
  __shared__ float s_vs[kPmax];                    // bf16: V scales

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (j >= a.n_pages[b]) return;
  const int slot = a.page_tables[(size_t)b * a.n_max + j];
  if (slot < 0 || slot >= a.n_slots) __trap();
  const int D = a.D, DK = PAD ? a.DK : a.D, P = a.P, PT = a.PT, G = a.G, HG = a.H / G;
  const int hg = h / G, hl = h % G, GD = G * D, Pp = P / kVpb;
  const size_t side_in = ((size_t)slot * HG + hg) * G * P + (size_t)hl * P;
  const size_t base_in = ((size_t)slot * HG + hg) * Pp * GD + (size_t)hl * D;
  const size_t page = ((size_t)b * a.H + h) * a.n_max + j;
  constexpr int kSide = A8 ? 4 : 3;
  float* side = a.side_out + page * kSide * PT;

  for (int i = threadIdx.x; i < PT; i += kThreads) {
    const bool in = i < P;
    const float ka = in ? __fmul_rn(a.k_scale[side_in + i], a.sm) : 0.f;
    const float kz = in ? a.k_zp[side_in + i] : 0.f;
    const float vs = in ? a.v_scale[side_in + i] : 0.f;
    const float vz = in ? a.v_zp[side_in + i] : 0.f;
    side[i] = ka;
    if (A8) {
      side[PT + i] = in ? __fmul_rn(ka, __fsub_rn(kz, kOff)) : 0.f;
      side[2 * PT + i] = vs;
      side[3 * PT + i] = in ? __fsub_rn(vz, kOff) : 0.f;
    } else {
      side[PT + i] = __fmul_rn(ka, kz);
      side[2 * PT + i] = __fmul_rn(vs, vz);
      s_vs[i] = vs;
    }
  }
  uint8_t* vt = smem;
  if (A8) {  // V^T starts as zeros: the columns of tokens past P, and the
             // rows past D, stay so
    for (int c = threadIdx.x; c < DK * PT / 16; c += kThreads)
      reinterpret_cast<uint4*>(vt)[c] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // CW packed bytes of one row -> CW levels of kVpb token rows each
  const int eb = A8 ? 1 : 2;  // bytes an output element
  uint8_t* k_out = static_cast<uint8_t*>(a.k_out) + page * PT * DK * eb;
  uint8_t* v_out = static_cast<uint8_t*>(a.v_out) + page * PT * DK * eb;
  using W = typename std::conditional<CW == 16, uint4, uint2>::type;
  constexpr int kWords = CW / 4;
  for (int c = threadIdx.x; c < Pp * (D / CW); c += kThreads) {
    const int r = c / (D / CW), col = (c % (D / CW)) * CW;
    const size_t off = base_in + (size_t)r * GD + col;
    const W kw = *reinterpret_cast<const W*>(a.k_data + off);
    const W vw = *reinterpret_cast<const W*>(a.v_data + off);
#pragma unroll
    for (int p = 0; p < kVpb; ++p) {
      const int tok = r + p * Pp;
      if (A8) {
        const uint32_t* kx = reinterpret_cast<const uint32_t*>(&kw);
        const uint32_t* vx = reinterpret_cast<const uint32_t*>(&vw);
        uint32_t kc[kWords];
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          kc[i] = __vsub4((kx[i] >> (p * BITS)) & kMask4, kOff4);
          const uint32_t vc = __vsub4((vx[i] >> (p * BITS)) & kMask4, kOff4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vt[(col + 4 * i + e) * PT + vt_col(tok)] = (uint8_t)(vc >> (8 * e));
        }
        W* kd = reinterpret_cast<W*>(k_out + (size_t)tok * DK + col);
        if constexpr (CW == 16)
          *kd = make_uint4(kc[0], kc[1], kc[2], kc[3]);
        else
          *kd = make_uint2(kc[0], kc[1]);
      } else {
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kw);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vw);
        const float vsc = s_vs[tok];
        uint32_t kk[CW / 2], vv[CW / 2];
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) {
          const float k0 = (float)((kb[2 * i] >> (p * BITS)) & kMask);
          const float k1 = (float)((kb[2 * i + 1] >> (p * BITS)) & kMask);
          const float v0 = (float)((vb[2 * i] >> (p * BITS)) & kMask);
          const float v1 = (float)((vb[2 * i + 1] >> (p * BITS)) & kMask);
          kk[i] = pack_bf16(k0, k1);
          vv[i] = pack_bf16(__fmul_rn(v0, vsc), __fmul_rn(v1, vsc));
        }
        uint4* kd = reinterpret_cast<uint4*>(k_out + ((size_t)tok * DK + col) * 2);
        uint4* vd = reinterpret_cast<uint4*>(v_out + ((size_t)tok * DK + col) * 2);
#pragma unroll
        for (int i = 0; i < CW / 8; ++i)
          kd[i] = make_uint4(kk[4 * i], kk[4 * i + 1], kk[4 * i + 2],
                             kk[4 * i + 3]);
#pragma unroll
        for (int i = 0; i < CW / 8; ++i)
          vd[i] = make_uint4(vv[4 * i], vv[4 * i + 1], vv[4 * i + 2],
                             vv[4 * i + 3]);
      }
    }
  }
  // columns [D, DK) of token rows [0, P) of K (and of bf16 V) are 0, in
  // units of 8 bytes
  if constexpr (PAD) {
    const int units = (DK - D) * eb / 8;
    for (int c = threadIdx.x; c < P * units; c += kThreads) {
      const size_t at = ((size_t)(c / units) * DK + D) * eb + (c % units) * 8;
      *reinterpret_cast<uint2*>(k_out + at) = make_uint2(0, 0);
      if (!A8) *reinterpret_cast<uint2*>(v_out + at) = make_uint2(0, 0);
    }
  }
  // token rows [P, PT) of K (and of bf16 V) are 0
  const int row16 = DK * eb / 16;
  for (int c = threadIdx.x; c < (PT - P) * row16; c += kThreads) {
    const size_t at = ((size_t)P * row16 + c) * 16;
    *reinterpret_cast<uint4*>(k_out + at) = make_uint4(0, 0, 0, 0);
    if (!A8) *reinterpret_cast<uint4*>(v_out + at) = make_uint4(0, 0, 0, 0);
  }
  if (A8) {
    __syncthreads();
    for (int c = threadIdx.x; c < DK * PT / 16; c += kThreads)
      reinterpret_cast<uint4*>(v_out)[c] = reinterpret_cast<const uint4*>(vt)[c];
  }
}

// The int8 layout at rows wider than 256 (the wide attention instances'
// scratch): V^T [DK][PT] would outgrow shared memory, so it goes through it
// 64 rows at a time; otherwise as paged_unpack_kernel<BITS, true, CW, true>.
template <int BITS, int CW>
__global__ void __launch_bounds__(kThreads) paged_unpack_a8_wide(const Args a) {
  constexpr int kVpb = 8 / BITS;
  constexpr uint32_t kMask4 = 0x01010101u * ((1 << BITS) - 1);
  constexpr uint32_t kOff4 = 0x01010101u * (1u << (BITS - 1));
  constexpr float kOff = (float)(1 << (BITS - 1));
  constexpr int kRows = 64;                        // V^T rows a pass
  extern __shared__ __align__(16) uint8_t vt[];    // [kRows][PT]

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (j >= a.n_pages[b]) return;
  const int slot = a.page_tables[(size_t)b * a.n_max + j];
  if (slot < 0 || slot >= a.n_slots) __trap();
  const int D = a.D, DK = a.DK, P = a.P, PT = a.PT, G = a.G, HG = a.H / G;
  const int hg = h / G, hl = h % G, GD = G * D, Pp = P / kVpb;
  const size_t side_in = ((size_t)slot * HG + hg) * G * P + (size_t)hl * P;
  const size_t base_in = ((size_t)slot * HG + hg) * Pp * GD + (size_t)hl * D;
  const size_t page = ((size_t)b * a.H + h) * a.n_max + j;
  float* side = a.side_out + page * 4 * PT;
  for (int i = threadIdx.x; i < PT; i += kThreads) {
    const bool in = i < P;
    const float ka = in ? __fmul_rn(a.k_scale[side_in + i], a.sm) : 0.f;
    const float kz = in ? a.k_zp[side_in + i] : 0.f;
    side[i] = ka;
    side[PT + i] = in ? __fmul_rn(ka, __fsub_rn(kz, kOff)) : 0.f;
    side[2 * PT + i] = in ? a.v_scale[side_in + i] : 0.f;
    side[3 * PT + i] = in ? __fsub_rn(a.v_zp[side_in + i], kOff) : 0.f;
  }
  uint8_t* k_out = static_cast<uint8_t*>(a.k_out) + page * PT * DK;
  uint8_t* v_out = static_cast<uint8_t*>(a.v_out) + page * PT * DK;
  using W = typename std::conditional<CW == 16, uint4, uint2>::type;
  constexpr int kWords = CW / 4;
  for (int d0 = 0; d0 < DK; d0 += kRows) {
    for (int c = threadIdx.x; c < kRows * PT / 16; c += kThreads)
      reinterpret_cast<uint4*>(vt)[c] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int units = max(0, min(kRows, D - d0)) / CW;
    for (int c = threadIdx.x; c < Pp * units; c += kThreads) {
      const int r = c / units, col = d0 + (c % units) * CW;
      const size_t off = base_in + (size_t)r * GD + col;
      const W kw = *reinterpret_cast<const W*>(a.k_data + off);
      const W vw = *reinterpret_cast<const W*>(a.v_data + off);
      const uint32_t* kx = reinterpret_cast<const uint32_t*>(&kw);
      const uint32_t* vx = reinterpret_cast<const uint32_t*>(&vw);
#pragma unroll
      for (int p = 0; p < kVpb; ++p) {
        const int tok = r + p * Pp;
        uint32_t kc[kWords];
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          kc[i] = __vsub4((kx[i] >> (p * BITS)) & kMask4, kOff4);
          const uint32_t vc = __vsub4((vx[i] >> (p * BITS)) & kMask4, kOff4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vt[(col - d0 + 4 * i + e) * PT + vt_col(tok)] = (uint8_t)(vc >> (8 * e));
        }
        W* kd = reinterpret_cast<W*>(k_out + (size_t)tok * DK + col);
        if constexpr (CW == 16)
          *kd = make_uint4(kc[0], kc[1], kc[2], kc[3]);
        else
          *kd = make_uint2(kc[0], kc[1]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kRows * PT / 16; c += kThreads)
      reinterpret_cast<uint4*>(v_out + (size_t)d0 * PT)[c] =
          reinterpret_cast<const uint4*>(vt)[c];
    __syncthreads();
  }
  // columns [D, DK) of token rows [0, P) of K, and its rows [P, PT), are 0
  const int units = (DK - D) / 8;
  for (int c = threadIdx.x; c < P * units; c += kThreads)
    *reinterpret_cast<uint2*>(k_out + (size_t)(c / units) * DK + D +
                              (c % units) * 8) = make_uint2(0, 0);
  const int row16 = DK / 16;
  for (int c = threadIdx.x; c < (PT - P) * row16; c += kThreads)
    reinterpret_cast<uint4*>(k_out + (size_t)P * DK)[c] = make_uint4(0, 0, 0, 0);
}

template <int BITS, bool A8>
int launch(const Args& a, int B, cudaStream_t stream) {
  dim3 grid(a.n_max, a.H, B);
  if constexpr (A8) {
    if (a.DK > 256) {
      auto kernel = a.D % 16 ? paged_unpack_a8_wide<BITS, 8>
                             : paged_unpack_a8_wide<BITS, 16>;
      kernel<<<grid, kThreads, 64 * a.PT, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  auto kernel = a.D % 16    ? paged_unpack_kernel<BITS, A8, 8, true>
                : a.D < a.DK ? paged_unpack_kernel<BITS, A8, 16, true>
                             : paged_unpack_kernel<BITS, A8, 16, false>;
  const int smem = A8 ? a.DK * a.PT : 0;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Unpack the first n_pages[b] pages of each slot's table, for every head,
// into k_out, v_out, side_out (the layouts above; a8 = 1: int8 mode). D a
// multiple of 8, written as rows of DK (16, 32, 64, 128, 192 or 256, the
// smallest >= D; past 256, D rounded up to 64); P a multiple of 8 up to 128
// with whole packed rows;
// PT = 32, 64 or 128, at least P; 1/2/4/8 bits (2/4/8 in int8 mode).
// Returns cudaErrorInvalidValue for anything else.
int dlm_paged_unpack(const void* page_tables, const void* n_pages,
                     const void* k_data, const void* k_scale, const void* k_zp,
                     const void* v_data, const void* v_scale, const void* v_zp,
                     void* k_out, void* v_out, void* side_out, int B, int H,
                     int D, int n_max, int n_slots, int G, int P, int PT,
                     int bits, int a8, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n_max <= 0) return 0;
  const int DK = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128
                 : D <= 192 ? 192 : D <= 256 ? 256 : (D + 63) / 64 * 64;
  if (D < 8 || D % 8 || P < 8 || P > kPmax ||
      P % 8 || PT < P || (PT != 32 && PT != 64 && PT != 128) || G < 1 || H % G ||
      (a8 && bits == 1))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(page_tables), static_cast<const int*>(n_pages),
         static_cast<const uint8_t*>(k_data), static_cast<const float*>(k_scale),
         static_cast<const float*>(k_zp), static_cast<const uint8_t*>(v_data),
         static_cast<const float*>(v_scale), static_cast<const float*>(v_zp),
         k_out, v_out, static_cast<float*>(side_out),
         H, D, n_max, n_slots, G, P, PT, sm_scale, DK};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits * 2 + (a8 ? 1 : 0)) {
    case 2: return launch<1, false>(a, B, st);
    case 4: return launch<2, false>(a, B, st);
    case 5: return launch<2, true>(a, B, st);
    case 8: return launch<4, false>(a, B, st);
    case 9: return launch<4, true>(a, B, st);
    case 16: return launch<8, false>(a, B, st);
    case 17: return launch<8, true>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
