// Flash attention over one paged, quantized KV sequence, for Hopper
// (sm_90a): the kernel of `PagedKVCache.attend`.
//
// Replaces the TPU kernel `_kernel` (diffusion_llm_rs_tpu/ops/
// pallas_paged_attention.py:34, behind `paged_attention`, :140): one
// sequence's page chain, walked page by page, each page's packed K/V levels
// unpacked once a block and an online softmax run over them; it returns the
// lse beside the output so that partials merge. Pools keep the JAX layout
// with head groups of one: data uint8 [n_slots, BH, P/vpb, D] packed along
// tokens, sidecars f32 [n_slots, BH, P]. The kernel, its design and its
// arithmetic are `quant_flash_kernel<Paged<BITS, D, PT>, D>` in
// csrc/quant_flash.cuh: a page of P tokens (any multiple of 8 up to 128)
// runs in the smallest tile of PT = 32, 64 or 128 tokens that holds it, and
// its rows past P are zero. (The batched kernels are csrc/paged_unpack.cu and
// csrc/paged_flash.cuh.)
//
// What bounds it on an H100: at the PagedKVCache shape (BH = 12, Sq = 1024,
// 8 pages of 128, D = 64) the dots are 4*BH*Sq*Skv*D = 3.2 GFLOP, so the bf16
// tensor cores bound it (0.003 ms); its 96 blocks of 128 queries each unpack
// every page once, where the first version's 64-query blocks unpacked each
// page 16 times a head.

#include "quant_flash.cuh"

namespace {

using namespace quant_flash;

template <int BITS, int D>
int launch_pt(const PagedArgs& la, const Out& oa, int BH, cudaStream_t st) {
  if (la.P <= 32) return launch<Paged<BITS, D, 32>, D>(la, oa, BH, st);
  if (la.P <= 64) return launch<Paged<BITS, D, 64>, D>(la, oa, BH, st);
  return launch<Paged<BITS, D, 128>, D>(la, oa, BH, st);
}

template <int D>
int launch_bits(const PagedArgs& la, const Out& oa, int BH, int bits,
                cudaStream_t st) {
  switch (bits) {
    case 1: return launch_pt<1, D>(la, oa, BH, st);
    case 2: return launch_pt<2, D>(la, oa, BH, st);
    case 4: return launch_pt<4, D>(la, oa, BH, st);
    case 8: return launch_pt<8, D>(la, oa, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One sequence: q [BH, Sq, D] bf16 (16-byte aligned); page_table,
// page_tokens int32 [n_pages] (n_pages >= 1); pools [n_slots, BH, P/vpb, D]
// and [n_slots, BH, P] (16-byte aligned) with D = 16, 32, 64 or 128 and
// pages of P = 8, 16, ..., 128 tokens at 1/2/4/8 bits. Writes out f32
// [BH, Sq, D] and lse f32 [BH, Sq]. A slot outside the pool traps. Returns
// cudaErrorInvalidValue for a shape it was not built for.
int dlm_paged_attention(const void* q, const void* page_table,
                        const void* page_tokens, const void* k_data,
                        const void* k_scale, const void* k_zp,
                        const void* v_data, const void* v_scale,
                        const void* v_zp, void* out, void* lse, int BH,
                        int Sq, int D, int n_pages, int n_slots, int P,
                        int bits, float sm_scale, void* stream) {
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
                     n_pages, n_slots, BH, P};
  const Out oa{static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out),
               static_cast<float*>(lse), Sq, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bits<16>(la, oa, BH, bits, st);
    case 32: return launch_bits<32>(la, oa, BH, bits, st);
    case 64: return launch_bits<64>(la, oa, BH, bits, st);
    case 128: return launch_bits<128>(la, oa, BH, bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
