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
// arithmetic are `quant_flash_kernel<Paged<BITS, D, PT, false>, D>` in
// csrc/quant_flash.cuh: a page of P tokens (any multiple of 8 up to 128)
// runs in the smallest tile of PT = 32, 64 or 128 tokens that holds it (at
// D >= 192 a page of more than 64 runs as two tiles of 64), and its rows
// past P are zero. Heads of D = 16, 32, 64, 128, 192 and 256 are built
// here; the other multiples of 8 up to 256 run padded to those widths
// (csrc/quant_flash_paged_padded.cu). (The batched kernels are csrc/paged_unpack.cu and
// csrc/paged_flash.cuh.)
//
// What bounds it on an H100: at the PagedKVCache shape (BH = 12, Sq = 1024,
// 8 pages of 128, D = 64) the dots are 4*BH*Sq*Skv*D = 3.2 GFLOP, so the bf16
// tensor cores bound it (0.003 ms); its 96 blocks of 128 queries each unpack
// every page once, where the first version's 64-query blocks unpacked each
// page 16 times a head.

#include "quant_flash.cuh"

extern "C" {

// One sequence: q [BH, Sq, D] bf16 (16-byte aligned); page_table,
// page_tokens int32 [n_pages] (n_pages >= 1); pools [n_slots, BH, P/vpb, D]
// and [n_slots, BH, P] (16-byte aligned) with D = 16, 32, 64, 128, 192 or
// 256 (other multiples of 8 up to 256: csrc/quant_flash_paged_padded.cu)
// and pages of P = 8, 16, ..., 128 tokens at 1/2/4/8 bits. Writes out f32
// [BH, Sq, D] and lse f32 [BH, Sq]. A slot outside the pool traps. Returns
// cudaErrorInvalidValue for a shape it was not built for.
int dlm_paged_attention(const void* q, const void* page_table,
                        const void* page_tokens, const void* k_data,
                        const void* k_scale, const void* k_zp,
                        const void* v_data, const void* v_scale,
                        const void* v_zp, void* out, void* lse, int BH,
                        int Sq, int D, int n_pages, int n_slots, int P,
                        int bits, float sm_scale, void* stream) {
  return quant_flash::paged_attention<false>(
      q, page_table, page_tokens, k_data, k_scale, k_zp, v_data, v_scale,
      v_zp, out, lse, BH, Sq, D, n_pages, n_slots, P, bits, sm_scale, stream);
}

}  // extern "C"
