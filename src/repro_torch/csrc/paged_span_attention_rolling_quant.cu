// Paged packed span attention for sliding-window models over the int8
// rolling cache, for the chunked-prefill step (chunk_fn) of a windowed
// kv_quant model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:761
// (paged_span_attention_rolling_quant, body _paged_rolling_quant_kernel).
// The two sources of paged_span_attention_rolling.cu under one running
// fp32 softmax, attended before the caller scatters the span:
//
//   1. the old int8 rolling cache through block-table row seq_idx[t],
//      slots 0..min(off, nb * bs)-1 (slot s stores position
//      off-1-((off-1-s) mod nb*bs), counted iff inside the token's
//      window), walked in tiles of `tile` slots with the int8 math of
//      paged_span_attention_quant.cu: exact __dp4a dots against the query
//      quantized per head, and p * vs quantized per tile and head before
//      the exact int8 AV dot.  The tile is the p-quantization tile, so it
//      is part of the function: the reference engine off the TPU uses
//      kv_block = 512 clipped and halved until it divides nb * bs
//      (attention.py:968); tiles start at slot 0, as there.  Masked slots
//      inside a tile score -1e30, so their probabilities are exactly 0;
//   2. the span's own fresh bf16 K/V [T, Kv, hd], with full-precision
//      dots (the reference keeps them so: the span is not quantized until
//      it is scattered), through paged::fold and paged::FreshSpan.
//
// Grid: one block per (token, kv head).  Body (pquant::rolling_span),
// numerics and bound: paged_attention_quant.cuh and paged_attention.cuh.
#include "paged_attention_quant.cuh"

__global__ void __launch_bounds__(pquant::kThreads)
paged_span_attention_rolling_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs,
    const __nv_bfloat16* __restrict__ k_span,
    const __nv_bfloat16* __restrict__ v_span, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int hd, int bs, int B, int nb, int n_blocks, int tile,
    int window, int n_valid, float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t], pos = positions[t], off = offsets[t];
  // a corrupt batch fails loudly
  assert(row >= 0 && row < B && pos >= off && off >= 0);
  const int* table = tables + (size_t)row * nb;
  const int w_slots = nb * bs;
  const int n_old = min(off, w_slots);
  pquant::check_table(table, n_old, bs, n_blocks);
  pquant::rolling_span(
      q + (size_t)t * H * hd, k8, ks, v8, vs,
      pquant::PagedIndex{table, bs, Kv, kh}, n_old,
      pquant::WindowMask{off, pos, window, w_slots},
      paged::FreshSpan{k_span, v_span, positions, seq_idx, row, pos, window,
                       Kv, kh, hd},
      min(n_valid, T), kh, H / Kv, hd, tile, scale, out + (size_t)t * H * hd);
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8 and ks/vs
// [n_blocks, bs, Kv] bf16 (before the span's scatter); k_span/v_span
// [T, Kv, hd] bf16; tables [B, nb], positions/seq_idx/offsets [T] int32;
// out [T, H*hd] bf16.  hd must be a multiple of 16.
extern "C" int paged_span_attention_rolling_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* k_span, const void* v_span,
    const void* tables, const void* positions, const void* seq_idx,
    const void* offsets, void* out, int T, int H, int Kv, int hd, int bs,
    int B, int nb, int n_blocks, int tile, int window, int n_valid,
    float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1 || window < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::rolling_smem_bytes(H / Kv, hd, tile);
  cudaError_t err =
      pquant::prepare_smem(paged_span_attention_rolling_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_rolling_quant_kernel<<<
      dim3(T, Kv), pquant::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const __nv_bfloat16*)k_span,
      (const __nv_bfloat16*)v_span, (const int*)tables, (const int*)positions,
      (const int*)seq_idx, (const int*)offsets, (__nv_bfloat16*)out, T, H, Kv,
      hd, bs, B, nb, n_blocks, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}
