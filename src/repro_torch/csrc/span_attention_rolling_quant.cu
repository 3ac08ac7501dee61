// Packed span attention over contiguous int8 rolling rows, for the
// chunked-prefill step (chunk_fn) of a windowed kv_quant model under the
// contiguous KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:456
// (span_attention_rolling_quant, body _rolling_quant_kernel :358).  The
// two sources of span_attention_rolling.cu under one running fp32
// softmax, attended before the caller scatters the span:
//
//   1. the old int8 row seq_idx[t] ([R, S, Kv, hd] with [R, S, Kv] bf16
//      scales, S = W), slots 0..min(off, S)-1, counted iff the position
//      slot s stores, off-1-((off-1-s) mod S), lies inside the token's
//      window, in tiles of `tile` slots with exact __dp4a dots and p * vs
//      quantized per tile and head.  The tile is the p-quantization tile,
//      part of the function: kv_block = 512 halved until it divides S, as
//      the Pallas kernel and its jnp oracle pick it; tiles start at slot 0;
//   2. the span's own fresh bf16 K/V [T, Kv, hd] with full-precision dots.
//
// Grid: one block per (token, kv head).  The body of
// paged_span_attention_rolling_quant.cu (pquant::rolling_span) over
// pquant::RowIndex instead of the table.  Numerics and bound:
// paged_attention_quant.cuh and paged_attention.cuh.
#include "paged_attention_quant.cuh"

__global__ void __launch_bounds__(pquant::kThreads)
span_attention_rolling_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs,
    const __nv_bfloat16* __restrict__ k_span,
    const __nv_bfloat16* __restrict__ v_span,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int hd, int R, int S, int tile, int window, int n_valid,
    float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t], pos = positions[t], off = offsets[t];
  // a corrupt batch fails loudly
  assert(row >= 0 && row < R && pos >= off && off >= 0);
  pquant::rolling_span(
      q + (size_t)t * H * hd, k8, ks, v8, vs,
      pquant::RowIndex{row, S, Kv, kh}, min(off, S),
      pquant::WindowMask{off, pos, window, S},
      paged::FreshSpan{k_span, v_span, positions, seq_idx, row, pos, window,
                       Kv, kh, hd},
      min(n_valid, T), kh, H / Kv, hd, tile, scale, out + (size_t)t * H * hd);
}

// q [T, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8 and ks/vs [R, S, Kv] bf16
// (before the span's scatter); k_span/v_span [T, Kv, hd] bf16;
// positions/seq_idx/offsets [T] int32; out [T, H*hd] bf16.  hd must be a
// multiple of 16.
extern "C" int span_attention_rolling_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* k_span, const void* v_span,
    const void* positions, const void* seq_idx, const void* offsets,
    void* out, int T, int H, int Kv, int hd, int R, int S, int tile,
    int window, int n_valid, float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1 || window < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::rolling_smem_bytes(H / Kv, hd, tile);
  cudaError_t err =
      pquant::prepare_smem(span_attention_rolling_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  span_attention_rolling_quant_kernel<<<dim3(T, Kv), pquant::kThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const __nv_bfloat16*)k_span,
      (const __nv_bfloat16*)v_span, (const int*)positions,
      (const int*)seq_idx, (const int*)offsets, (__nv_bfloat16*)out, T, H, Kv,
      hd, R, S, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}
