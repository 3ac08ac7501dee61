// Packed span attention over contiguous rolling rows, for the chunked-
// prefill step (chunk_fn) of a sliding-window model under the contiguous
// KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:519
// (span_attention_rolling, body _rolling_kernel :284).  A rolling row
// keeps position p at slot p % W, W = S (the row is exactly one window
// wide), so a chunk cannot be scattered before it attends.  Token t of
// the packed span (position pos, cache row seq_idx[t], which holds
// positions [0, off = offsets[t])) attends two sources under one running
// fp32 softmax, and the caller scatters the span AFTER this returns:
//
//   1. its old row, slots 0..min(off, S)-1 (slot s stores
//      off-1-((off-1-s) mod S); a row that has not wrapped masks every
//      slot at or past off by never reaching it), counted iff inside the
//      token's window (> pos - W);
//   2. the span's own fresh K/V [T, Kv, hd]: entry u counts iff it is of
//      the same row, at or before pos, inside the window, and u < n_valid
//      (bucket padding duplicates the last valid token).
//
// Grid: one block per (token, kv head).  The body of
// paged_span_attention_rolling.cu over paged::RowRollingSlots instead of
// the table.  Sources, bound and design: paged_attention.cuh.
#include "paged_attention.cuh"

__global__ void __launch_bounds__(paged::kThreads)
span_attention_rolling_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const __nv_bfloat16* __restrict__ k_span,
    const __nv_bfloat16* __restrict__ v_span,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int hd, int R, int S, int tile, int window, int n_valid,
    float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int row = seq_idx[t], pos = positions[t], off = offsets[t];
  // a corrupt batch fails loudly
  assert(row >= 0 && row < R && pos >= off && off >= 0);
  const paged::State s = paged::carve(smem, g, hd, tile);
  const int head0 = kh * g;
  paged::init(q + ((size_t)t * H + head0) * hd, g, hd, s);
  paged::RowRollingSlots old{{k_cache, v_cache, row, S, Kv, kh, hd},
                             off, pos, window, S};
  paged::fold(old, min(off, S), g, hd, tile, scale, s);
  paged::FreshSpan fresh{k_span, v_span, positions, seq_idx, row, pos,
                         window, Kv, kh, hd};
  paged::fold(fresh, min(n_valid, T), g, hd, tile, scale, s);
  paged::finish(out + ((size_t)t * H + head0) * hd, g, hd, s);
}

// q [T, H, hd] bf16; caches [R, S, Kv, hd] bf16 (before the span's
// scatter); k_span/v_span [T, Kv, hd] bf16; positions/seq_idx/offsets [T]
// int32; out [T, H*hd] bf16.
extern "C" int span_attention_rolling(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_span, const void* v_span, const void* positions,
    const void* seq_idx, const void* offsets, void* out, int T, int H,
    int Kv, int hd, int R, int S, int tile, int window, int n_valid,
    float scale, void* stream) {
  if (T == 0) return 0;
  if (window < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err = paged::prepare_smem(span_attention_rolling_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  span_attention_rolling_kernel<<<dim3(T, Kv), paged::kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const __nv_bfloat16*)k_span,
      (const __nv_bfloat16*)v_span, (const int*)positions,
      (const int*)seq_idx, (const int*)offsets, (__nv_bfloat16*)out, T, H, Kv,
      hd, R, S, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}
