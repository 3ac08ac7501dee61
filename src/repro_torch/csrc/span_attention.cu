// Packed span attention over contiguous cache rows, for the chunked-prefill
// step (chunk_fn) under the contiguous KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:132
// (span_attention, body _kernel :76), window = 0 only (windowed models
// keep rolling rows: span_attention_rolling.cu).  Token t of the packed
// span attends, for each query head, to slots 0..positions[t] of row
// seq_idx[t] of [R, S, Kv, hd] caches (the engine passes each token's
// cache row, so the caches are its whole row pool, written in place).
// Grid: one block per (token, kv head); the block reads its row and
// position itself (the TPU kernel got them by scalar prefetch) and walks
// only the slots of its prefix.  The same body as
// paged_span_attention.cu over paged::RowSlots instead of the table, so
// the two layouts give identical outputs.  Body, bound and design:
// paged_attention.cuh.
#include "paged_attention.cuh"

__global__ void __launch_bounds__(paged::kThreads)
span_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_cache,
                      const __nv_bfloat16* __restrict__ v_cache,
                      const int* __restrict__ positions,
                      const int* __restrict__ seq_idx,
                      __nv_bfloat16* __restrict__ out, int H, int Kv, int hd,
                      int R, int S, int tile, float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t], pos = positions[t];
  assert(row >= 0 && row < R && pos >= 0);  // a corrupt batch fails loudly
  paged::attend_source(q + (size_t)t * H * hd,
                       paged::RowSlots{k_cache, v_cache, row, S, Kv, kh, hd},
                       min(pos + 1, S), kh, H / Kv, hd, tile, scale,
                       out + (size_t)t * H * hd);
}

// q [T, H, hd] bf16; caches [R, S, Kv, hd] bf16; positions/seq_idx [T]
// int32; out [T, H*hd] bf16.
extern "C" int span_attention(const void* q, const void* k_cache,
                              const void* v_cache, const void* positions,
                              const void* seq_idx, void* out, int T, int H,
                              int Kv, int hd, int R, int S, int tile,
                              float scale, void* stream) {
  if (T == 0) return 0;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err = paged::prepare_smem(span_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  span_attention_kernel<<<dim3(T, Kv), paged::kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)positions,
      (const int*)seq_idx, (__nv_bfloat16*)out, H, Kv, hd, R, S, tile, scale);
  return (int)cudaGetLastError();
}
