// Paged packed span attention for the chunked-prefill step (chunk_fn).
//
// Replaces the TPU kernel repro/kernels/span_attention.py:611
// (paged_span_attention, body _kernel via _paged_kernel), window = 0 only.
// Token t of the packed span attends, for each query head, to logical
// slots 0..positions[t] of block-table row seq_idx[t].  Grid: one block
// per (token, kv head); the block reads seq_idx[t] and positions[t]
// itself (the TPU kernel got them by scalar prefetch) and walks only the
// pages of its prefix.  Body, bound and design: paged_attention.cuh.
#include "paged_attention.cuh"

__global__ void __launch_bounds__(paged::kThreads)
paged_span_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_cache,
                            const __nv_bfloat16* __restrict__ v_cache,
                            const int* __restrict__ tables,
                            const int* __restrict__ positions,
                            const int* __restrict__ seq_idx,
                            __nv_bfloat16* __restrict__ out, int H, int Kv,
                            int hd, int bs, int B, int nb, int n_blocks,
                            int tile, float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t];
  const int pos = positions[t];
  assert(row >= 0 && row < B && pos >= 0);  // a corrupt batch fails loudly
  paged::attend(q + (size_t)t * H * hd, k_cache, v_cache,
                tables + (size_t)row * nb, min(pos + 1, nb * bs), kh, Kv,
                H / Kv, hd, bs, n_blocks, tile, scale,
                out + (size_t)t * H * hd);
}

extern "C" int paged_span_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* tables,
                                    const void* positions, const void* seq_idx,
                                    void* out, int T, int H, int Kv, int hd,
                                    int bs, int B, int nb, int n_blocks,
                                    int tile, float scale, void* stream) {
  if (T == 0) return 0;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err = paged::prepare_smem(paged_span_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_kernel<<<dim3(T, Kv), paged::kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)tables,
      (const int*)positions, (const int*)seq_idx, (__nv_bfloat16*)out, H, Kv,
      hd, bs, B, nb, n_blocks, tile, scale);
  return (int)cudaGetLastError();
}
