// Paged single-token attention for the pure-decode step (decode_fn).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:72
// (decode_attention, body _kernel), which read contiguous cache rows
// [B, S, Kv, hd] up to lengths[b]; this kernel reads K/V through the
// [B, nb] block table instead of a gathered view, over
// length = positions[b] + 1 slots.  Grid: one block per (row, kv head).
//
// Rolling mode (window > 0; the port's own, for sliding-window models,
// whose cache holds position p at slot p % W): the reference runs the jnp
// decode_attention(rolling_window=W) on the gathered view there
// (repro/models/transformer.py:102-146), whose visible slots are
// 0..min(positions[b] + 1, W) - 1.  The new token's K/V is already in
// its slot; every visible slot is valid, so the kernel is the full-cache
// one over a shorter slot range.
//
// Contiguous mode (contiguous_decode_attention; the contiguous KV layout):
// the TPU kernel's own layout, row rows[b] of [R, S, Kv, hd] caches over
// lengths = positions[b] + 1 slots (rolling: min(positions[b] + 1, W)),
// through paged::RowSlots instead of the table: the reference runs the
// jnp decode_attention on its cache rows there (transformer.py:145-167).
// Body, bound and design: paged_attention.cuh.  Split-K over long
// caches is left for later (B * Kv blocks must fill the 132 SMs alone).
#include "paged_attention.cuh"

__global__ void __launch_bounds__(paged::kThreads)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_cache,
                              const __nv_bfloat16* __restrict__ v_cache,
                              const int* __restrict__ tables,
                              const int* __restrict__ positions,
                              __nv_bfloat16* __restrict__ out, int H, int Kv,
                              int hd, int bs, int nb, int n_blocks, int tile,
                              int window, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int pos = positions[b];
  assert(pos >= 0);  // a corrupt batch fails loudly
  const int n = window ? min(pos + 1, window) : pos + 1;
  paged::attend(q + (size_t)b * H * hd, k_cache, v_cache,
                tables + (size_t)b * nb, min(n, nb * bs), kh, Kv, H / Kv, hd,
                bs, n_blocks, tile, scale, out + (size_t)b * H * hd);
}

extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* tables,
                                      const void* positions, void* out, int B,
                                      int H, int Kv, int hd, int bs, int nb,
                                      int n_blocks, int tile, int window,
                                      float scale, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err = paged::prepare_smem(paged_decode_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_attention_kernel<<<dim3(B, Kv), paged::kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)tables,
      (const int*)positions, (__nv_bfloat16*)out, H, Kv, hd, bs, nb, n_blocks,
      tile, window, scale);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(paged::kThreads)
contiguous_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k_cache,
                                   const __nv_bfloat16* __restrict__ v_cache,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ positions,
                                   __nv_bfloat16* __restrict__ out, int H,
                                   int Kv, int hd, int R, int S, int tile,
                                   int window, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int row = rows[b], pos = positions[b];
  assert(row >= 0 && row < R && pos >= 0);  // a corrupt batch fails loudly
  const int n = window ? min(pos + 1, window) : pos + 1;
  paged::attend_source(q + (size_t)b * H * hd,
                       paged::RowSlots{k_cache, v_cache, row, S, Kv, kh, hd},
                       min(n, S), kh, H / Kv, hd, tile, scale,
                       out + (size_t)b * H * hd);
}

// q [B, H, hd] bf16; caches [R, S, Kv, hd] bf16; rows/positions [B]
// int32; out [B, H*hd] bf16.
extern "C" int contiguous_decode_attention(const void* q, const void* k_cache,
                                           const void* v_cache,
                                           const void* rows,
                                           const void* positions, void* out,
                                           int B, int H, int Kv, int hd,
                                           int R, int S, int tile, int window,
                                           float scale, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err =
      paged::prepare_smem(contiguous_decode_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  contiguous_decode_attention_kernel<<<dim3(B, Kv), paged::kThreads, smem,
                                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)rows, (const int*)positions,
      (__nv_bfloat16*)out, H, Kv, hd, R, S, tile, window, scale);
  return (int)cudaGetLastError();
}
