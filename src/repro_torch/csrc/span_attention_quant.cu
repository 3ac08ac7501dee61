// Packed span attention over contiguous int8 cache rows, for the
// chunked-prefill step (chunk_fn) of a kv_quant model under the contiguous
// KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:239
// (span_attention_quant, body _quant_kernel :183).  Token t attends, for
// each query head, to slots 0..positions[t] of row seq_idx[t] of
// [R, S, Kv, hd] int8 caches with [R, S, Kv] bf16 scales.  Grid: one block
// per (token, kv head).
//
// The slots are walked in tiles of `tile` slots, the p-quantization tile:
// the probabilities of one tile are quantized with one scale per head, so
// the tile width is part of the function.  The Pallas kernel and its jnp
// oracle use kv_block = 512 halved until it divides S (_pick_block); the
// caller passes that tile.  It depends on S here and on the table's width
// in paged_span_attention_quant.cu, so the two layouts compute different
// functions wherever the two tiles differ.  Body (pquant::span over
// pquant::RowIndex), numerics and bound: paged_attention_quant.cuh.
#include "paged_attention_quant.cuh"

__global__ void __launch_bounds__(pquant::kThreads)
span_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ positions,
    const int* __restrict__ seq_idx, __nv_bfloat16* __restrict__ out, int H,
    int Kv, int hd, int R, int S, int tile, float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t], pos = positions[t];
  assert(row >= 0 && row < R && pos >= 0);  // a corrupt batch fails loudly
  pquant::span(q + (size_t)t * H * hd, k8, ks, v8, vs,
               pquant::RowIndex{row, S, Kv, kh}, min(pos + 1, S), kh, H / Kv,
               hd, tile, scale, out + (size_t)t * H * hd);
}

// q [T, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8; ks/vs [R, S, Kv] bf16;
// positions/seq_idx [T] int32; out [T, H*hd] bf16.  hd must be a multiple
// of 16.
extern "C" int span_attention_quant(const void* q, const void* k8,
                                    const void* ks, const void* v8,
                                    const void* vs, const void* positions,
                                    const void* seq_idx, void* out, int T,
                                    int H, int Kv, int hd, int R, int S,
                                    int tile, float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::span_smem_bytes(H / Kv, hd, tile);
  cudaError_t err = pquant::prepare_smem(span_attention_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  span_attention_quant_kernel<<<dim3(T, Kv), pquant::kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const int*)positions, (const int*)seq_idx,
      (__nv_bfloat16*)out, H, Kv, hd, R, S, tile, scale);
  return (int)cudaGetLastError();
}
