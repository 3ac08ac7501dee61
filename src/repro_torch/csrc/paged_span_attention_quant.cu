// Paged packed span attention over the int8 KV cache, for the chunked
// prefill step (chunk_fn) of a kv_quant model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:656
// (paged_span_attention_quant, body _quant_kernel :183).  Token t of the
// packed span attends, for each query head, to logical slots
// 0..positions[t] of block-table row seq_idx[t].  Grid: one block per
// (token, kv head); the block reads its row and position itself (the TPU
// kernel got them by scalar prefetch).
//
// The slots are walked in tiles of `tile` slots, the p-quantization tile:
// the probabilities of one tile are quantized with one scale per head, so
// the tile width is part of the function.  The Pallas kernel used one
// page (bs); the reference engine off the TPU uses kv_block = 512 clipped
// and halved until it divides the table's nb * bs slots
// (attention.py:829); the caller chooses.  Tiles past positions[t] are
// skipped: all their probabilities are exactly 0, so they would add
// nothing.  The tile loop (pquant::span_tiles), numerics and bound:
// paged_attention_quant.cuh.
#include "paged_attention_quant.cuh"

__global__ void __launch_bounds__(pquant::kThreads)
paged_span_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    __nv_bfloat16* __restrict__ out, int H, int Kv, int hd, int bs, int B,
    int nb, int n_blocks, int tile, float scale) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const int row = seq_idx[t], pos = positions[t];
  assert(row >= 0 && row < B && pos >= 0);  // a corrupt batch fails loudly
  const int* table = tables + (size_t)row * nb;
  const int n_slots = min(pos + 1, nb * bs);
  pquant::check_table(table, n_slots, bs, n_blocks);
  pquant::span(q + (size_t)t * H * hd, k8, ks, v8, vs,
               pquant::PagedIndex{table, bs, Kv, kh}, n_slots, kh, H / Kv, hd,
               tile, scale, out + (size_t)t * H * hd);
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs
// [n_blocks, bs, Kv] bf16; tables [B, nb], positions/seq_idx [T] int32;
// out [T, H*hd] bf16.  hd must be a multiple of 16.
extern "C" int paged_span_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* tables, const void* positions,
    const void* seq_idx, void* out, int T, int H, int Kv, int hd, int bs,
    int B, int nb, int n_blocks, int tile, float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::span_smem_bytes(H / Kv, hd, tile);
  cudaError_t err = pquant::prepare_smem(paged_span_attention_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_quant_kernel<<<dim3(T, Kv), pquant::kThreads, smem,
                                      (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const int*)tables, (const int*)positions,
      (const int*)seq_idx, (__nv_bfloat16*)out, H, Kv, hd, bs, B, nb,
      n_blocks, tile, scale);
  return (int)cudaGetLastError();
}
