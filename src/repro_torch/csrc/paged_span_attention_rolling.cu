// Paged packed span attention for sliding-window models with rolling
// caches, for the chunked-prefill step (chunk_fn) of a windowed model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:703
// (paged_span_attention_rolling, body _paged_rolling_kernel).  A rolling
// cache keeps position p at logical slot p % W, so a chunk cannot be
// scattered before it attends: its writes would overwrite window entries
// its own earlier tokens still need.  Token t of the packed span
// (position pos, row seq_idx[t], whose cache holds positions
// [0, off = offsets[t])) therefore attends two sources under one running
// fp32 softmax, and the caller scatters the span AFTER this returns:
//
//   1. the old cache through block-table row seq_idx[t], slots
//      0..min(off, w_slots)-1 with w_slots = nb * bs, the width of the
//      table this kernel receives (not the model's W: a row whose table
//      is narrower than W / bs has not wrapped, and every slot at or past
//      off, the trash-block padding included, is masked).  Slot s stores
//      off-1-((off-1-s) mod w_slots) and counts iff that lies inside the
//      token's window (> pos - W);
//   2. the span's own fresh K/V [T, Kv, hd]: entry u counts iff it is of
//      the same row, at or before pos, inside the window, and u < n_valid
//      (bucket padding duplicates the last valid token, which would
//      otherwise count twice).
//
// Grid: one block per (token, kv head); the block reads its row, position
// and offset itself (the TPU kernel got them by scalar prefetch).  Body,
// sources, bound and design: paged_attention.cuh.
#include "paged_attention.cuh"

__global__ void __launch_bounds__(paged::kThreads)
paged_span_attention_rolling_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const __nv_bfloat16* __restrict__ k_span,
    const __nv_bfloat16* __restrict__ v_span, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int hd, int bs, int B, int nb, int n_blocks, int tile,
    int window, int n_valid, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int row = seq_idx[t], pos = positions[t], off = offsets[t];
  // a corrupt batch fails loudly
  assert(row >= 0 && row < B && pos >= off && off >= 0);
  const int* table = tables + (size_t)row * nb;
  const paged::State s = paged::carve(smem, g, hd, tile);
  const int head0 = kh * g;
  paged::init(q + ((size_t)t * H + head0) * hd, g, hd, s);
  const int w_slots = nb * bs;
  const int n_old = min(off, w_slots);
  paged::check_table(table, n_old, bs, n_blocks);
  paged::RollingSlots old{{k_cache, v_cache, table, bs, Kv, kh, hd},
                          off, pos, window, w_slots};
  paged::fold(old, n_old, g, hd, tile, scale, s);
  paged::FreshSpan fresh{k_span, v_span, positions, seq_idx, row, pos,
                         window, Kv, kh, hd};
  paged::fold(fresh, min(n_valid, T), g, hd, tile, scale, s);
  paged::finish(out + ((size_t)t * H + head0) * hd, g, hd, s);
}

// q [T, H, hd] bf16; caches [n_blocks, bs, Kv, hd] bf16 (before the
// span's scatter); k_span/v_span [T, Kv, hd] bf16; tables [B, nb],
// positions/seq_idx/offsets [T] int32; out [T, H*hd] bf16.
extern "C" int paged_span_attention_rolling(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_span, const void* v_span, const void* tables,
    const void* positions, const void* seq_idx, const void* offsets,
    void* out, int T, int H, int Kv, int hd, int bs, int B, int nb,
    int n_blocks, int tile, int window, int n_valid, float scale,
    void* stream) {
  if (T == 0) return 0;
  if (window < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * paged::smem_floats(H / Kv, hd, tile);
  cudaError_t err =
      paged::prepare_smem(paged_span_attention_rolling_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_rolling_kernel<<<dim3(T, Kv), paged::kThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const __nv_bfloat16*)k_span,
      (const __nv_bfloat16*)v_span, (const int*)tables, (const int*)positions,
      (const int*)seq_idx, (const int*)offsets, (__nv_bfloat16*)out, T, H, Kv,
      hd, bs, B, nb, n_blocks, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}
