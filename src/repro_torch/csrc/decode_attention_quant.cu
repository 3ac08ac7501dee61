// Single-token attention over the int8 KV cache, for the pure decode step
// (decode_fn) of a kv_quant model: over the paged cache
// (paged_decode_attention_quant: PERF.md rows 2b and 2br) and over
// contiguous rows (contiguous_decode_attention_quant: rows 2bc and 2bcr).
//
// No TPU kernel precedes them: the reference gathers the [B, nb * bs] view
// of the int8 cache and runs the jnp decode_attention_quant on it
// (repro/models/transformer.py:110-133, attention.py:553), or runs it on
// its cache rows (transformer.py:145-162).  The paged kernel reads the
// cache through the [B, nb] block table; the contiguous kernel reads row
// rows[b] of [R, S, Kv, hd] caches.  Both see slots 0..positions[b], or,
// in the rolling mode (window > 0, sliding-window models; the reference's
// decode_attention_quant(rolling_window=W)), slots 0..min(positions[b] +
// 1, W) - 1 of the row, every one of them valid.
//
// Body, bound and design: decode_attention_quant_split.cuh (a
// deterministic split of the visible slots into 512-slot chunks, four
// grid-wide passes through a workspace, int8 tensor-core products).  The
// two kernels differ only in a slot's address.
#include <algorithm>

#include "decode_attention_quant_split.cuh"

namespace {

// The caller's chunk size must be this body's (the wrapper sizes the
// workspace with it), g = H / Kv at most 16, the width at least one slot.
bool shapes_ok(int H, int Kv, int split, int width) {
  return split == qsplit::kChunk && Kv >= 1 && H % Kv == 0 &&
         H / Kv <= qsplit::kRows && width >= 1 &&
         qsplit::n_splits(width) <= 65535;
}

qsplit::Args args(const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* positions,
                  void* ws, void* out, int B, int H, int Kv, int hd,
                  int width, int window, float scale) {
  return qsplit::Args{(const tiled::bf16*)q, (const signed char*)k8,
                      (const tiled::bf16*)ks, (const signed char*)v8,
                      (const tiled::bf16*)vs, (const int*)positions,
                      (float*)ws, (tiled::bf16*)out, B, H, Kv, hd,
                      qsplit::n_splits(width), window, scale};
}

}  // namespace

// q [B, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs
// [n_blocks, bs, Kv] bf16; tables [B, nb], positions [B] int32; ws:
// kernels/_paged.py quant_decode_workspace(B, H, Kv, hd, width) fp32,
// width = nb * bs (min(nb * bs, W) when rolling); out [B, H*hd] bf16.  split must be qsplit::kChunk, hd in {16, 32, 64, 128}, g = H / Kv
// at most 16, k8 and v8 16-byte aligned.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* tables, const void* positions, void* ws,
    void* out, int B, int H, int Kv, int hd, int bs, int nb, int n_blocks,
    int split, int window, float scale, void* stream) {
  if (B == 0) return 0;
  const int width = window ? std::min(nb * bs, window) : nb * bs;
  if (bs < 1 || !shapes_ok(H, Kv, split, width))
    return (int)cudaErrorInvalidValue;
  return (int)qsplit::launch(
      qsplit::PagedRows{(const int*)tables, tiled::FastDiv(bs), nb, n_blocks},
      args(q, k8, ks, v8, vs, positions, ws, out, B, H, Kv, hd, width,
           window, scale),
      (cudaStream_t)stream);
}

// q [B, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8; ks/vs [R, S, Kv] bf16;
// rows/positions [B] int32; ws as above with width = S (min(S, W) when
// rolling); out [B, H*hd] bf16.  The same conditions as
// paged_decode_attention_quant.
extern "C" int contiguous_decode_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* rows, const void* positions, void* ws,
    void* out, int B, int H, int Kv, int hd, int R, int S, int split,
    int window, float scale, void* stream) {
  if (B == 0) return 0;
  const int width = window ? std::min(S, window) : S;
  if (!shapes_ok(H, Kv, split, width)) return (int)cudaErrorInvalidValue;
  return (int)qsplit::launch(
      qsplit::ContiguousRows{(const int*)rows, R, S},
      args(q, k8, ks, v8, vs, positions, ws, out, B, H, Kv, hd, width,
           window, scale),
      (cudaStream_t)stream);
}
