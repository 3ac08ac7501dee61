// Single-token attention for the pure-decode step (decode_fn), bf16, over
// the paged cache (paged_decode_attention: PERF.md rows 2 and 2r) and over
// contiguous rows (contiguous_decode_attention: rows 2c and 2cr).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:72
// (decode_attention, body _kernel), which read contiguous cache rows
// [B, S, Kv, hd] up to lengths[b].  The paged kernel reads K/V through the
// [B, nb] block table instead of a gathered view; the contiguous kernel
// reads row rows[b] of [R, S, Kv, hd] caches, the TPU kernel's own layout
// (the reference runs the jnp decode_attention on its cache rows there,
// transformer.py:145-167).  Both see slots 0..positions[b], or, in the
// port's own rolling mode (window > 0; a sliding-window model's cache
// holds position p at slot p % W; the reference's
// decode_attention(rolling_window=W), transformer.py:102-146), slots
// 0..min(positions[b] + 1, W) - 1, every one of them valid.
//
// Body, bound and design: decode_attention_split.cuh (a deterministic
// split of the visible slots into 512-slot chunks, tensor-core products,
// a cp.async ring).  The two kernels differ only in a slot's address.
#include <algorithm>

#include "decode_attention_split.cuh"

template <int HD>
__global__ void __launch_bounds__(splitk::kThreads)
paged_decode_split_kernel(const tiled::bf16* __restrict__ q,
                          const tiled::bf16* __restrict__ k_cache,
                          const tiled::bf16* __restrict__ v_cache,
                          const int* __restrict__ tables,
                          const int* __restrict__ positions,
                          float* __restrict__ ws,
                          tiled::bf16* __restrict__ out, int H, int Kv,
                          tiled::FastDiv bs, int nb, int n_blocks,
                          int n_split, int window, float scale) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int b = blockIdx.x, kh = blockIdx.y, g = H / Kv;
  const int pos = positions[b];
  assert(pos >= 0);  // a corrupt batch fails loudly
  const int n = splitk::visible(pos, window, nb * bs.d);
  splitk::PagedChunk src{k_cache, v_cache, tables + (size_t)b * nb, bs, Kv,
                         kh, n_blocks, nullptr, 0};
  splitk::fold_chunk<HD>(
      src, q + (size_t)b * H * HD, n, g, kh, scale,
      ws + ((size_t)b * Kv + kh) * n_split * splitk::partial_floats(g, HD),
      out + (size_t)b * H * HD, decode_smem);
}

template <int HD>
__global__ void __launch_bounds__(splitk::kThreads)
contiguous_decode_split_kernel(const tiled::bf16* __restrict__ q,
                               const tiled::bf16* __restrict__ k_cache,
                               const tiled::bf16* __restrict__ v_cache,
                               const int* __restrict__ rows,
                               const int* __restrict__ positions,
                               float* __restrict__ ws,
                               tiled::bf16* __restrict__ out, int H, int Kv,
                               int R, int S, int n_split, int window,
                               float scale) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int b = blockIdx.x, kh = blockIdx.y, g = H / Kv;
  const int row = rows[b], pos = positions[b];
  assert(row >= 0 && row < R && pos >= 0);  // a corrupt batch fails loudly
  const int n = splitk::visible(pos, window, S);
  splitk::fold_chunk<HD>(
      splitk::ContiguousChunk{k_cache, v_cache, row, S, Kv, kh},
      q + (size_t)b * H * HD, n, g, kh, scale,
      ws + ((size_t)b * Kv + kh) * n_split * splitk::partial_floats(g, HD),
      out + (size_t)b * H * HD, decode_smem);
}

// The chunks of rows with more than one, merged in order; grid (B, Kv).
__global__ void __launch_bounds__(splitk::kThreads)
decode_merge_kernel(const float* __restrict__ ws,
                    const int* __restrict__ positions,
                    tiled::bf16* __restrict__ out, int H, int Kv, int hd,
                    int width, int n_split, int window) {
  const int b = blockIdx.x, kh = blockIdx.y, g = H / Kv;
  const int n = splitk::visible(positions[b], window, width);
  splitk::merge_chunks(
      ws + ((size_t)b * Kv + kh) * n_split * splitk::partial_floats(g, hd), n,
      g, hd, out + ((size_t)b * H + kh * g) * hd);
}

namespace {

// The caller's chunk size must be this body's (the wrapper sizes the
// workspace with it), and g = H / Kv at most 16.
bool shapes_ok(int H, int Kv, int split) {
  return split == splitk::kChunk && Kv >= 1 && H % Kv == 0 &&
         H / Kv <= splitk::kRows;
}

}  // namespace

// q [B, H, hd] bf16; caches [n_blocks, bs, Kv, hd] bf16; tables [B, nb],
// positions [B] int32; ws: B * Kv * n_split * g * (hd + 2) fp32, n_split =
// ceil(width / split), width = nb * bs (min(nb * bs, W) when rolling);
// out [B, H*hd] bf16.  split must be splitk::kChunk, hd in {16, 32, 64,
// 128, 256}, g = H / Kv at most 16, the pointers 16-byte aligned.
extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* tables,
                                      const void* positions, void* ws,
                                      void* out, int B, int H, int Kv, int hd,
                                      int bs, int nb, int n_blocks, int split,
                                      int window, float scale, void* stream) {
  if (B == 0) return 0;
  if (!shapes_ok(H, Kv, split) || bs < 1) return (int)cudaErrorInvalidValue;
  const int width = window ? std::min(nb * bs, window) : nb * bs;
  const int n_split = splitk::n_splits(width);
  if (width < 1 || n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B, Kv, n_split);
  cudaError_t err = cudaErrorInvalidValue;
#define DECODE_PAGED(HD)                                                     \
  case HD: {                                                                 \
    const size_t smem = splitk::Layout<HD>::BYTES;                           \
    err = tiled::prepare_smem(paged_decode_split_kernel<HD>, smem);          \
    if (err != cudaSuccess) return (int)err;                                 \
    paged_decode_split_kernel<HD><<<grid, splitk::kThreads, smem, s>>>(      \
        (const tiled::bf16*)q, (const tiled::bf16*)k_cache,                  \
        (const tiled::bf16*)v_cache, (const int*)tables,                     \
        (const int*)positions, (float*)ws, (tiled::bf16*)out, H, Kv,         \
        tiled::FastDiv(bs), nb, n_blocks, n_split, window, scale);           \
    err = cudaGetLastError();                                                \
    break;                                                                   \
  }
  switch (hd) {
    DECODE_PAGED(16)
    DECODE_PAGED(32)
    DECODE_PAGED(64)
    DECODE_PAGED(128)
    DECODE_PAGED(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_PAGED
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<<<dim3(B, Kv), splitk::kThreads, 0, s>>>(
      (const float*)ws, (const int*)positions, (tiled::bf16*)out, H, Kv, hd,
      width, n_split, window);
  return (int)cudaGetLastError();
}

// q [B, H, hd] bf16; caches [R, S, Kv, hd] bf16; rows/positions [B]
// int32; ws: B * Kv * n_split * g * (hd + 2) fp32, n_split = ceil(width /
// split), width = S (min(S, W) when rolling); out [B, H*hd] bf16.  The
// same conditions as paged_decode_attention.
extern "C" int contiguous_decode_attention(const void* q, const void* k_cache,
                                           const void* v_cache,
                                           const void* rows,
                                           const void* positions, void* ws,
                                           void* out, int B, int H, int Kv,
                                           int hd, int R, int S, int split,
                                           int window, float scale,
                                           void* stream) {
  if (B == 0) return 0;
  if (!shapes_ok(H, Kv, split)) return (int)cudaErrorInvalidValue;
  const int width = window ? std::min(S, window) : S;
  const int n_split = splitk::n_splits(width);
  if (width < 1 || n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B, Kv, n_split);
  cudaError_t err = cudaErrorInvalidValue;
#define DECODE_ROWS(HD)                                                      \
  case HD: {                                                                 \
    const size_t smem = splitk::Layout<HD>::BYTES;                           \
    err = tiled::prepare_smem(contiguous_decode_split_kernel<HD>, smem);     \
    if (err != cudaSuccess) return (int)err;                                 \
    contiguous_decode_split_kernel<HD><<<grid, splitk::kThreads, smem, s>>>( \
        (const tiled::bf16*)q, (const tiled::bf16*)k_cache,                  \
        (const tiled::bf16*)v_cache, (const int*)rows,                       \
        (const int*)positions, (float*)ws, (tiled::bf16*)out, H, Kv, R, S,   \
        n_split, window, scale);                                             \
    err = cudaGetLastError();                                                \
    break;                                                                   \
  }
  switch (hd) {
    DECODE_ROWS(16)
    DECODE_ROWS(32)
    DECODE_ROWS(64)
    DECODE_ROWS(128)
    DECODE_ROWS(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ROWS
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<<<dim3(B, Kv), splitk::kThreads, 0, s>>>(
      (const float*)ws, (const int*)positions, (tiled::bf16*)out, H, Kv, hd,
      width, n_split, window);
  return (int)cudaGetLastError();
}
