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
// The body of paged_span_attention_rolling.cu over tiled::ContiguousRow
// instead of the table (with nb * bs == S the two give identical bits).
// Body, grid, bound and design: span_attention_tiled.cuh.
#include "span_attention_tiled.cuh"

template <int HD>
__global__ void __launch_bounds__(tiled::kThreads)
span_attention_rolling_kernel(
    const tiled::bf16* __restrict__ q, const tiled::bf16* __restrict__ k_cache,
    const tiled::bf16* __restrict__ v_cache,
    const tiled::bf16* __restrict__ k_span,
    const tiled::bf16* __restrict__ v_span, const int* __restrict__ positions,
    const int* __restrict__ offsets, const int* __restrict__ plan,
    tiled::bf16* __restrict__ out, int T, int H, int Kv, tiled::Group grp,
    int R, int S, int window, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char rolling_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, R, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  tiled::ContiguousRow src{k_cache, v_cache, p.tiles[3 * blockIdx.x], S, Kv,
                           (int)blockIdx.y};
  tiled::attend<HD, false>(src, q, k_span, v_span, positions, offsets, plan,
                           out, T, H, Kv, grp, R, S, window, n_valid, scale,
                           rolling_smem);
}

template <int HD>
static int launch(const void* q, const void* k_cache, const void* v_cache,
                  const void* k_span, const void* v_span,
                  const void* positions, const void* offsets, void* plan,
                  void* out, int T, int H, int Kv, tiled::Group grp, int R,
                  int S, int window, int n_valid, float scale,
                  cudaStream_t stream) {
  const size_t smem = tiled::Layout<HD>::bytes(S, T, 0);
  auto kernel = span_attention_rolling_kernel<HD>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, R, grp.tq), Kv);
  kernel<<<grid, tiled::kThreads, smem, stream>>>(
      (const tiled::bf16*)q, (const tiled::bf16*)k_cache,
      (const tiled::bf16*)v_cache, (const tiled::bf16*)k_span,
      (const tiled::bf16*)v_span, (const int*)positions, (const int*)offsets,
      (const int*)plan, (tiled::bf16*)out, T, H, Kv, grp, R, S, window,
      n_valid, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; caches [R, S, Kv, hd] bf16 (before the span's
// scatter); k_span/v_span [T, Kv, hd] bf16; positions/seq_idx/offsets [T]
// int32; plan: int32 workspace of plan_ints entries (tiled::plan_ints(T,
// R, 64 / g)); out [T, H*hd] bf16.  H / Kv in 1..16, hd in {16, 32,
// 64, 128}.
extern "C" int span_attention_rolling(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_span, const void* v_span, const void* positions,
    const void* seq_idx, const void* offsets, void* plan, void* out, int T,
    int H, int Kv, int hd, int R, int S, int window, int n_valid,
    long long plan_ints, float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (window < 1 || !grp.g || R < 1 || S < 1 ||
      plan_ints < tiled::plan_ints(T, R, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, R, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define ROLLING_LAUNCH(HD)                                                   \
  return launch<HD>(q, k_cache, v_cache, k_span, v_span, positions, offsets, \
                    plan, out, T, H, Kv, grp, R, S, window, n_valid, scale, s)
  switch (hd) {
    case 16: ROLLING_LAUNCH(16);
    case 32: ROLLING_LAUNCH(32);
    case 64: ROLLING_LAUNCH(64);
    case 128: ROLLING_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROLLING_LAUNCH
}
