// Packed span attention over contiguous cache rows, for the chunked-prefill
// step (chunk_fn) under the contiguous KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:132
// (span_attention, body _kernel :76), window = 0 only (windowed models
// keep rolling rows: span_attention_rolling.cu).  The engine writes the
// chunk's K/V into the rows first; token t of the packed span then
// attends, for each query head, to slots 0..positions[t] (at most S of
// them) of row seq_idx[t] of [R, S, Kv, hd] caches (the engine passes
// each token's cache row, so the caches are its whole row pool, written
// in place).
//
// The body of paged_span_attention.cu (span_attention_tiled.cuh, full-cache
// mode) over tiled::ContiguousRow instead of the table: with nb * bs == S
// the two give identical bits.  Body, grid, bound and design:
// span_attention_tiled.cuh.
#include "span_attention_tiled.cuh"

// (two blocks an SM, as the shared memory allows: without the second
// bound ptxas spills at hd 16)
template <int HD>
__global__ void __launch_bounds__(tiled::kThreads, 2)
span_attention_kernel(
    const tiled::bf16* __restrict__ q, const tiled::bf16* __restrict__ k_cache,
    const tiled::bf16* __restrict__ v_cache, const int* __restrict__ positions,
    const int* __restrict__ plan, tiled::bf16* __restrict__ out, int T, int H,
    int Kv, tiled::Group grp, int R, int S, float scale) {
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, R, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  tiled::ContiguousRow src{k_cache, v_cache, p.tiles[3 * blockIdx.x], S, Kv,
                           (int)blockIdx.y};
  tiled::attend<HD, true>(src, q, nullptr, nullptr, positions, nullptr, plan,
                          out, T, H, Kv, grp, R, S, 0, T, scale, span_smem);
}

template <int HD>
static int launch(const void* q, const void* k_cache, const void* v_cache,
                  const void* positions, void* plan, void* out, int T, int H,
                  int Kv, tiled::Group grp, int R, int S, float scale,
                  cudaStream_t stream) {
  const size_t smem = tiled::Layout<HD>::bytes(S, 0, 0);
  auto kernel = span_attention_kernel<HD>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, R, grp.tq), Kv);
  kernel<<<grid, tiled::kThreads, smem, stream>>>(
      (const tiled::bf16*)q, (const tiled::bf16*)k_cache,
      (const tiled::bf16*)v_cache, (const int*)positions, (const int*)plan,
      (tiled::bf16*)out, T, H, Kv, grp, R, S, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; caches [R, S, Kv, hd] bf16 (the span already
// written); positions/seq_idx [T] int32; plan: int32 workspace of
// plan_ints entries (tiled::plan_ints(T, R, 64 / g)); out [T, H*hd] bf16.
// H / Kv in 1..16, hd in {16, 32, 64, 128}.
extern "C" int span_attention(const void* q, const void* k_cache,
                              const void* v_cache, const void* positions,
                              const void* seq_idx, void* plan, void* out,
                              int T, int H, int Kv, int hd, int R, int S,
                              long long plan_ints, float scale,
                              void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (!grp.g || R < 1 || S < 1 ||
      plan_ints < tiled::plan_ints(T, R, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, R, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define SPAN_LAUNCH(HD)                                                      \
  return launch<HD>(q, k_cache, v_cache, positions, plan, out, T, H, Kv, grp, \
                    R, S, scale, s)
  switch (hd) {
    case 16: SPAN_LAUNCH(16);
    case 32: SPAN_LAUNCH(32);
    case 64: SPAN_LAUNCH(64);
    case 128: SPAN_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPAN_LAUNCH
}
