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
// Body, grid, bound and design: span_attention_tiled.cuh (a planning pass,
// then one block per 64 query rows of one table row and one kv head, on
// the tensor cores).  span_attention_rolling.cu is the same body over
// contiguous rows.
#include "span_attention_tiled.cuh"

template <int HD>
__global__ void __launch_bounds__(tiled::kThreads)
paged_span_attention_rolling_kernel(
    const tiled::bf16* __restrict__ q, const tiled::bf16* __restrict__ k_cache,
    const tiled::bf16* __restrict__ v_cache,
    const tiled::bf16* __restrict__ k_span,
    const tiled::bf16* __restrict__ v_span, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ offsets,
    const int* __restrict__ plan, tiled::bf16* __restrict__ out, int T, int H,
    int Kv, tiled::Group grp, tiled::FastDiv bs, int B, int nb, int n_blocks,
    int window, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char rolling_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, B, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  const int row = p.tiles[3 * blockIdx.x];
  const int w_slots = nb * bs.d;
  int* stab = reinterpret_cast<int*>(
      rolling_smem + tiled::Layout<HD>::bytes(w_slots, T, 0));
  tiled::PagedRow src{k_cache, v_cache, tables + (size_t)row * nb, bs, Kv,
                      (int)blockIdx.y, n_blocks, stab};
  tiled::attend<HD, false>(src, q, k_span, v_span, positions, offsets, plan,
                           out, T, H, Kv, grp, B, w_slots, window, n_valid,
                           scale, rolling_smem);
}

template <int HD>
static int launch(const void* q, const void* k_cache, const void* v_cache,
                  const void* k_span, const void* v_span, const void* tables,
                  const void* positions, const void* offsets, void* plan,
                  void* out, int T, int H, int Kv, tiled::Group grp, int bs,
                  int B, int nb, int n_blocks, int window, int n_valid,
                  float scale,
                  cudaStream_t stream) {
  const size_t smem = tiled::Layout<HD>::bytes(nb * bs, T, nb);
  auto kernel = paged_span_attention_rolling_kernel<HD>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, B, grp.tq), Kv);
  kernel<<<grid, tiled::kThreads, smem, stream>>>(
      (const tiled::bf16*)q, (const tiled::bf16*)k_cache,
      (const tiled::bf16*)v_cache, (const tiled::bf16*)k_span,
      (const tiled::bf16*)v_span, (const int*)tables, (const int*)positions,
      (const int*)offsets, (const int*)plan, (tiled::bf16*)out, T, H, Kv, grp,
      tiled::FastDiv(bs), B, nb, n_blocks, window, n_valid, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; caches [n_blocks, bs, Kv, hd] bf16 (before the
// span's scatter); k_span/v_span [T, Kv, hd] bf16; tables [B, nb],
// positions/seq_idx/offsets [T] int32; plan: int32 workspace of plan_ints
// entries (tiled::plan_ints(T, B, 64 / g)); out [T, H*hd] bf16.
// H / Kv in 1..16, hd in {16, 32, 64, 128}.
extern "C" int paged_span_attention_rolling(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_span, const void* v_span, const void* tables,
    const void* positions, const void* seq_idx, const void* offsets,
    void* plan, void* out, int T, int H, int Kv, int hd, int bs, int B,
    int nb, int n_blocks, int window, int n_valid, long long plan_ints,
    float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (window < 1 || !grp.g || B < 1 || nb < 1 || bs < 1 ||
      plan_ints < tiled::plan_ints(T, B, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, B, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define ROLLING_LAUNCH(HD)                                                    \
  return launch<HD>(q, k_cache, v_cache, k_span, v_span, tables, positions,  \
                    offsets, plan, out, T, H, Kv, grp, bs, B, nb, n_blocks,   \
                    window, n_valid, scale, s)
  switch (hd) {
    case 16: ROLLING_LAUNCH(16);
    case 32: ROLLING_LAUNCH(32);
    case 64: ROLLING_LAUNCH(64);
    case 128: ROLLING_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROLLING_LAUNCH
}
