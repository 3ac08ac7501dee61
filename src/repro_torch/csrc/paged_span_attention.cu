// Paged packed span attention for the chunked-prefill step (chunk_fn).
//
// Replaces the TPU kernel repro/kernels/span_attention.py:611
// (paged_span_attention, body _kernel via _paged_kernel), window = 0 only.
// The engine writes the chunk's K/V into the cache first; token t of the
// packed span then attends, for each query head, to logical slots
// 0..positions[t] (at most nb * bs of them) of block-table row
// seq_idx[t].  Table entries past a row's longest prefix (the trash
// block) are never read.
//
// Body, grid, bound and design: span_attention_tiled.cuh in its full-cache
// mode (a planning pass groups the span's tokens by row, then one block
// computes 64 query rows, 64 / g tokens of one table row x g heads, of one
// kv head on the tensor cores).  span_attention.cu is the same body over
// contiguous rows: with nb * bs == S the two give identical bits.
#include "span_attention_tiled.cuh"

// (two blocks an SM, as the shared memory allows: without the second
// bound ptxas spills at hd 16)
template <int HD>
__global__ void __launch_bounds__(tiled::kThreads, 2)
paged_span_attention_kernel(
    const tiled::bf16* __restrict__ q, const tiled::bf16* __restrict__ k_cache,
    const tiled::bf16* __restrict__ v_cache, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ plan,
    tiled::bf16* __restrict__ out, int T, int H, int Kv, tiled::Group grp,
    tiled::FastDiv bs, int B, int nb, int n_blocks, float scale) {
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, B, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  const int row = p.tiles[3 * blockIdx.x];
  const int w_slots = nb * bs.d;
  int* stab = reinterpret_cast<int*>(
      span_smem + tiled::Layout<HD>::bytes(w_slots, 0, 0));
  tiled::PagedRow src{k_cache, v_cache, tables + (size_t)row * nb, bs, Kv,
                      (int)blockIdx.y, n_blocks, stab};
  tiled::attend<HD, true>(src, q, nullptr, nullptr, positions, nullptr, plan,
                          out, T, H, Kv, grp, B, w_slots, 0, T, scale,
                          span_smem);
}

template <int HD>
static int launch(const void* q, const void* k_cache, const void* v_cache,
                  const void* tables, const void* positions, void* plan,
                  void* out, int T, int H, int Kv, tiled::Group grp, int bs,
                  int B, int nb, int n_blocks, float scale,
                  cudaStream_t stream) {
  const size_t smem = tiled::Layout<HD>::bytes(nb * bs, 0, nb);
  auto kernel = paged_span_attention_kernel<HD>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, B, grp.tq), Kv);
  kernel<<<grid, tiled::kThreads, smem, stream>>>(
      (const tiled::bf16*)q, (const tiled::bf16*)k_cache,
      (const tiled::bf16*)v_cache, (const int*)tables, (const int*)positions,
      (const int*)plan, (tiled::bf16*)out, T, H, Kv, grp, tiled::FastDiv(bs),
      B, nb, n_blocks, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; caches [n_blocks, bs, Kv, hd] bf16 (the span already
// written); tables [B, nb], positions/seq_idx [T] int32; plan: int32
// workspace of plan_ints entries (tiled::plan_ints(T, B, 64 / g)); out
// [T, H*hd] bf16.  H / Kv in 1..16, hd in {16, 32, 64, 128}.
extern "C" int paged_span_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* positions, const void* seq_idx,
    void* plan, void* out, int T, int H, int Kv, int hd, int bs, int B,
    int nb, int n_blocks, long long plan_ints, float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (!grp.g || B < 1 || nb < 1 || bs < 1 ||
      plan_ints < tiled::plan_ints(T, B, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, B, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define SPAN_LAUNCH(HD)                                                     \
  return launch<HD>(q, k_cache, v_cache, tables, positions, plan, out, T, H, \
                    Kv, grp, bs, B, nb, n_blocks, scale, s)
  switch (hd) {
    case 16: SPAN_LAUNCH(16);
    case 32: SPAN_LAUNCH(32);
    case 64: SPAN_LAUNCH(64);
    case 128: SPAN_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPAN_LAUNCH
}
