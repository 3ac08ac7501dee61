// Paged packed span attention over the int8 KV cache, for the chunked
// prefill step (chunk_fn) of a kv_quant model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:656
// (paged_span_attention_quant, body _quant_kernel :183).  The engine
// writes the chunk's K/V into the cache first; token t of the packed span
// then attends, for each query head, to logical slots 0..positions[t] (at
// most nb * bs of them) of block-table row seq_idx[t], with exact int8
// dots against q quantized per head and the probabilities times the V
// scales quantized per p-tile of `tile` slots from slot 0.  The tile is
// part of the function: the Pallas kernel used one page (bs); the
// reference engine off the TPU uses kv_block = 512 clipped and halved
// until it divides the table's nb * bs slots (attention.py:829); the
// caller chooses.  Table entries past a row's longest prefix (the trash
// block) are never read.
//
// Body, grid, numerics, bound and design: span_attention_quant_tiled.cuh
// in its full-cache mode (a planning pass groups the span's tokens by row,
// then one block computes 64 query rows, 64 / g tokens of one table row x
// g heads, of one kv head on the int8 tensor cores).  span_attention_
// quant.cu is the same body over contiguous rows: with nb * bs == S the
// two give identical bits.
#include "span_attention_quant_tiled.cuh"

template <int HD, bool POW2>
__global__ void __launch_bounds__(tiled::q8::block_threads<HD>(),
                                  tiled::q8::block_min<HD>())
paged_span_attention_quant_kernel(
    const tiled::bf16* __restrict__ q, const signed char* __restrict__ k8,
    const tiled::bf16* __restrict__ ks, const signed char* __restrict__ v8,
    const tiled::bf16* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ plan,
    tiled::bf16* __restrict__ out, int T, int H, int Kv, tiled::Group grp,
    tiled::FastDiv bs, int B, int nb, int n_blocks, int tile, float scale) {
  extern __shared__ __align__(16) unsigned char quant_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, B, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  const int row = p.tiles[3 * blockIdx.x];
  const int w_slots = nb * bs.d;
  int* stab = reinterpret_cast<int*>(
      quant_smem +
      tiled::q8::QLayout<HD, true>::bytes(w_slots, tile, T, 0));
  tiled::PagedRowOf<signed char> src{k8, v8, tables + (size_t)row * nb, bs,
                                     Kv, (int)blockIdx.y, n_blocks, stab};
  tiled::q8::attend<HD, true, POW2>(src, ks, vs, q, nullptr, nullptr,
      positions, nullptr, plan, out, T, H, Kv, grp, B, w_slots, tile, 0, T,
      scale, quant_smem);
}

template <int HD>
static int launch(const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* tables,
                  const void* positions, void* plan, void* out, int T, int H,
                  int Kv, tiled::Group grp, int bs, int B, int nb, int n_blocks,
                  int tile, float scale, cudaStream_t stream) {
  const size_t smem =
      tiled::q8::QLayout<HD, true>::bytes(nb * bs, tile, T, nb);
  auto kernel = grp.lg >= 0 ? paged_span_attention_quant_kernel<HD, true>
                            : paged_span_attention_quant_kernel<HD, false>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, B, grp.tq), Kv);
  kernel<<<grid, tiled::q8::block_threads<HD>(), smem, stream>>>(
      (const tiled::bf16*)q, (const signed char*)k8, (const tiled::bf16*)ks,
      (const signed char*)v8, (const tiled::bf16*)vs, (const int*)tables,
      (const int*)positions, (const int*)plan, (tiled::bf16*)out, T, H, Kv,
      grp, tiled::FastDiv(bs), B, nb, n_blocks, tile, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8 and ks/vs
// [n_blocks, bs, Kv] bf16 (the span already written); tables [B, nb],
// positions/seq_idx [T] int32; plan: int32 workspace of plan_ints entries
// (tiled::plan_ints(T, B, 64 / g)); out [T, H*hd] bf16.  H / Kv in
// 1..16, hd in {16, 32, 64, 128}, tile >= 1.
extern "C" int paged_span_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* tables, const void* positions,
    const void* seq_idx, void* plan, void* out, int T, int H, int Kv, int hd,
    int bs, int B, int nb, int n_blocks, int tile, long long plan_ints,
    float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (!grp.g || B < 1 || nb < 1 || bs < 1 || tile < 1 ||
      plan_ints < tiled::plan_ints(T, B, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, B, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define QUANT_LAUNCH(HD)                                                   \
  return launch<HD>(q, k8, ks, v8, vs, tables, positions, plan, out, T, H, \
                    Kv, grp, bs, B, nb, n_blocks, tile, scale, s)
  switch (hd) {
    case 16: QUANT_LAUNCH(16);
    case 32: QUANT_LAUNCH(32);
    case 64: QUANT_LAUNCH(64);
    case 128: QUANT_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef QUANT_LAUNCH
}
