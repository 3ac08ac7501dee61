// Packed span attention over contiguous int8 cache rows, for the
// chunked-prefill step (chunk_fn) of a kv_quant model under the contiguous
// KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:239
// (span_attention_quant, body _quant_kernel :183).  Token t attends, for
// each query head, to slots 0..positions[t] of row seq_idx[t] of
// [R, S, Kv, hd] int8 caches with [R, S, Kv] bf16 scales.  The
// probabilities are quantized per p-tile of `tile` slots, part of the
// function: the Pallas kernel and its jnp oracle use kv_block = 512 halved
// until it divides S (_pick_block); the caller passes that tile.  It
// depends on S here and on the table's width in
// paged_span_attention_quant.cu, so the two layouts compute different
// functions wherever the two tiles differ.
//
// Body, grid, numerics, bound and design: span_attention_quant_tiled.cuh
// in its full-cache mode over tiled::ContiguousRowOf instead of the table:
// with nb * bs == S it gives paged_span_attention_quant.cu's bits.
#include "span_attention_quant_tiled.cuh"

template <int HD, bool POW2>
__global__ void __launch_bounds__(tiled::q8::block_threads<HD>(),
                                  tiled::q8::block_min<HD>())
span_attention_quant_kernel(
    const tiled::bf16* __restrict__ q, const signed char* __restrict__ k8,
    const tiled::bf16* __restrict__ ks, const signed char* __restrict__ v8,
    const tiled::bf16* __restrict__ vs, const int* __restrict__ positions,
    const int* __restrict__ plan, tiled::bf16* __restrict__ out, int T,
    int H, int Kv, tiled::Group grp, int R, int S, int tile, float scale) {
  extern __shared__ __align__(16) unsigned char quant_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, R, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  tiled::ContiguousRowOf<signed char> src{k8, v8, p.tiles[3 * blockIdx.x],
                                          S, Kv, (int)blockIdx.y};
  tiled::q8::attend<HD, true, POW2>(src, ks, vs, q, nullptr, nullptr,
      positions, nullptr, plan, out, T, H, Kv, grp, R, S, tile, 0, T, scale,
      quant_smem);
}

template <int HD>
static int launch(const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* positions,
                  void* plan, void* out, int T, int H, int Kv,
                  tiled::Group grp, int R,
                  int S, int tile, float scale, cudaStream_t stream) {
  const size_t smem = tiled::q8::QLayout<HD, true>::bytes(S, tile, T, 0);
  auto kernel = grp.lg >= 0 ? span_attention_quant_kernel<HD, true>
                            : span_attention_quant_kernel<HD, false>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, R, grp.tq), Kv);
  kernel<<<grid, tiled::q8::block_threads<HD>(), smem, stream>>>(
      (const tiled::bf16*)q, (const signed char*)k8, (const tiled::bf16*)ks,
      (const signed char*)v8, (const tiled::bf16*)vs, (const int*)positions,
      (const int*)plan, (tiled::bf16*)out, T, H, Kv, grp, R, S, tile, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8 and ks/vs [R, S, Kv] bf16;
// positions/seq_idx [T] int32; plan: int32 workspace of plan_ints entries
// (tiled::plan_ints(T, R, 64 / g)); out [T, H*hd] bf16.  H / Kv in
// 1..16, hd in {16, 32, 64, 128}, tile >= 1.
extern "C" int span_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* positions, const void* seq_idx, void* plan,
    void* out, int T, int H, int Kv, int hd, int R, int S, int tile,
    long long plan_ints, float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (!grp.g || R < 1 || S < 1 || tile < 1 ||
      plan_ints < tiled::plan_ints(T, R, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, R, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define QUANT_LAUNCH(HD)                                                     \
  return launch<HD>(q, k8, ks, v8, vs, positions, plan, out, T, H, Kv, grp, R, \
                    S, tile, scale, s)
  switch (hd) {
    case 16: QUANT_LAUNCH(16);
    case 32: QUANT_LAUNCH(32);
    case 64: QUANT_LAUNCH(64);
    case 128: QUANT_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef QUANT_LAUNCH
}
