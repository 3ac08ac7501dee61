// Packed span attention over contiguous int8 rolling rows, for the
// chunked-prefill step (chunk_fn) of a windowed kv_quant model under the
// contiguous KV layout.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:456
// (span_attention_rolling_quant, body _rolling_quant_kernel :358).  The
// two sources of span_attention_rolling.cu under one running fp32
// softmax, attended before the caller scatters the span:
//
//   1. the old int8 row seq_idx[t] ([R, S, Kv, hd] with [R, S, Kv] bf16
//      scales, S = W), slots 0..min(off, S)-1, counted iff the position
//      slot s stores, off-1-((off-1-s) mod S), lies inside the token's
//      window, with exact int8 dots and p * vs quantized per p-tile of
//      `tile` slots from slot 0, part of the function: kv_block = 512
//      halved until it divides S, as the Pallas kernel and its jnp oracle
//      pick it;
//   2. the span's own fresh bf16 K/V [T, Kv, hd] with full-precision dots.
//
// Body, grid, numerics, bound and design: span_attention_quant_tiled.cuh
// in its rolling mode over tiled::ContiguousRowOf instead of the table:
// with nb * bs == S it gives paged_span_attention_rolling_quant.cu's bits.
#include "span_attention_quant_tiled.cuh"

template <int HD, bool POW2>
__global__ void __launch_bounds__(tiled::q8::block_threads<HD>(),
                                  tiled::q8::block_min<HD>())
span_attention_rolling_quant_kernel(
    const tiled::bf16* __restrict__ q, const signed char* __restrict__ k8,
    const tiled::bf16* __restrict__ ks, const signed char* __restrict__ v8,
    const tiled::bf16* __restrict__ vs,
    const tiled::bf16* __restrict__ k_span,
    const tiled::bf16* __restrict__ v_span, const int* __restrict__ positions,
    const int* __restrict__ offsets, const int* __restrict__ plan,
    tiled::bf16* __restrict__ out, int T, int H, int Kv, tiled::Group grp,
    int R, int S, int tile, int window, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char quant_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, R, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  tiled::ContiguousRowOf<signed char> src{k8, v8, p.tiles[3 * blockIdx.x],
                                          S, Kv, (int)blockIdx.y};
  tiled::q8::attend<HD, false, POW2>(src, ks, vs, q, k_span, v_span, positions,
      offsets, plan, out, T, H, Kv, grp, R, S, tile, window, n_valid, scale,
      quant_smem);
}

template <int HD>
static int launch(const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* k_span,
                  const void* v_span, const void* positions,
                  const void* offsets, void* plan, void* out, int T, int H,
                  int Kv, tiled::Group grp, int R, int S, int tile, int window,
                  int n_valid, float scale, cudaStream_t stream) {
  const size_t smem = tiled::q8::QLayout<HD, false>::bytes(S, tile, T, 0);
  auto kernel = grp.lg >= 0 ? span_attention_rolling_quant_kernel<HD, true>
                            : span_attention_rolling_quant_kernel<HD, false>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, R, grp.tq), Kv);
  kernel<<<grid, tiled::q8::block_threads<HD>(), smem, stream>>>(
      (const tiled::bf16*)q, (const signed char*)k8, (const tiled::bf16*)ks,
      (const signed char*)v8, (const tiled::bf16*)vs,
      (const tiled::bf16*)k_span, (const tiled::bf16*)v_span,
      (const int*)positions, (const int*)offsets, (const int*)plan,
      (tiled::bf16*)out, T, H, Kv, grp, R, S, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8 and ks/vs [R, S, Kv] bf16
// (before the span's scatter); k_span/v_span [T, Kv, hd] bf16;
// positions/seq_idx/offsets [T] int32; plan: int32 workspace of plan_ints
// entries (tiled::plan_ints(T, R, 64 / g)); out [T, H*hd] bf16.  H / Kv in
// 1..16, hd in {16, 32, 64, 128}, tile >= 1.
extern "C" int span_attention_rolling_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* k_span, const void* v_span,
    const void* positions, const void* seq_idx, const void* offsets,
    void* plan, void* out, int T, int H, int Kv, int hd, int R, int S,
    int tile, int window, int n_valid, long long plan_ints, float scale,
    void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (window < 1 || !grp.g || R < 1 || S < 1 || tile < 1 ||
      plan_ints < tiled::plan_ints(T, R, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, R, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define ROLLING_LAUNCH(HD)                                                 \
  return launch<HD>(q, k8, ks, v8, vs, k_span, v_span, positions, offsets, \
                    plan, out, T, H, Kv, grp, R, S, tile, window, n_valid,  \
                    scale, s)
  switch (hd) {
    case 16: ROLLING_LAUNCH(16);
    case 32: ROLLING_LAUNCH(32);
    case 64: ROLLING_LAUNCH(64);
    case 128: ROLLING_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROLLING_LAUNCH
}
