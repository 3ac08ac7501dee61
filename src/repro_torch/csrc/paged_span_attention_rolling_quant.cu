// Paged packed span attention for sliding-window models over the int8
// rolling cache, for the chunked-prefill step (chunk_fn) of a windowed
// kv_quant model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:761
// (paged_span_attention_rolling_quant, body _paged_rolling_quant_kernel).
// The two sources of paged_span_attention_rolling.cu under one running
// fp32 softmax, attended before the caller scatters the span:
//
//   1. the old int8 rolling cache through block-table row seq_idx[t],
//      slots 0..min(off, nb * bs)-1 (slot s stores position
//      off-1-((off-1-s) mod nb*bs), counted iff inside the token's
//      window), with the int8 math of paged_span_attention_quant.cu: exact
//      int8 dots against q quantized per head, and p * vs quantized per
//      p-tile of `tile` slots from slot 0, part of the function (the
//      reference engine off the TPU uses kv_block = 512 clipped and halved
//      until it divides nb * bs, attention.py:968);
//   2. the span's own fresh bf16 K/V [T, Kv, hd], with full-precision
//      dots (the reference keeps them so: the span is not quantized until
//      it is scattered).
//
// Body, grid, numerics, bound and design: span_attention_quant_tiled.cuh
// in its rolling mode.  span_attention_rolling_quant.cu is the same body
// over contiguous rows: with nb * bs == S the two give identical bits.
#include "span_attention_quant_tiled.cuh"

template <int HD, bool POW2>
__global__ void __launch_bounds__(tiled::q8::block_threads<HD>(),
                                  tiled::q8::block_min<HD>())
paged_span_attention_rolling_quant_kernel(
    const tiled::bf16* __restrict__ q, const signed char* __restrict__ k8,
    const tiled::bf16* __restrict__ ks, const signed char* __restrict__ v8,
    const tiled::bf16* __restrict__ vs,
    const tiled::bf16* __restrict__ k_span,
    const tiled::bf16* __restrict__ v_span, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ offsets,
    const int* __restrict__ plan, tiled::bf16* __restrict__ out, int T, int H,
    int Kv, tiled::Group grp, tiled::FastDiv bs, int B, int nb, int n_blocks,
    int tile, int window, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char quant_smem[];
  const int tq = grp.tq;
  const tiled::Plan p = tiled::carve_plan(const_cast<int*>(plan), T, B, tq);
  if ((int)blockIdx.x >= *p.n_tiles) return;
  const int row = p.tiles[3 * blockIdx.x];
  const int w_slots = nb * bs.d;
  int* stab = reinterpret_cast<int*>(
      quant_smem +
      tiled::q8::QLayout<HD, false>::bytes(w_slots, tile, T, 0));
  tiled::PagedRowOf<signed char> src{k8, v8, tables + (size_t)row * nb, bs,
                                     Kv, (int)blockIdx.y, n_blocks, stab};
  tiled::q8::attend<HD, false, POW2>(src, ks, vs, q, k_span, v_span, positions,
      offsets, plan, out, T, H, Kv, grp, B, w_slots, tile, window, n_valid,
      scale, quant_smem);
}

template <int HD>
static int launch(const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* k_span,
                  const void* v_span, const void* tables,
                  const void* positions, const void* offsets, void* plan,
                  void* out, int T, int H, int Kv, tiled::Group grp, int bs,
                  int B, int nb, int n_blocks, int tile, int window,
                  int n_valid,
                  float scale, cudaStream_t stream) {
  const size_t smem =
      tiled::q8::QLayout<HD, false>::bytes(nb * bs, tile, T, nb);
  auto kernel = grp.lg >= 0
                    ? paged_span_attention_rolling_quant_kernel<HD, true>
                    : paged_span_attention_rolling_quant_kernel<HD, false>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled::max_tiles(T, B, grp.tq), Kv);
  kernel<<<grid, tiled::q8::block_threads<HD>(), smem, stream>>>(
      (const tiled::bf16*)q, (const signed char*)k8, (const tiled::bf16*)ks,
      (const signed char*)v8, (const tiled::bf16*)vs,
      (const tiled::bf16*)k_span, (const tiled::bf16*)v_span,
      (const int*)tables, (const int*)positions, (const int*)offsets,
      (const int*)plan, (tiled::bf16*)out, T, H, Kv, grp, tiled::FastDiv(bs),
      B, nb, n_blocks, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8 and ks/vs
// [n_blocks, bs, Kv] bf16 (before the span's scatter); k_span/v_span
// [T, Kv, hd] bf16; tables [B, nb], positions/seq_idx/offsets [T] int32;
// plan: int32 workspace of plan_ints entries (tiled::plan_ints(T, B,
// 64 / g)); out [T, H*hd] bf16.  H / Kv in 1..16, hd in {16, 32, 64,
// 128}, tile >= 1.
extern "C" int paged_span_attention_rolling_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* k_span, const void* v_span,
    const void* tables, const void* positions, const void* seq_idx,
    const void* offsets, void* plan, void* out, int T, int H, int Kv, int hd,
    int bs, int B, int nb, int n_blocks, int tile, int window, int n_valid,
    long long plan_ints, float scale, void* stream) {
  if (T == 0) return 0;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (window < 1 || !grp.g || B < 1 || nb < 1 || bs < 1 || tile < 1 ||
      plan_ints < tiled::plan_ints(T, B, grp.tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tiled::plan_kernel<<<1, tiled::kThreads, 0, s>>>(
      (const int*)seq_idx, T, B, grp.tq, (int*)plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define ROLLING_LAUNCH(HD)                                                   \
  return launch<HD>(q, k8, ks, v8, vs, k_span, v_span, tables, positions,    \
                    offsets, plan, out, T, H, Kv, grp, bs, B, nb, n_blocks,   \
                    tile, window, n_valid, scale, s)
  switch (hd) {
    case 16: ROLLING_LAUNCH(16);
    case 32: ROLLING_LAUNCH(32);
    case 64: ROLLING_LAUNCH(64);
    case 128: ROLLING_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROLLING_LAUNCH
}
