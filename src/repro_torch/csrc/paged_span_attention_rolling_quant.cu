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
//      window), walked in tiles of `tile` slots with the int8 math of
//      paged_span_attention_quant.cu: exact __dp4a dots against the query
//      quantized per head, and p * vs quantized per tile and head before
//      the exact int8 AV dot.  The tile is the p-quantization tile, so it
//      is part of the function: the reference engine off the TPU uses
//      kv_block = 512 clipped and halved until it divides nb * bs
//      (attention.py:968); tiles start at slot 0, as there.  Masked slots
//      inside a tile score -1e30, so their probabilities are exactly 0;
//   2. the span's own fresh bf16 K/V [T, Kv, hd], with full-precision
//      dots (the reference keeps them so: the span is not quantized until
//      it is scattered), through paged::fold and paged::FreshSpan.
//
// Grid: one block per (token, kv head).  Shared pieces, numerics and
// bound: paged_attention_quant.cuh and paged_attention.cuh.
#include "paged_attention.cuh"
#include "paged_attention_quant.cuh"

namespace {

constexpr int kFreshTile = 64;  // fresh span entries staged per step

// Dynamic shared memory: the int8 state, then (16-byte aligned) the fp32
// state of the fresh-span fold.
__host__ __device__ inline size_t quant_bytes(int g, int hd, int tile) {
  return (pquant::smem_bytes(g, hd, g * tile) + 15) / 16 * 16;
}

}  // namespace

__global__ void __launch_bounds__(pquant::kThreads)
paged_span_attention_rolling_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs,
    const __nv_bfloat16* __restrict__ k_span,
    const __nv_bfloat16* __restrict__ v_span, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int hd, int bs, int B, int nb, int n_blocks, int tile,
    int window, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int row = seq_idx[t], pos = positions[t], off = offsets[t];
  // a corrupt batch fails loudly
  assert(row >= 0 && row < B && pos >= off && off >= 0);
  const int* table = tables + (size_t)row * nb;
  float* buf;
  const pquant::Smem s = pquant::carve(smem, g, hd, g * tile, &buf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w_slots = nb * bs;
  const int n_old = min(off, w_slots);
  pquant::check_table(table, n_old, bs, n_blocks);
  const __nv_bfloat16* qt = q + ((size_t)t * H + kh * g) * hd;
  pquant::load_query(qt, g, hd, s);
  __syncthreads();

  for (int start = 0; start < n_old; start += tile) {
    const int live = min(tile, n_old - start);
    pquant::score(k8, ks, table, start, live, bs, Kv, kh, g, hd, scale, s,
                  buf, tile);
    // slots outside the token's window (the same threads wrote them)
    for (int i = threadIdx.x; i < live; i += pquant::kThreads) {
      const int stored = off - 1 - (off - 1 - (start + i)) % w_slots;
      if (stored <= pos - window)
        for (int j = 0; j < g; ++j) buf[j * tile + i] = pquant::kNegInf;
    }
    __syncthreads();
    for (int j = warp; j < g; j += pquant::kWarps) {
      float* r = buf + j * tile;
      float mx = pquant::kNegInf;
      for (int i = lane; i < live; i += 32) mx = fmaxf(mx, r[i]);
      const float m_old = s.m[j];
      const float m_new = fmaxf(m_old, pquant::warp_max(mx));
      float sum = 0.f, amax = 0.f;
      for (int i = lane; i < live; i += 32) {
        const float p = expf(r[i] - m_new);
        sum += p;
        const float pv = p * __bfloat162float(
            vs[pquant::slot_index(table, start + i, bs, Kv, kh)]);
        r[i] = pv;
        amax = fmaxf(amax, fabsf(pv));
      }
      sum = pquant::warp_sum(sum);
      amax = pquant::warp_max(amax);
      __syncwarp();
      pquant::quantize_row(r, live, amax, s.ps + j);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s.c[j] = corr;
        s.l[j] = s.l[j] * corr + sum;
        s.m[j] = m_new;
      }
    }
    __syncthreads();
    pquant::av(v8, table, start, live, bs, Kv, kh, g, hd, buf, tile, s, true);
    __syncthreads();
  }

  // the fresh span: fp32 query heads and K/V tiles beside the int8 state,
  // folded into the same running max, sum and accumulator
  float* f = (float*)(smem + quant_bytes(g, hd, tile));
  paged::State fs = paged::carve(f, g, hd, kFreshTile);
  fs.acc = s.acc;
  fs.m = s.m;
  fs.l = s.l;
  fs.c = s.c;
  for (int i = threadIdx.x; i < g * hd; i += pquant::kThreads)
    fs.q[i] = __bfloat162float(qt[i]);
  paged::FreshSpan fresh{k_span, v_span, positions, seq_idx, row, pos,
                         window, Kv, kh, hd};
  paged::fold(fresh, min(n_valid, T), g, hd, kFreshTile, scale, fs);
  paged::finish(out + ((size_t)t * H + kh * g) * hd, g, hd, fs);
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8 and ks/vs
// [n_blocks, bs, Kv] bf16 (before the span's scatter); k_span/v_span
// [T, Kv, hd] bf16; tables [B, nb], positions/seq_idx/offsets [T] int32;
// out [T, H*hd] bf16.  hd must be a multiple of 16.
extern "C" int paged_span_attention_rolling_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* k_span, const void* v_span,
    const void* tables, const void* positions, const void* seq_idx,
    const void* offsets, void* out, int T, int H, int Kv, int hd, int bs,
    int B, int nb, int n_blocks, int tile, int window, int n_valid,
    float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1 || window < 1) return (int)cudaErrorInvalidValue;
  const int g = H / Kv;
  const size_t smem = quant_bytes(g, hd, tile) +
                      sizeof(float) * paged::smem_floats(g, hd, kFreshTile);
  cudaError_t err =
      pquant::prepare_smem(paged_span_attention_rolling_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_rolling_quant_kernel<<<
      dim3(T, Kv), pquant::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const __nv_bfloat16*)k_span,
      (const __nv_bfloat16*)v_span, (const int*)tables, (const int*)positions,
      (const int*)seq_idx, (const int*)offsets, (__nv_bfloat16*)out, T, H, Kv,
      hd, bs, B, nb, n_blocks, tile, window, n_valid, scale);
  return (int)cudaGetLastError();
}
