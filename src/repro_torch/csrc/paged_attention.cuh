// The fp32 fresh-span fold of the port's int8 rolling span kernels
// (paged_span_attention_rolling_quant.cu, span_attention_rolling_quant.cu,
// through paged_attention_quant.cuh's rolling_span): after the int8 old
// cache, a token folds the span's own bf16 K/V into the same running fp32
// softmax (max, sum, accumulator), exactly the online softmax of the
// reference's Pallas kernels.  The bf16 span kernels have their tiled body
// (span_attention_tiled.cuh), the bf16 decode kernels their split body
// (decode_attention_split.cuh).
//
// One thread block serves ONE query token and the g query heads that
// share ONE kv head.  A source is a list of n candidate entries: entry i's
// K/V vector sits at `offset(i)` of the source's K and V arrays and counts
// iff `valid(i)`.  Each tile of `tile` entries is staged in shared memory
// (bf16 -> fp32), scored against the g query heads (invalid entries score
// -1e30), and folded in.  The one source is FreshSpan, the span's own K/V
// [T, Kv, hd]: entry u is valid iff it is of the same row, at or before
// the token, inside its window, and not bucket padding (u < n_valid).
//
// What bounds it: memory, as the int8 kernels around it (4*g*hd flops per
// entry, far below the H100's 295 flop/byte ridge).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// Dynamic shared memory of one block, in floats.
__host__ __device__ inline int smem_floats(int g, int hd, int tile) {
  return g * hd            // q
         + tile * (hd + 1) // k (padded row: conflict-free column reads)
         + tile * hd       // v
         + g * tile        // scores / probabilities
         + g * hd          // accumulator
         + 3 * g;          // running max, running sum, correction
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory state of one block (see smem_floats for the sizes).
struct State {
  float* q;    // [g][hd] query heads, fp32
  float* k;    // [tile][hd + 1] staged keys
  float* v;    // [tile][hd] staged values
  float* p;    // [g][tile] scores, then probabilities
  float* acc;  // [g][hd] output accumulator
  float* m;    // [g] running max
  float* l;    // [g] running sum
  float* c;    // [g] correction of the current tile
};

__device__ inline State carve(float* smem, int g, int hd, int tile) {
  State s;
  s.q = smem;
  s.k = s.q + g * hd;
  s.v = s.k + tile * (hd + 1);
  s.p = s.v + tile * hd;
  s.acc = s.p + g * tile;
  s.m = s.acc + g * hd;
  s.l = s.m + g;
  s.c = s.l + g;
  return s;
}

// The span's own fresh K/V [T, Kv, hd], for the token of row `row` at
// position `pos`.
struct FreshSpan {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* positions;
  const int* seq_idx;
  int row, pos, window, Kv, kh, hd;
  __device__ size_t offset(int u) const { return ((size_t)u * Kv + kh) * hd; }
  __device__ bool valid(int u) const {
    const int p = positions[u];
    return seq_idx[u] == row && p <= pos && p > pos - window;
  }
};

// Folds slots 0..n-1 of `src` into the running softmax of the g heads.
template <typename Src>
__device__ inline void fold(const Src& src, int n, int g, int hd, int tile,
                            float scale, const State& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int start = 0; start < n; start += tile) {
    const int live = min(tile, n - start);
    __syncthreads();  // the previous tile is consumed; init is visible
    for (int i = tid; i < tile * hd; i += blockDim.x) {
      const int j = i / hd, d = i - (i / hd) * hd;
      float kv = 0.f, vv = 0.f;
      if (j < live) {
        const size_t off = src.offset(start + j) + d;
        kv = __bfloat162float(src.k[off]);
        vv = __bfloat162float(src.v[off]);
      }
      s.k[j * (hd + 1) + d] = kv;
      s.v[j * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < g * tile; i += blockDim.x) {
      const int h = i / tile, j = i - (i / tile) * tile;
      float sc = kNegInf;
      if (j < live && src.valid(start + j)) {
        const float* qr = s.q + h * hd;
        const float* kr = s.k + j * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      s.p[i] = sc;
    }
    __syncthreads();
    for (int h = warp; h < g; h += kWarps) {
      float* pr = s.p + h * tile;
      float mx = kNegInf;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = s.m[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float p = __expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        s.c[h] = corr;
        s.l[h] = s.l[h] * corr + sum;
        s.m[h] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * hd; i += blockDim.x) {
      const int h = i / hd, d = i - (i / hd) * hd;
      const float* pr = s.p + h * tile;
      float a = s.acc[i] * s.c[h];
      for (int j = 0; j < live; ++j) a = fmaf(pr[j], s.v[j * hd + d], a);
      s.acc[i] = a;
    }
  }
}

// out: the token's g heads [g * hd]; acc / l, rounded to bf16.
__device__ inline void finish(__nv_bfloat16* __restrict__ out, int g, int hd,
                              const State& s) {
  __syncthreads();
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x)
    out[i] = __float2bfloat16(s.acc[i] / fmaxf(s.l[i / hd], 1e-30f));
}

}  // namespace paged
