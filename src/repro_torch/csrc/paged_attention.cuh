// Shared body of the port's bf16 full-cache span kernels, paged and
// contiguous (paged_span_attention.cu, span_attention.cu: PERF.md rows 1
// and 9), and of the int8 kernels' fresh span (through
// paged_attention_quant.cuh).  The bf16 rolling span kernels have their own
// tiled body (span_attention_tiled.cuh), the bf16 decode kernels their
// split body (decode_attention_split.cuh); Rolling<...> below has no user
// left.
//
// One thread block computes the attention of ONE query token for the g
// query heads that share ONE kv head.  It folds one or more sources of
// K/V into a running fp32 softmax (max, sum, accumulator), exactly the
// online softmax of the reference's Pallas kernels.  A source is a list
// of n candidate slots: slot i's K/V vector sits at `offset(i)` of the
// source's K and V arrays and counts iff `valid(i)`.  Each tile of `tile`
// slots is staged in shared memory (bf16 -> fp32), scored against the g
// query heads (invalid slots score -1e30), and folded in.  Sources:
//
//   PagedSlots    slots 0..n-1 of the token's block-table row, all valid
//                 (full cache: n = pos + 1);
//   RowSlots      the same slots of one row of a contiguous [R, S, Kv, hd]
//                 cache (the contiguous KV layout): slot s of row r sits
//                 at ((r * S + s) * Kv + kh) * hd;
//   Rolling<...>  the old rolling cache of a windowed span, over either:
//                 slots 0..min(off, w_slots)-1 of the row (w_slots = nb *
//                 bs of the table, or S of a row), where slot s stores
//                 position off-1-((off-1-s) mod w_slots), valid iff inside
//                 the token's window;
//   FreshSpan     the span's own K/V [T, Kv, hd]: entry u is valid iff it
//                 is of the same row, at or before the token, inside its
//                 window, and not bucket padding (u < n_valid).
//
// The paged and contiguous kernels differ only in the source's address
// computation; with the same tile order their outputs are identical.
// Slots past n are never read, so table entries past a row's prefix (the
// trash block) are never touched.
//
// What bounds it: memory.  Each block reads its sources once; the
// arithmetic is 4*g*hd flops per slot, far below the H100's 295 flop/byte
// ridge.  This first version does not share a prefix between the tokens
// of one row (a span of C tokens reads it C times, mostly from L2), and
// uses no tensor cores, TMA or split-K.
#pragma once

#include <cassert>

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

// Loads this block's g query heads (q: their [g * hd] bf16 values) and
// clears the softmax state.
__device__ inline void init(const __nv_bfloat16* __restrict__ q, int g,
                            int hd, const State& s) {
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    s.q[i] = __bfloat162float(q[i]);
    s.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    s.m[i] = kNegInf;
    s.l[i] = 0.f;
  }
}

// Fails loudly on a table entry outside the pool, before any read.
__device__ inline void check_table(const int* __restrict__ table, int n_slots,
                                   int bs, int n_blocks) {
  for (int i = threadIdx.x; i < (n_slots + bs - 1) / bs; i += blockDim.x)
    assert(table[i] >= 0 && table[i] < n_blocks);
}

// Slots 0..n-1 of one block-table row of a [n_blocks, bs, Kv, hd] cache.
struct PagedSlots {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* table;
  int bs, Kv, kh, hd;
  __device__ size_t offset(int s) const {
    return (((size_t)table[s / bs] * bs + s % bs) * Kv + kh) * hd;
  }
  __device__ bool valid(int) const { return true; }
};

// Slots 0..n-1 of row `row` of a contiguous [R, S, Kv, hd] cache.
struct RowSlots {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int row, S, Kv, kh, hd;
  __device__ size_t offset(int s) const {
    return (((size_t)row * S + s) * Kv + kh) * hd;
  }
  __device__ bool valid(int) const { return true; }
};

// The old rolling cache of a windowed span token at position `pos`, whose
// row holds positions [0, off): slot s (s < min(off, w_slots)) stores
// off-1-((off-1-s) mod w_slots), w_slots = nb * bs of the table (paged)
// or S (a contiguous row).
template <typename Slots>
struct Rolling : Slots {
  int off, pos, window, w_slots;
  __device__ bool valid(int s) const {
    const int stored = off - 1 - (off - 1 - s) % w_slots;
    return stored > pos - window;
  }
};
using RollingSlots = Rolling<PagedSlots>;
using RowRollingSlots = Rolling<RowSlots>;

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

// One token (q, out: its [H*hd] rows) over slots 0..n-1 of `src`, for
// the g query heads of kv head kh.
template <typename Src>
__device__ inline void attend_source(const __nv_bfloat16* __restrict__ q,
                                     const Src& src, int n, int kh, int g,
                                     int hd, int tile, float scale,
                                     __nv_bfloat16* __restrict__ out) {
  // (named apart from the int8 kernels' byte-typed dynamic shared memory:
  // one translation unit may hold both, and extern declarations of one
  // name must agree in type)
  extern __shared__ float attend_smem[];
  const State s = carve(attend_smem, g, hd, tile);
  const int head0 = kh * g;  // first query head of this kv head's group
  init(q + head0 * hd, g, hd, s);
  fold(src, n, g, hd, tile, scale, s);
  finish(out + head0 * hd, g, hd, s);
}

// One token over slots 0..n_slots-1 of its table row (n_slots <= nb * bs):
// q, out its [H*hd] rows; table [nb]; caches [n_blocks, bs, Kv, hd].
__device__ inline void attend(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_cache,
                              const __nv_bfloat16* __restrict__ v_cache,
                              const int* __restrict__ table, int n_slots,
                              int kh, int Kv, int g, int hd, int bs,
                              int n_blocks, int tile, float scale,
                              __nv_bfloat16* __restrict__ out) {
  // a corrupt table fails loudly rather than reading out of the pool
  check_table(table, n_slots, bs, n_blocks);
  attend_source(q, PagedSlots{k_cache, v_cache, table, bs, Kv, kh, hd},
                n_slots, kh, g, hd, tile, scale, out);
}

// Launch-side shared-memory setup: above 48 KB a kernel must opt in.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
