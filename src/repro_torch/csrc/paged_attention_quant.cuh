// Shared pieces of the port's int8 decode kernels, paged and contiguous
// (decode_attention_quant.cu), and the int8 quantization rule that the
// tiled int8 span body (span_attention_quant_tiled.cuh) shares with them.
//
// The int8 KV cache holds each K/V vector as int8 [hd] with one bf16
// scale; both attention contractions are exact int8 dots (__dp4a for
// q . k, int32 multiply-adds for p . v) and the scales are folded in
// outside them, as in the reference (repro/models/attention.py:544-650).
// One thread block serves ONE decode row and the g query heads of ONE kv
// head, with 128 threads.  It reads its row's logical slots 0..pos only:
// through the block table (PagedIndex; table entries past the prefix, the
// trash block, are never read) or in one row of a contiguous
// [R, S, Kv, hd] cache (RowIndex).  The two layouts differ only in that
// address computation.
//
// Quantization follows the reference's quantize_kv op for op: the scale
// is max|x| / 127 + 1e-8 in fp32 (correctly rounded division, never a
// reciprocal), values are rintf(x / scale) (round half to even, as
// jnp.round) clipped to [-127, 127], and the scale kept for the
// dequantization is that fp32 scale rounded to bf16.  exp is expf, the
// function PyTorch's exp runs on the card, so the kernels and their plain
// versions differ only in the order of the fp32 sums.
//
// What bounds them: memory.  A visible slot costs hd + 2 bytes of K and
// of V and about 8 * g * hd integer operations, far below the H100's
// ridge of ~590 int8 operations per byte.
#pragma once

#include <cassert>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pquant {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The reference's scale of a vector whose largest magnitude is amax.
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(amax, 127.f) + 1e-8f;
}

__device__ __forceinline__ float quant_value(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

// Shared-memory state of one block.
struct Smem {
  signed char* q8;  // [g][hd] quantized query heads
  float* qs;        // [g] their bf16-rounded scales
  float* m;         // [g] running max
  float* l;         // [g] running sum
  float* c;         // [g] correction of the current tile
  float* ps;        // [g] bf16-rounded scale of the current tile's p
  float* acc;       // [g][hd] output accumulator
  int* red;         // [max(g * hd, kThreads)] partial AV sums
};

// Dynamic shared memory of one block: the int8 query heads first (16-byte
// aligned for the K loads; g * hd is a multiple of 16), then tile_floats
// floats of a score buffer (0 for decode, which keeps its scores in device
// memory), then the state above.
__host__ __device__ inline size_t smem_bytes(int g, int hd, int tile_floats) {
  const int pairs = g * hd > kThreads ? g * hd : kThreads;
  return (size_t)g * hd + sizeof(float) * (size_t)(tile_floats + 5 * g + g * hd) +
         sizeof(int) * (size_t)pairs;
}

// Carves the dynamic shared memory; returns the state and sets *tile to
// the score buffer.
__device__ inline Smem carve(void* smem, int g, int hd, int tile_floats,
                             float** tile) {
  Smem s;
  s.q8 = (signed char*)smem;
  *tile = (float*)(s.q8 + g * hd);
  float* f = *tile + tile_floats;
  s.qs = f;
  s.m = f + g;
  s.l = f + 2 * g;
  s.c = f + 3 * g;
  s.ps = f + 4 * g;
  s.acc = f + 5 * g;
  s.red = (int*)(s.acc + g * hd);
  return s;
}

// Quantizes this block's g query heads (q: its [g * hd] bf16 values) and
// clears the softmax state.  One warp per head.
__device__ inline void load_query(const __nv_bfloat16* __restrict__ q, int g,
                                  int hd, const Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < g; j += kWarps) {
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(q[j * hd + d])));
    const float scale = quant_scale(warp_max(amax));
    for (int d = lane; d < hd; d += 32)
      s.q8[j * hd + d] = (signed char)quant_value(
          __bfloat162float(q[j * hd + d]), scale);
    if (lane == 0) {
      s.qs[j] = bf16_round(scale);
      s.m[j] = kNegInf;
      s.l[j] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < g * hd; i += kThreads) s.acc[i] = 0.f;
}

// Index (in vectors of hd) of logical slot s's kv-head-kh vector in a
// [n_blocks, bs, Kv, hd] cache, through one block-table row; the vector's
// scale sits at the same index of the [n_blocks, bs, Kv] scale cache.
struct PagedIndex {
  const int* table;
  int bs, Kv, kh;
  __device__ __forceinline__ size_t operator()(int s) const {
    return ((size_t)table[s / bs] * bs + s % bs) * Kv + kh;
  }
};

// The same in row `row` of a contiguous [R, S, Kv, hd] cache.
struct RowIndex {
  int row, S, Kv, kh;
  __device__ __forceinline__ size_t operator()(int s) const {
    return ((size_t)row * S + s) * Kv + kh;
  }
};

// Fails loudly on a table entry outside the pool, before any read.
__device__ inline void check_table(const int* __restrict__ table, int n_slots,
                                   int bs, int n_blocks) {
  for (int i = threadIdx.x; i < (n_slots + bs - 1) / bs; i += kThreads)
    assert(table[i] >= 0 && table[i] < n_blocks);
}

// Scores of slots [start, start + count) for the g heads:
// buf[j * stride + s - start] = ((s32 * qs) * ks) * scale, s32 the exact
// int8 dot.  One thread per slot, 16 bytes of K at a time.
template <typename Index>
__device__ inline void score(const signed char* __restrict__ k8,
                             const __nv_bfloat16* __restrict__ ks,
                             const Index& index, int start, int count, int g,
                             int hd, float scale, const Smem& s, float* buf,
                             int stride) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const size_t idx = index(start + i);
    const int4* kr = reinterpret_cast<const int4*>(k8 + idx * hd);
    const float ksf = __bfloat162float(ks[idx]);
    for (int j = 0; j < g; ++j) {
      const int4* qr = reinterpret_cast<const int4*>(s.q8 + j * hd);
      int dot = 0;
      for (int c = 0; c < hd / 16; ++c) {
        const int4 a = qr[c], b = kr[c];
        dot = __dp4a(a.x, b.x, dot);
        dot = __dp4a(a.y, b.y, dot);
        dot = __dp4a(a.z, b.z, dot);
        dot = __dp4a(a.w, b.w, dot);
      }
      buf[j * stride + i] = (float)dot * s.qs[j] * ksf * scale;
    }
  }
}

// Quantizes buf[j * stride + 0..count) in place against the scale
// s.ps-to-be: buf holds p * vs on entry and the int8 values (as floats)
// on exit; s.ps[j] receives the bf16-rounded scale.  amax is head j's
// largest |p * vs| (already reduced); called by head j's warp.
__device__ inline void quantize_row(float* row, int count, float amax,
                                    float* ps_out) {
  const int lane = threadIdx.x & 31;
  const float scale = quant_scale(amax);
  for (int i = lane; i < count; i += 32) row[i] = quant_value(row[i], scale);
  if (lane == 0) *ps_out = bf16_round(scale);
}

// o32[j][d] = sum over slots [start, start + count) of p8[j][s] * v8[s][d]
// (p8 in buf), exact in int32; then acc[j][d] = acc * c[j] + o32 * ps[j]
// (rescale) or acc[j][d] = o32 * ps[j] (decode).  Pairs (j, d) are spread
// over the threads, each pair's slots over as many threads as are left.
template <typename Index>
__device__ inline void av(const signed char* __restrict__ v8,
                          const Index& index, int start, int count, int g,
                          int hd, const float* buf, int stride, const Smem& s,
                          bool rescale) {
  const int pairs = g * hd;
  const int splits = pairs >= kThreads ? 1 : kThreads / pairs;
  for (int w = threadIdx.x; w < pairs * splits; w += kThreads) {
    const int pair = w % pairs, part = w / pairs;
    const int j = pair / hd, d = pair - j * hd;
    int o = 0;
    for (int i = part; i < count; i += splits)
      o += (int)buf[j * stride + i] * (int)v8[index(start + i) * hd + d];
    s.red[w] = o;
  }
  __syncthreads();
  for (int pair = threadIdx.x; pair < pairs; pair += kThreads) {
    int o = 0;
    for (int part = 0; part < splits; ++part) o += s.red[part * pairs + pair];
    const int j = pair / hd;
    const float add = (float)o * s.ps[j];
    s.acc[pair] = rescale ? s.acc[pair] * s.c[j] + add : add;
  }
}

template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pquant
