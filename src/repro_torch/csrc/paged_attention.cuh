// Shared body of the port's two paged attention kernels
// (paged_span_attention.cu, decode_attention.cu).
//
// One thread block computes the attention of ONE query token for the g
// query heads that share ONE kv head.  It walks that token's row of the
// block table over logical slots 0..pos only: each tile of `tile` slots
// is staged in shared memory (bf16 -> fp32), scored against the g query
// heads, and folded into a running fp32 softmax (max, sum, accumulator),
// exactly the online softmax of the reference's Pallas kernels.  Slots
// past `pos` are masked with -1e30 and never read, so table entries past
// the prefix (the trash block) are never touched.
//
// What bounds it: memory.  Each block reads its row's K/V prefix once;
// the arithmetic is 4*g*hd flops per slot, far below the H100's
// 295 flop/byte ridge.  This first version does not share a prefix
// between the tokens of one row (a span of C tokens reads it C times,
// mostly from L2), and uses no tensor cores, TMA or split-K.
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

// q, out: this token's [H*hd] row.  table: this token's row of the block
// table, [nb] physical block ids.  Caches: [n_blocks, bs, Kv, hd].
__device__ inline void attend(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_cache,
                       const __nv_bfloat16* __restrict__ v_cache,
                       const int* __restrict__ table, int pos, int kh,
                       int Kv, int g, int hd, int bs, int nb, int n_blocks,
                       int tile, float scale, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + g * hd;
  float* v_s = k_s + tile * (hd + 1);
  float* p_s = v_s + tile * hd;
  float* acc = p_s + g * tile;
  float* m_s = acc + g * hd;
  float* l_s = m_s + g;
  float* c_s = l_s + g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head0 = kh * g;  // first query head of this kv head's group

  for (int i = tid; i < g * hd; i += blockDim.x) {
    q_s[i] = __bfloat162float(q[head0 * hd + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int n_slots = min(pos + 1, nb * bs);
  const size_t slot_stride = (size_t)Kv * hd;
  // a corrupt table fails loudly rather than reading out of the pool
  for (int i = tid; i < (n_slots + bs - 1) / bs; i += blockDim.x)
    assert(table[i] >= 0 && table[i] < n_blocks);

  for (int start = 0; start < n_slots; start += tile) {
    const int live = min(tile, n_slots - start);
    __syncthreads();  // the previous tile is consumed; init is visible
    for (int i = tid; i < tile * hd; i += blockDim.x) {
      const int s = i / hd, d = i - (i / hd) * hd;
      float kv = 0.f, vv = 0.f;
      if (s < live) {
        const int kpos = start + s;
        const int phys = table[kpos / bs];
        const size_t off = ((size_t)phys * bs + kpos % bs) * slot_stride
                           + (size_t)kh * hd + d;
        kv = __bfloat162float(k_cache[off]);
        vv = __bfloat162float(v_cache[off]);
      }
      k_s[s * (hd + 1) + d] = kv;
      v_s[s * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < g * tile; i += blockDim.x) {
      const int h = i / tile, s = i - (i / tile) * tile;
      float sc = kNegInf;
      if (s < live) {
        const float* qr = q_s + h * hd;
        const float* kr = k_s + s * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    for (int h = warp; h < g; h += kWarps) {
      float* pr = p_s + h * tile;
      float mx = kNegInf;
      for (int s = lane; s < tile; s += 32) mx = fmaxf(mx, pr[s]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < tile; s += 32) {
        const float p = __expf(pr[s] - m_new);
        pr[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * hd; i += blockDim.x) {
      const int h = i / hd, d = i - (i / hd) * hd;
      const float* pr = p_s + h * tile;
      float a = acc[i] * c_s[h];
      for (int s = 0; s < live; ++s) a = fmaf(pr[s], v_s[s * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += blockDim.x) {
    const int h = i / hd;
    out[head0 * hd + i] = __float2bfloat16(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
}

// Launch-side shared-memory setup: above 48 KB a kernel must opt in.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
