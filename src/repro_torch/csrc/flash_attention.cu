// Prefill attention: causal (optionally windowed) for the monolithic
// prefill step (prefill_fn), or non-causal (every key of the batch row:
// the whisper encoder's self-attention and the decoder's cross-attention
// to the encoder output).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:80
// (flash_attention, body _kernel) together with its layout adapter
// repro/kernels/ops.py:27 (flash_attention_bshd): it reads q [B, Sq, H, hd]
// and k/v [B, Skv, Kv, hd] in the model's layout and writes
// out [B, Sq, H*hd], so nothing is transposed around it.  GQA maps query
// head h to kv head h / (H / Kv), as the Pallas BlockSpec index map did.
//
// Grid: one block per (64-row query tile, query head, batch row).  The
// TPU kernel walked the kv tiles as the sequential minor grid axis with
// the running softmax in VMEM scratch; here one block loops over its kv
// tiles itself.  Each tile of 64 keys is staged in shared memory (bf16 ->
// fp32; K transposed so a thread reads four keys with one 16-byte load),
// each of 256 threads computes a 4 x 4 block of scores and keeps a
// 4 x (hd/16) block of the output accumulator in registers; the running
// max and sum are fp32, exactly the Pallas kernel's online softmax.
// Causal: whole tiles outside [min_q - window + 1, max_q] of the query
// tile's positions are skipped (the Pallas kernel's pl.when); inside a
// visited tile, masked scores are -1e30.  Non-causal: every tile of the
// row is visited, q_pos is not read (the reference ignores positions
// there), and the tail tile's key count is the whole mask.  Ragged edges
// are masked, so Sq and Skv need not be multiples of 64 or powers of two
// (prefill batches are right-padded to the longest prompt; the encoder
// has 1500 frames), nor equal (cross-attention: a few queries over the
// encoder's keys); rows past Sq are computed from zeros and never stored.
//
// What bounds it: the least work is 4 * hd flops per visible (query, key)
// pair and head against 2 * (2H + 2Kv) * hd bytes per (row, position) of
// q, k, v and the output; with H = Kv that is S / 4 flops per byte, so
// memory bounds the engine's prompts (S <= 512) and the bf16 tensor
// cores bound prompts beyond S ~ 1200 (the H100's ~295 flops per byte).
// Non-causal, every pair is visible: the encoder (S = 1500) is bound by
// operations, the cross-attention (Sq = 4) by reading the encoder's K/V.
// This first version runs fp32 FMAs (no tensor cores, no TMA, no warp
// specialisation) and reads each kv tile once per query tile, so it is
// far from either bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kPad = 4;        // keeps transposed rows 16-byte aligned
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory of one block, in 4-byte words.
template <int HD>
constexpr int smem_words() {
  return 2 * HD * (kBQ + kPad)  // q and k, transposed
         + kBK * HD             // v
         + kBQ * (kBK + 1)      // scores / probabilities
         + 4 * kBQ;             // max, sum, correction, positions
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ q_pos,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int Kv, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int kQS = kBQ + kPad, kKS = kBK + kPad, kPS = kBK + 1;
  constexpr int kCols = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qT = smem;               // [HD][kQS]
  float* kT = qT + HD * kQS;      // [HD][kKS]
  float* vs = kT + HD * kKS;      // [kBK][HD]
  float* ps = vs + kBK * HD;      // [kBQ][kPS]
  float* m_s = ps + kBQ * kPS;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;
  int* pos_s = (int*)(c_s + kBQ);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int nq = min(kBQ, Sq - q0);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    float x = 0.f;
    if (r < nq) x = __bfloat162float(q[(((size_t)b * Sq + q0 + r) * H + h) * HD + d]);
    qT[d * kQS + r] = x;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    pos_s[r] = causal && r < nq ? q_pos[q0 + r] : 0;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // the kv range any row of this tile can see
  int q_min = pos_s[0], q_max = pos_s[0];
  for (int r = 1; r < nq; ++r) {
    q_min = min(q_min, pos_s[r]);
    q_max = max(q_max, pos_s[r]);
  }
  const int k_hi = causal ? min(Skv, q_max + 1) : Skv;
  const int k_lo =
      causal && window ? max(0, q_min - window + 1) / kBK * kBK : 0;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int nk = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i - (i / HD) * HD;
      float kx = 0.f, vx = 0.f;
      if (c < nk) {
        const size_t off = (((size_t)b * Skv + k0 + c) * Kv + kh) * HD + d;
        kx = __bfloat162float(k[off]);
        vx = __bfloat162float(v[off]);
      }
      kT[d * kKS + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kQS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * kKS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = pos_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j, kp = k0 + c;
        const bool live =
            c < nk && (!causal || (kp <= qp && (!window || kp > qp - window)));
        ps[r * kPS + c] = live ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* pr = ps + r * kPS;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < nk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // l_s is final
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * Sq + q0 + r) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[tx + 16 * j] = __float2bfloat16(acc[i][j] / l);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, void* out, int B, int Sq, int Skv,
                   int H, int Kv, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_words<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (__nv_bfloat16*)out, Sq,
      Skv, H, Kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, hd], k/v [B, Skv, Kv, hd] bf16; q_pos [Sq] int32 (read
// only when causal; may be null otherwise); out [B, Sq, H*hd] bf16.  hd
// must be 16, 32, 64 or 128; a window needs the causal form.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, void* out, int B, int Sq,
                               int Skv, int H, int Kv, int hd, int causal,
                               int window, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (!causal && window) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, causal, window, scale, s);
    case 32: return (int)launch<32>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, causal, window, scale, s);
    case 64: return (int)launch<64>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, causal, window, scale, s);
    case 128: return (int)launch<128>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
