// Paged single-token attention over the int8 KV cache, for the pure
// decode step (decode_fn) of a kv_quant model.
//
// No TPU kernel precedes it: the reference gathers the [B, nb * bs] view
// of the int8 cache and runs the jnp decode_attention_quant on it
// (repro/models/transformer.py:110-133, attention.py:553).  This kernel
// computes that function through the [B, nb] block table, over slots
// 0..positions[b] only.  Grid: one block per (row, kv head).
//
// decode_attention_quant normalises the softmax over the whole context
// BEFORE it quantizes p * vs, with one scale per (row, query head), so a
// streaming online softmax would compute another function.  The kernel
// makes passes over the row's slots instead: exact int8 scores into a
// scratch row in device memory (the wrapper's [B, H, nb * bs] fp32
// buffer), their max, the sum of expf(s - max), then p = e / sum times
// vs and its largest magnitude, the quantization of p * vs, and the
// exact int8 AV dot; out = o32 * ps.  Shared pieces, numerics and bound:
// paged_attention_quant.cuh.
//
// Rolling mode (window > 0, sliding-window models; the reference's
// decode_attention_quant(rolling_window=W)): the visible slots are
// 0..min(positions[b] + 1, W) - 1 of the row, all valid.
//
// Contiguous mode (contiguous_decode_attention_quant, the contiguous KV
// layout: the reference's decode_attention_quant on its cache rows,
// transformer.py:145-162): the same body over row rows[b] of a
// [R, S, Kv, hd] cache, with a [B, H, S] scratch.
#include "paged_attention_quant.cuh"

namespace {

// One decode row (q, out: its [H*hd] rows) over slots 0..n_slots-1 of its
// cache row, read through `index`, for the g query heads of kv head kh;
// buf is the (row, kv head)'s [g][stride] scratch in device memory.
template <typename Index>
__device__ inline void decode_quant(const __nv_bfloat16* __restrict__ q,
                                    const signed char* __restrict__ k8,
                                    const __nv_bfloat16* __restrict__ ks,
                                    const signed char* __restrict__ v8,
                                    const __nv_bfloat16* __restrict__ vs,
                                    const Index& index, int n_slots,
                                    float* __restrict__ buf, int stride,
                                    int kh, int g, int hd, float scale,
                                    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* unused;
  const pquant::Smem s = pquant::carve(smem, g, hd, 0, &unused);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  pquant::load_query(q + kh * g * hd, g, hd, s);
  __syncthreads();
  pquant::score(k8, ks, index, 0, n_slots, g, hd, scale, s, buf, stride);
  __syncthreads();
  for (int j = warp; j < g; j += pquant::kWarps) {
    float* r = buf + (size_t)j * stride;
    float mx = pquant::kNegInf;
    for (int i = lane; i < n_slots; i += 32) mx = fmaxf(mx, r[i]);
    mx = pquant::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n_slots; i += 32) sum += expf(r[i] - mx);
    sum = pquant::warp_sum(sum);
    float amax = 0.f;
    for (int i = lane; i < n_slots; i += 32) {
      const float p = __fdiv_rn(expf(r[i] - mx), sum);
      const float pv = p * __bfloat162float(vs[index(i)]);
      r[i] = pv;
      amax = fmaxf(amax, fabsf(pv));
    }
    amax = pquant::warp_max(amax);
    __syncwarp();
    pquant::quantize_row(r, n_slots, amax, s.ps + j);
  }
  __syncthreads();
  pquant::av(v8, index, 0, n_slots, g, hd, buf, stride, s, false);
  __syncthreads();
  __nv_bfloat16* o = out + kh * g * hd;
  for (int i = threadIdx.x; i < g * hd; i += pquant::kThreads)
    o[i] = __float2bfloat16(s.acc[i]);
}

}  // namespace

__global__ void __launch_bounds__(pquant::kThreads)
paged_decode_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ scratch,
    __nv_bfloat16* __restrict__ out, int H, int Kv, int hd, int bs, int nb,
    int n_blocks, int window, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int pos = positions[b];
  assert(pos >= 0);  // a corrupt batch fails loudly
  const int* table = tables + (size_t)b * nb;
  const int stride = nb * bs;
  const int n_slots = min(window ? min(pos + 1, window) : pos + 1, stride);
  pquant::check_table(table, n_slots, bs, n_blocks);
  decode_quant(q + (size_t)b * H * hd, k8, ks, v8, vs,
               pquant::PagedIndex{table, bs, Kv, kh}, n_slots,
               scratch + ((size_t)b * H + kh * g) * stride, stride, kh, g, hd,
               scale, out + (size_t)b * H * hd);
}

// The contiguous layout: decode row b reads row rows[b] of [R, S, Kv, hd]
// caches (scales [R, S, Kv]) over slots 0..positions[b] (rolling:
// 0..min(positions[b] + 1, W) - 1).
__global__ void __launch_bounds__(pquant::kThreads)
contiguous_decode_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ rows,
    const int* __restrict__ positions, float* __restrict__ scratch,
    __nv_bfloat16* __restrict__ out, int H, int Kv, int hd, int R, int S,
    int window, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int row = rows[b], pos = positions[b];
  assert(row >= 0 && row < R && pos >= 0);  // a corrupt batch fails loudly
  const int n_slots = min(window ? min(pos + 1, window) : pos + 1, S);
  decode_quant(q + (size_t)b * H * hd, k8, ks, v8, vs,
               pquant::RowIndex{row, S, Kv, kh}, n_slots,
               scratch + ((size_t)b * H + kh * g) * S, S, kh, g, hd, scale,
               out + (size_t)b * H * hd);
}

// q [B, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs
// [n_blocks, bs, Kv] bf16; tables [B, nb], positions [B] int32; scratch
// [B, H, nb * bs] fp32; out [B, H*hd] bf16.  hd must be a multiple of 16.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* tables, const void* positions, void* scratch,
    void* out, int B, int H, int Kv, int hd, int bs, int nb, int n_blocks,
    int window, float scale, void* stream) {
  if (B == 0) return 0;
  if (hd % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::smem_bytes(H / Kv, hd, 0);
  cudaError_t err = pquant::prepare_smem(paged_decode_attention_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_attention_quant_kernel<<<dim3(B, Kv), pquant::kThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const int*)tables, (const int*)positions,
      (float*)scratch, (__nv_bfloat16*)out, H, Kv, hd, bs, nb, n_blocks,
      window, scale);
  return (int)cudaGetLastError();
}

// q [B, H, hd] bf16; k8/v8 [R, S, Kv, hd] int8; ks/vs [R, S, Kv] bf16;
// rows/positions [B] int32; scratch [B, H, S] fp32; out [B, H*hd] bf16.
// hd must be a multiple of 16.
extern "C" int contiguous_decode_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* rows, const void* positions, void* scratch,
    void* out, int B, int H, int Kv, int hd, int R, int S, int window,
    float scale, void* stream) {
  if (B == 0) return 0;
  if (hd % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::smem_bytes(H / Kv, hd, 0);
  cudaError_t err =
      pquant::prepare_smem(contiguous_decode_attention_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  contiguous_decode_attention_quant_kernel<<<dim3(B, Kv), pquant::kThreads,
                                             smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const int*)rows, (const int*)positions,
      (float*)scratch, (__nv_bfloat16*)out, H, Kv, hd, R, S, window, scale);
  return (int)cudaGetLastError();
}
