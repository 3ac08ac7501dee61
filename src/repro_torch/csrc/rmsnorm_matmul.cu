// RMSNorm fused into the projection that follows it:
//   inv = rsqrt(mean(x^2, -1) + eps)            (fp32)
//   hn  = bf16(bf16(x * inv) * w_norm)          (the reference's two roundings)
//   y   = bf16(hn @ w_proj)                     (fp32 accumulation)
//
// Replaces the TPU kernel repro/kernels/rmsnorm_matmul.py:31
// (rmsnorm_matmul, body _kernel).  Layouts as there: x [T, d]; w_norm [d];
// w_proj [d, F]; y [T, F]; bf16.
//
// One block per (row tile, column tile), as the Pallas grid.  Each block
// first takes its rows' statistics in one pass over d (a warp per row,
// fixed-order shuffles), as the Pallas kernel recomputes them per tile;
// then it runs the shared tensor-core tile product (gemm_bf16.cuh) with x
// as A, normalising every A tile in shared memory as it lands, so the
// normalised activations never reach device memory.
//
// What bounds it: w_proj.  d * F bf16 values against 2 * T * d * F flops is
// T flops per byte, so memory bounds it at every T the engine gives; the
// main shape is an LM head at decode (T = 4, F = 100352: 411 MB of
// weights).  To keep enough of w_proj in flight, few rows (T <= 16) take
// 16-row tiles of 64 columns, 1568 blocks at stablelm's vocabulary, two
// warps over the columns and two over each k step, with a six-deep ring;
// many rows take 64 x 64 tiles, two warps over the rows and two over each
// k step.  Row tiles are the fastest grid axis, so blocks that share a
// weight tile run together.  The tiles were picked among a few timed on
// the card (PERF.md, kernel table rows 4-5).
#include "gemm_bf16.cuh"

namespace {

using gemm::bf16;
using gemm::FragC;
using gemm::kThreads;

// <BM, BN, BK, WM, WN, KW, STAGES, NB, NORM>
using Wide = gemm::Tile<64, 64, 64, 2, 1, 2, 3, 1, true>;
using Narrow = gemm::Tile<16, 64, 64, 1, 2, 2, 6, 1, true>;
constexpr int kNarrowRows = 16;

template <class C>
__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wn,
                      const bf16* __restrict__ wp, bf16* __restrict__ y, int T,
                      int d, int F, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* inv = reinterpret_cast<float*>(smem + C::INV_OFF);
  for (int r = warp; r < C::BM; r += kThreads / 32) {
    const int gr = m0 + r;
    float s = 0.f;
    if (gr < T)
      for (int c = lane * 8; c < d; c += 32 * 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)gr * d + c);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(p[q]);
          s += f.x * f.x;
          s += f.y * f.y;
        }
      }
    s = gemm::warp_sum(s);
    if (lane == 0) inv[r] = gr < T ? rsqrtf(s / (float)d + eps) : 0.f;
  }
  __syncthreads();
  FragC acc[C::NB][C::FM][C::FN];
  gemm::mainloop<C>(smem, x, wp, nullptr, wn, inv, T, F, d, m0, n0, acc);
  gemm::store_acc<C>(smem, acc);
  for (int e = threadIdx.x; e < C::BM * C::BN; e += kThreads) {
    const int r = e / C::BN, c = e - r * C::BN;
    if (m0 + r >= T || n0 + c >= F) continue;
    y[(size_t)(m0 + r) * F + n0 + c] =
        __float2bfloat16(gemm::tile_sum<C>(smem, 0, r, c));
  }
}

template <class C>
cudaError_t launch(const bf16* x, const bf16* wn, const bf16* wp, bf16* y,
                   int T, int d, int F, float eps, cudaStream_t s) {
  cudaError_t err = gemm::allow_smem<C>(rmsnorm_matmul_kernel<C>);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + C::BM - 1) / C::BM, (F + C::BN - 1) / C::BN);
  rmsnorm_matmul_kernel<C><<<grid, kThreads, C::SMEM, s>>>(x, wn, wp, y, T, d,
                                                           F, eps);
  return cudaGetLastError();
}

}  // namespace

// x [T, d], w_norm [d], w_proj [d, F], y [T, F]; all bf16, contiguous,
// 16-byte aligned; d and F multiples of 16.
extern "C" int rmsnorm_matmul(const void* x, const void* w_norm,
                              const void* w_proj, void* y, int T, int d, int F,
                              float eps, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || d <= 0 || F <= 0 || d % 16 || F % 16)
    return (int)cudaErrorInvalidValue;
  const auto *xb = (const bf16*)x, *wnb = (const bf16*)w_norm,
             *wpb = (const bf16*)w_proj;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= kNarrowRows)
    return (int)launch<Narrow>(xb, wnb, wpb, (bf16*)y, T, d, F, eps, s);
  return (int)launch<Wide>(xb, wnb, wpb, (bf16*)y, T, d, F, eps, s);
}
