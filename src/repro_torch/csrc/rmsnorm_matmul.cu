// RMSNorm fused into the projection that follows it:
//   inv = rsqrt(mean(x^2, -1) + eps)            (fp32)
//   hn  = bf16(bf16(x * inv) * w_norm)          (the reference's two roundings)
//   y   = bf16(hn @ w_proj)                     (fp32 accumulation)
//
// Replaces the TPU kernel repro/kernels/rmsnorm_matmul.py:31
// (rmsnorm_matmul, body _kernel).  Layouts as there: x [T, d]; w_norm [d];
// w_proj [d, F]; y [T, F]; bf16.
//
// Two launches on the caller's stream:
//   1. stats: each row's 1/rms once (a warp a row, fixed-order lane sums
//      and shuffles) into the workspace; its first block also zeroes the
//      product's arrival counts.  The Pallas kernel recomputes a row's
//      statistics in every column tile; here a block of the product would
//      read all of d for each of its rows (1 MB of x a block at T = 256),
//      so the rows' statistics are taken once for all blocks.
//   2. the product on the shared wgmma body (gemm_wgmma.cuh, NORM), a
//      programmatic dependent of the stats: TMA streams w_proj, x and
//      w_norm from the start; the normalisers wait for the stats only
//      before they first turn a landed x tile into hn, in shared memory,
//      so the normalised activations never reach device memory.
//
// What bounds it: w_proj.  d * F bf16 values against 2 * T * d * F flops is
// T flops per byte, so memory bounds it at every T the engine gives; the
// main shape is an LM head at decode (T = 4, F = 100352: 411 MB of
// weights, 784 column tiles of 128 over two blocks an SM, each with 6
// stages of 17 KB in flight).  Where the column tiles are fewer than the
// SMs (the MLP entry's F 5632 at T <= 128), K is split in two
// (kernels/_gemm.py plan).
#include "gemm_wgmma.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // a warp a row

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_inv_rms(const wg::bf16* __restrict__ x, float* __restrict__ inv, int T,
            int d, float eps, int* __restrict__ zero, int n_zero) {
  wg::let_dependents_start();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_zero; i += blockDim.x) zero[i] = 0;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)row * d + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(p[q]);
      s += f.x * f.x;
      s += f.y * f.y;
    }
  }
  s = warp_sum(s);
  if (lane == 0) inv[row] = rsqrtf(s / (float)d + eps);
}

}  // namespace

// x [T, d], w_norm [d], w_proj [d, F], y [T, F]; all bf16, contiguous,
// 16-byte aligned; d and F multiples of 16.  ws: the workspace of ws_bytes
// (kernels/_gemm.py workspace_bytes: 1/rms and the split-K partials); bn
// the token tile and q the k-steps a slice (kernels/_gemm.py plan).  0 or
// the CUDA error.
extern "C" int rmsnorm_matmul(const void* x, const void* w_norm,
                              const void* w_proj, void* y, void* ws,
                              long long ws_bytes, int T, int d, int F,
                              float eps, int bn, int q, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || d <= 0 || F <= 0 || d % 16 || F % 16)
    return (int)cudaErrorInvalidValue;
  const wg::Plan plan(T, d, F, bn, 128, q);
  if (!plan.valid()) return (int)cudaErrorInvalidValue;
  const wg::Workspace lay(plan, T);
  if (ws_bytes < 0 || (size_t)ws_bytes < lay.bytes)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mwp, mx, mwn;
  int rc;
  if ((rc = wg::tensor_map(&mwp, w_proj, d, F, wg::kBK)) ||
      (rc = wg::tensor_map(&mx, x, T, d, bn)) ||
      (rc = wg::tensor_map(&mwn, w_norm, 1, d, 1, false)))
    return rc;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* base = (unsigned char*)ws;
  float* inv = (float*)(base + lay.inv);
  // the stats also zero the product's arrival counts
  row_inv_rms<<<(T + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock,
                0, s>>>((const wg::bf16*)x, inv, T, d, eps, (int*)base,
                        plan.splits > 1 ? plan.tiles : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg::Args a = wg::args(plan, T, d, F, (wg::bf16*)y,
                        (float*)(base + lay.part), (int*)base);
  a.inv = inv;
  return (int)wg::launch_plan<1, true>(mwp, mwp, mx, mwn, a, plan, true, s);
}
