// Fused SwiGLU MLP: y = bf16(bf16(silu(x @ w1) * (x @ w3)) @ w2), both
// products accumulated in fp32 (the gate too), the hidden h rounded to
// bf16 before the down projection, as the Pallas kernel does.
//
// Replaces the TPU kernel repro/kernels/swiglu.py:40 (swiglu, body _kernel).
// Layouts as there: x [T, d]; w1, w3 [d, ff]; w2 [ff, d]; y [T, d]; bf16.
//
// The Pallas kernel walks ff as the sequential minor grid axis and keeps a
// [t_block, d] fp32 accumulator in VMEM across it.  On Hopper blocks run in
// parallel and carry nothing between them, and at mixtral's d = 4096 a
// 64-row fp32 accumulator is 1 MB, over a block's 227 KB of shared memory.
// So the fusion is split in two kernels, launched back to back on the
// caller's stream:
//   1. gate-up: one block per (row tile, ff tile) computes both products of
//      its tile from the same x tiles and writes h = bf16(silu(a) * b) to a
//      [T, ff] workspace the wrapper allocates;
//   2. down: one block per (row tile, d tile) accumulates h @ w2 over the
//      whole of ff in fp32.
// h's round trip is 2 * T * ff * 2 bytes: 5.8 MB at stablelm's T = 256
// (8% of the 71 MB the call must read, and it stays in the 50 MB L2), 1.3%
// at a mixtral expert.  The alternative, a split-K over ff with atomic
// adds into y, would keep h on chip but sum in a different order on every
// run; this design is deterministic: a second launch repeats the first
// bit for bit.
//
// What bounds it: the weights.  3 * d * ff bf16 values against 6 * T * d *
// ff flops is T flops per byte, below the H100's ~295 for every T the
// engine gives (decode: 4; a chunk: 256), so memory bounds it.  Both
// kernels run the shared tensor-core tile product (gemm_bf16.cuh); row
// tiles are the fastest grid axis, so the blocks that share a weight tile
// run together and all but the first find it in L2.  Many rows take 64-row
// tiles, two warps over the rows and two over each 64-wide k step (the
// down kernel's tiles are 32 columns wide: more blocks for its long sums).
// Few rows (T <= 16, decode) take 16-row tiles whose four warps split each
// k step, narrow column tiles for more blocks in flight.  The tiles were
// picked among a few timed on the card (PERF.md, kernel table rows 4-5).
#include "gemm_bf16.cuh"

namespace {

using gemm::bf16;
using gemm::FragC;
using gemm::kThreads;

// <BM, BN, BK, WM, WN, KW, STAGES, NB, NORM>
using GateUpWide = gemm::Tile<64, 64, 64, 2, 1, 2, 3, 2, false>;
using DownWide = gemm::Tile<64, 32, 64, 2, 1, 2, 4, 1, false>;
using GateUpNarrow = gemm::Tile<16, 32, 64, 1, 1, 4, 4, 2, false>;
using DownNarrow = gemm::Tile<16, 16, 64, 1, 1, 4, 4, 1, false>;
constexpr int kNarrowRows = 16;

template <class C>
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ w3, bf16* __restrict__ h, int T, int d,
               int ff) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  FragC acc[C::NB][C::FM][C::FN];
  gemm::mainloop<C>(smem, x, w1, w3, nullptr, nullptr, T, ff, d, m0, n0, acc);
  gemm::store_acc<C>(smem, acc);
  for (int e = threadIdx.x; e < C::BM * C::BN; e += kThreads) {
    const int r = e / C::BN, c = e - r * C::BN;
    if (m0 + r >= T || n0 + c >= ff) continue;
    const float a = gemm::tile_sum<C>(smem, 0, r, c);
    const float b = gemm::tile_sum<C>(smem, 1, r, c);
    const float g = a / (1.f + expf(-a));  // silu, as F.silu computes it
    h[(size_t)(m0 + r) * ff + n0 + c] = __float2bfloat16(g * b);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
            bf16* __restrict__ y, int T, int ff, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  FragC acc[C::NB][C::FM][C::FN];
  gemm::mainloop<C>(smem, h, w2, nullptr, nullptr, nullptr, T, d, ff, m0, n0,
                    acc);
  gemm::store_acc<C>(smem, acc);
  for (int e = threadIdx.x; e < C::BM * C::BN; e += kThreads) {
    const int r = e / C::BN, c = e - r * C::BN;
    if (m0 + r >= T || n0 + c >= d) continue;
    y[(size_t)(m0 + r) * d + n0 + c] =
        __float2bfloat16(gemm::tile_sum<C>(smem, 0, r, c));
  }
}

template <class G, class D>
cudaError_t launch(const bf16* x, const bf16* w1, const bf16* w3,
                   const bf16* w2, bf16* h, bf16* y, int T, int d, int ff,
                   cudaStream_t s) {
  cudaError_t err = gemm::allow_smem<G>(gate_up_kernel<G>);
  if (err == cudaSuccess) err = gemm::allow_smem<D>(down_kernel<D>);
  if (err != cudaSuccess) return err;
  const dim3 g1((T + G::BM - 1) / G::BM, (ff + G::BN - 1) / G::BN);
  gate_up_kernel<G><<<g1, kThreads, G::SMEM, s>>>(x, w1, w3, h, T, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((T + D::BM - 1) / D::BM, (d + D::BN - 1) / D::BN);
  down_kernel<D><<<g2, kThreads, D::SMEM, s>>>(h, w2, y, T, ff, d);
  return cudaGetLastError();
}

}  // namespace

// x [T, d], w1/w3 [d, ff], w2 [ff, d], y [T, d], h a [T, ff] workspace; all
// bf16, contiguous, 16-byte aligned; d and ff multiples of 16.
extern "C" int swiglu(const void* x, const void* w1, const void* w3,
                      const void* w2, void* h, void* y, int T, int d, int ff,
                      void* stream) {
  if (T == 0) return 0;
  if (T < 0 || d <= 0 || ff <= 0 || d % 16 || ff % 16)
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const bf16*)x;
  const auto *w1b = (const bf16*)w1, *w3b = (const bf16*)w3,
             *w2b = (const bf16*)w2;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= kNarrowRows)
    return (int)launch<GateUpNarrow, DownNarrow>(xb, w1b, w3b, w2b, (bf16*)h,
                                                 (bf16*)y, T, d, ff, s);
  return (int)launch<GateUpWide, DownWide>(xb, w1b, w3b, w2b, (bf16*)h,
                                           (bf16*)y, T, d, ff, s);
}
