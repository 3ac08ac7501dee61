// A bf16 tile product on the tensor cores, shared by swiglu.cu and
// rmsnorm_matmul.cu: C[m0:m0+BM, n0:n0+BN] = A[m0:, :K] @ B[:K, n0:] for one
// or two B matrices (the SwiGLU gate and up projections share their A
// tiles), accumulated in fp32.  Row-major A [M, K] and B [K, N], bf16, K and
// N multiples of 16 (whole 16-byte chunks), M any: the ragged edges are
// zero-filled on load and masked on store by the caller's epilogue.
//
// One block of 128 threads (4 warps) owns one output tile.  A and B tiles
// of BK columns / rows stream through a ring of STAGES shared-memory
// buffers with cp.async (16 bytes a thread, zero-fill past the edges), and
// each warp multiplies 16 x 16 x 16 bf16 fragments with nvcuda::wmma
// (mma.sync on the tensor cores, fp32 accumulators in registers).  Warps
// split the tile WM x WN over the output and KW ways over each BK step; a
// KW > 1 split is summed in shared memory in warp order, so two launches
// on the same inputs give the same bits.  No atomics.
//
// NORM: A is x of an RMSNorm; the caller has put each row's 1/rms in
// inv[BM], and every A tile is normalised in shared memory after it lands:
// hn = bf16(bf16(x * inv) * w_norm), the reference's two roundings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gemm {

using bf16 = __nv_bfloat16;
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 128;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int KW_, int STAGES_,
          int NB_, bool NORM_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_,
                       KW = KW_, STAGES = STAGES_, NB = NB_;
  static constexpr bool NORM = NORM_;
  static_assert(WM * WN * KW == kThreads / 32, "four warps");
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "whole fragments");
  static_assert(BK % (16 * KW) == 0, "whole k steps per warp");
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // one warp's output
  static constexpr int FM = WTM / 16, FN = WTN / 16;
  // padded rows (16 bytes) against bank conflicts; every fragment start
  // stays 32-byte aligned, as wmma needs
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE_BYTES =
      2 * (A_ELEMS + NB * B_ELEMS) + (NORM ? 2 * BK : 0);
  static_assert(STAGE_BYTES % 32 == 0, "32-byte aligned stages");
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_BYTES = 4 * KW * NB * BM * LDC;  // fp32 partials
  static constexpr int INV_OFF = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  static constexpr int SMEM = INV_OFF + (NORM ? 4 * BM : 0);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One stage: A rows [m0, m0+BM) x cols [k0, k0+BK); each B's rows
// [k0, k0+BK) x cols [n0, n0+BN); with NORM, w_norm[k0, k0+BK).
template <class C>
__device__ __forceinline__ void load_stage(unsigned char* st, const bf16* A,
                                           const bf16* B0, const bf16* B1,
                                           const bf16* wn, int M, int N, int K,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  bf16* sa = reinterpret_cast<bf16*>(st);
  constexpr int kAC = C::BK / 8;  // 16-byte chunks per A row
  for (int c = tid; c < C::BM * kAC; c += kThreads) {
    const int r = c / kAC, kc = (c - r * kAC) * 8;
    const int gr = m0 + r, gk = k0 + kc;
    const bool ok = gr < M && gk < K;
    cp_async16(sa + r * C::LDA + kc, ok ? A + (size_t)gr * K + gk : A, ok);
  }
  constexpr int kBC = C::BN / 8;  // 16-byte chunks per B row
#pragma unroll
  for (int j = 0; j < C::NB; ++j) {
    const bf16* B = j == 0 ? B0 : B1;
    bf16* sb = sa + C::A_ELEMS + j * C::B_ELEMS;
    for (int c = tid; c < C::BK * kBC; c += kThreads) {
      const int r = c / kBC, nc = (c - r * kBC) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + r * C::LDB + nc, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  }
  if constexpr (C::NORM) {
    bf16* sw = sa + C::A_ELEMS + C::NB * C::B_ELEMS;
    for (int c = tid; c < C::BK / 8; c += kThreads) {
      const int gk = k0 + c * 8;
      const bool ok = gk < K;
      cp_async16(sw + c * 8, ok ? wn + gk : wn, ok);
    }
  }
}

// The k loop: acc[j] += A @ B_j over the whole of K for this warp's
// fragments (its share of each BK step when KW > 1).  Ends with every
// copy landed and every warp past its last fragment, so the caller may
// reuse the ring as the epilogue's buffer.
template <class C>
__device__ __forceinline__ void mainloop(unsigned char* smem, const bf16* A,
                                         const bf16* B0, const bf16* B1,
                                         const bf16* wn, const float* inv,
                                         int M, int N, int K, int m0, int n0,
                                         FragC (&acc)[C::NB][C::FM][C::FN]) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int kw = warp % C::KW, mn = warp / C::KW;
  const int warp_m = mn / C::WN, warp_n = mn - warp_m * C::WN;
#pragma unroll
  for (int j = 0; j < C::NB; ++j)
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int f = 0; f < C::FN; ++f) wmma::fill_fragment(acc[j][i][f], 0.f);

  const int nk = (K + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C>(smem + s * C::STAGE_BYTES, A, B0, B1, wn, M, N, K, m0, n0,
                    s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();                 // ... everyone's, and stage kt-1 is consumed
    const int pre = kt + C::STAGES - 1;
    if (pre < nk)
      load_stage<C>(smem + (pre % C::STAGES) * C::STAGE_BYTES, A, B0, B1, wn,
                    M, N, K, m0, n0, pre * C::BK);
    cp_async_commit();
    unsigned char* st = smem + (kt % C::STAGES) * C::STAGE_BYTES;
    bf16* sa = reinterpret_cast<bf16*>(st);
    const bf16* sb = sa + C::A_ELEMS;
    if constexpr (C::NORM) {
      const bf16* sw = sb + C::NB * C::B_ELEMS;
      for (int e = tid; e < C::BM * C::BK; e += kThreads) {
        const int r = e / C::BK, k = e - r * C::BK;
        bf16* p = sa + r * C::LDA + k;
        const bf16 xn = __float2bfloat16(__bfloat162float(*p) * inv[r]);
        *p = __float2bfloat16(__bfloat162float(xn) * __bfloat162float(sw[k]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int ks = kw; ks < C::BK / 16; ks += C::KW) {
      FragA a[C::FM];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(
            a[i], sa + (warp_m * C::WTM + i * 16) * C::LDA + ks * 16, C::LDA);
#pragma unroll
      for (int j = 0; j < C::NB; ++j)
#pragma unroll
        for (int f = 0; f < C::FN; ++f) {
          FragB b;
          wmma::load_matrix_sync(b,
                                 sb + j * C::B_ELEMS + ks * 16 * C::LDB +
                                     warp_n * C::WTN + f * 16,
                                 C::LDB);
#pragma unroll
          for (int i = 0; i < C::FM; ++i)
            wmma::mma_sync(acc[j][i][f], a[i], b, acc[j][i][f]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Park every warp's accumulators in shared memory, [KW][NB][BM][LDC] fp32,
// for an elementwise epilogue.
template <class C>
__device__ __forceinline__ void store_acc(unsigned char* smem,
                                          FragC (&acc)[C::NB][C::FM][C::FN]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int kw = warp % C::KW, mn = warp / C::KW;
  const int warp_m = mn / C::WN, warp_n = mn - warp_m * C::WN;
  float* cb = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < C::NB; ++j)
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int f = 0; f < C::FN; ++f)
        wmma::store_matrix_sync(
            cb + ((kw * C::NB + j) * C::BM + warp_m * C::WTM + i * 16) *
                     C::LDC +
                warp_n * C::WTN + f * 16,
            acc[j][i][f], C::LDC, wmma::mem_row_major);
  __syncthreads();
}

// Element (r, c) of product j, its KW partial sums added in warp order.
template <class C>
__device__ __forceinline__ float tile_sum(const unsigned char* smem, int j,
                                          int r, int c) {
  const float* cb = reinterpret_cast<const float*>(smem);
  float s = cb[(j * C::BM + r) * C::LDC + c];
#pragma unroll
  for (int w = 1; w < C::KW; ++w) s += cb[((w * C::NB + j) * C::BM + r) * C::LDC + c];
  return s;
}

// Set the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <class C, class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  if (C::SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              C::SMEM);
}

}  // namespace gemm
