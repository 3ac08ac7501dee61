// A bf16 matrix product on Hopper's warpgroup tensor cores, shared by
// swiglu.cu and rmsnorm_matmul.cu (PERF.md kernel table rows 4 and 5):
//
//   out[T, N] = bf16(act[T, K] @ W[K, N])                  (one weight)
//   out[T, N] = bf16(silu(act @ W0) * (act @ W1))          (SwiGLU gate-up)
//
// summed in fp32; act is x or SwiGLU's h, or RMSNorm's
// hn = bf16(bf16(x * inv) * w_norm), made in shared memory (NORM).
// Row-major bf16 throughout; K and N multiples of 16, any T.
//
// Swap-AB.  The products are written out^T = W^T act^T, so the weight's
// output columns take wgmma's 64-row M and the tokens its N (8 to 128, a
// power of two: kernels/_gemm.py plan), and decode's few tokens waste no
// rows.  W^T is wgmma's A, M-major (W's rows are k, its columns
// contiguous), act^T its B, K-major; both are read from shared memory in
// 128-byte-swizzled tiles of 64 k (wgmma.mma_async m64nNk16, descriptors
// with a 1024-byte stride between 8-row groups).
//
// A block: WGS consumer warpgroups (WGS = 2, 128 output columns; 1, 64 for
// SwiGLU's down product), each with its own 64 columns, and a producer
// warp whose lane 0 issues every TMA load (cp.async.bulk.tensor; tensor
// maps encoded on the host, `__grid_constant__`), up to STAGES k-steps
// ahead.  A stage is one k-step of 64: per weight a 64 x 64 tile for each
// warpgroup and the act tile [BN tokens x 64 k], with a `full` and an
// `empty` mbarrier.  TMA zero-fills every box past T, K or N, so no edge
// is masked on load.  Consumers wait on `full`, issue their wgmmas, keep
// one group in flight and release the stage before it on `empty`.
//
// NORM adds a warpgroup of normalisers (seven warps at 128 tokens, where
// they bound the block).  TMA brings each stage's x tile and w_norm's 64
// values with the weights (to a `loaded` barrier); the
// normalisers turn the x tile into hn in place, each thread whole 16-byte
// units in the swizzled layout (the reference's two roundings; zeros stay
// zeros), then `fence.proxy.async` (their generic writes made visible to
// wgmma's async proxy) and arrive on `full`: the consumers never wait on
// a barrier of the whole block, and hn never reaches device memory.  Each
// row's 1/rms comes from rmsnorm_matmul.cu's stats kernel, once a row.
//
// Stages: as many as fit (at most 8) in the shared memory of one block an
// SM where the block takes SwiGLU's two weights or its accumulators take
// 64 registers a thread, of two blocks an SM otherwise: 100-220 KB of
// tiles in flight an SM.
//
// Split-K.  Where the output tiles are fewer than the SMs, the grid's z
// axis cuts K into `splits` slices of q k-steps (kernels/_gemm.py plan: a
// function of the shapes alone).  Each block writes its fp32 accumulators
// to the workspace; the tile's last block to arrive (an int32 count after
// a threadfence, zeroed by the launch before) sums the slices in order
// 0..splits-1 and runs the epilogue.  No float atomics: a second launch
// repeats the first bit for bit.
//
// Epilogue: the accumulators (with SwiGLU's gate applied to whole sums) go
// through a padded [BN][BM] bf16 tile in shared memory (the ring, free by
// then) and leave as 16-byte stores.
//
// Programmatic dependent launch: every block lets its dependents start as
// it starts.  What the grid before may have written is read only after
// griddepcontrol.wait (a no-op when there is none): act by the producer
// (it loads its first stages' weights first), inv by the normalisers, the
// arrival counts by the consumers.
#pragma once

#include <cstdint>

// CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                   // k a stage: one 128-byte row
constexpr int kTileBytes = 64 * kBK * 2;  // a warpgroup's weight tile

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int BN_, int NB_, bool NORM_, int WGS_>
struct Cfg {
  static constexpr int BN = BN_, NB = NB_, WGS = WGS_;
  static constexpr bool NORM = NORM_;
  static_assert(WGS == 1 || WGS == 2, "one or two consumer warpgroups");
  static constexpr int BM = 64 * WGS;  // output columns a block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int EPI_LD = BM + 8;  // epilogue row: no bank conflicts
  static_assert(BN == 8 || BN == 16 || BN == 32 || BN == 64 || BN == 128,
                "wgmma's N: a power of two up to 128");
  static constexpr int ACC = BN / 2;  // fp32 accumulators a thread, a weight
  // the producer: a TMA warp, and with NORM the normalisers, a warpgroup
  // (seven warps for the widest token tile: the block stays at four
  // warpgroups' registers, 128 a thread)
  static constexpr int NORMERS = NORM ? (BN >= 128 ? 224 : 128) : 0;
  static constexpr int PRODUCERS = 32 + NORMERS;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int PER_SM = NB == 2 || ACC >= 64 ? 1 : 2;
  static constexpr int A_BYTES = NB * WGS * kTileBytes;
  static constexpr int B_BYTES = BN * kBK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int STAGES =
      cmin(8, (PER_SM == 1 ? 220 : 108) * 1024 / STAGE);
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static constexpr int RING = STAGES * STAGE;
  static_assert(RING >= BN * EPI_LD * 2, "the epilogue tile fits the ring");
  static constexpr int WN_OFF = RING;  // NORM: w_norm[STAGES][64]
  static constexpr int BAR_OFF = WN_OFF + (NORM ? STAGES * kBK * 2 : 0);
  // full[STAGES], empty[STAGES], NORM: loaded[STAGES]
  static constexpr int FLAG_OFF = BAR_OFF + 8 * STAGES * (NORM ? 3 : 2);
  static constexpr int INV_OFF = FLAG_OFF + 16;  // NORM: inv[BN]
  static constexpr int SMEM = INV_OFF + 4 * BN + 1024;  // + alignment
};

// What a launch computes (the tensor maps aside).
struct Args {
  int T, K, N;        // tokens, reduction length, output columns
  int nk, q, splits;  // k-steps of 64, k-steps a slice, slices (grid z)
  bf16* out;          // [T, N]
  float* part;        // split-K partials (splits > 1)
  int* count;         // arrivals a tile (splits > 1), zeroed by the grid before
  const float* inv;   // NORM: 1/rms [T]
  int* zero;          // arrival counts of the grid after, which block 0
  int n_zero;         // zeroes as it starts
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 2-D tensor map (c0 the contiguous coordinate) into shared
// memory, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulators across the asynchronous
// products (no instruction).
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: 128-byte swizzle, 1024 bytes between
// 8-row groups (SBO), the leading offset unused (1) for both operands: the
// M-major A is one 64-wide swizzle atom, the K-major B one 64-k row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk16, fp32 += bf16 x bf16, A M-major (transposed),
// B K-major; d holds N / 2 accumulators a thread: d[4j + 2i + c] is row
// 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// NORM: the x tile of a stage, [BN tokens][64 k] as TMA left it (16-byte
// unit c of row r at unit c ^ (r % 8), zeros past T and K), made the hn
// tile in place with the reference's two roundings; each normaliser owns
// whole 16-byte units.
template <class C>
__device__ __forceinline__ void norm_tile(unsigned char* sb, const bf16* wn,
                                          const float* inv, int p) {
  constexpr int kUnits = C::BN * 8;
#pragma unroll
  for (int i = 0; i < (kUnits + C::NORMERS - 1) / C::NORMERS; ++i) {
    const int e = p + i * C::NORMERS;
    if (kUnits % C::NORMERS == 0 || e < kUnits) {
      const int r = e >> 3, c = e & 7;
      uint4* u = reinterpret_cast<uint4*>(sb + r * 128 + ((c ^ (r & 7)) << 4));
      uint4 v = *u;
      const uint4 w = reinterpret_cast<const uint4*>(wn)[c];
      __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
      const float s = inv[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // bf16(x * inv) in fp32, then its bf16 product with w_norm (exact
        // in fp32 before the one rounding, as __hmul2 takes it)
        const float2 xf = __bfloat1622float2(vp[k]);
        vp[k] = __hmul2(__floats2bfloat162_rn(xf.x * s, xf.y * s), wp[k]);
      }
      *u = v;
    }
  }
}

// The producer: lane 0 of its first warp issues every TMA load, running up
// to STAGES k-steps ahead of the consumers; with NORM a warpgroup of
// normalisers then turns each landed x tile into hn.
template <class C>
__device__ __forceinline__ void produce(
    unsigned char* smem, const CUtensorMap* w0, const CUtensorMap* w1,
    const CUtensorMap* act, const CUtensorMap* wnorm, const Args& a, int n0,
    int m0, int kb, int n) {
  const int p = threadIdx.x - C::CONSUMERS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* loaded = C::NORM ? empty + C::STAGES : full;  // TMA's barrier
  if (p >= 32) {  // NORM's normalisers
    const int u = p - 32;
    float* inv = reinterpret_cast<float*>(smem + C::INV_OFF);
    wait_for_prior_grid();  // the stats
    for (int r = u; r < C::BN; r += C::NORMERS)
      inv[r] = n0 + r < a.T ? a.inv[n0 + r] : 0.f;
    named_sync<2, C::NORMERS>();
    for (int kt = 0; kt < n; ++kt) {
      const int st = kt % C::STAGES;
      mbar_wait(&loaded[st], (kt / C::STAGES) & 1);
      norm_tile<C>(smem + st * C::STAGE + C::A_BYTES,
                   reinterpret_cast<const bf16*>(smem + C::WN_OFF +
                                                 st * kBK * 2),
                   inv, u);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[st]);
    }
    return;
  }
  if (p != 0) return;
  // weight tiles wholly past N are not loaded: their columns are not stored
  int halves = 0;
  for (int h = 0; h < C::WGS; ++h) halves += m0 + 64 * h < a.N;
  const uint32_t bytes =
      C::NB * halves * kTileBytes + C::B_BYTES + (C::NORM ? kBK * 2 : 0);
  // a stage's weights (and with NORM its x and w_norm; without, act comes
  // after the wait for the grid before, which may write it)
  auto load_stage = [&](int kt, int st) {
    unsigned char* sa = smem + st * C::STAGE;
    const int k0 = (kb + kt) * kBK;
    mbar_expect_tx(&loaded[st], bytes);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int h = 0; h < C::WGS; ++h)
        if (m0 + 64 * h < a.N)
          tma_load(sa + (C::WGS * j + h) * kTileBytes, j ? w1 : w0,
                   m0 + 64 * h, k0, &loaded[st]);
    if constexpr (C::NORM) {
      tma_load(sa + C::A_BYTES, act, k0, n0, &loaded[st]);
      tma_load(smem + C::WN_OFF + st * kBK * 2, wnorm, k0, 0, &loaded[st]);
    }
  };
  const int pre = cmin(C::STAGES, n);
  for (int kt = 0; kt < pre; ++kt) load_stage(kt, kt);
  if (!C::NORM) wait_for_prior_grid();
  for (int kt = 0; kt < n; ++kt) {
    const int st = kt % C::STAGES;
    if (kt >= pre) {
      mbar_wait(&empty[st], ((kt / C::STAGES) & 1) ^ 1);
      load_stage(kt, st);
    }
    if (!C::NORM)
      tma_load(smem + st * C::STAGE + C::A_BYTES, act, (kb + kt) * kBK, n0,
               &full[st]);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::PER_SM)
gemm_kernel(const __grid_constant__ CUtensorMap w0,
            const __grid_constant__ CUtensorMap w1,
            const __grid_constant__ CUtensorMap act,
            const __grid_constant__ CUtensorMap wnorm, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  let_dependents_start();
  const int tid = threadIdx.x;
  if (blockIdx.x + blockIdx.y + blockIdx.z == 0)
    for (int i = tid; i < a.n_zero; i += C::THREADS) a.zero[i] = 0;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM, s = blockIdx.z;
  const int kb = s * a.q, n = cmin(a.q, a.nk - kb);
  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], C::NORM ? C::NORMERS : 1);
      mbar_init(&empty[i], C::WGS);  // one arrival a consumer warpgroup
      if (C::NORM) mbar_init(&empty[C::STAGES + i], 1);  // loaded
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= C::CONSUMERS) {
    produce<C>(smem, &w0, &w1, &act, &wnorm, a, n0, m0, kb, n);
    return;
  }

  // consumers: warpgroup g owns output columns m0 + 64 g .. + 63
  const int g = tid >> 7;
  float acc[C::NB][C::ACC];
#pragma unroll
  for (int j = 0; j < C::NB; ++j)
#pragma unroll
    for (int r = 0; r < C::ACC; ++r) acc[j][r] = 0.f;
  for (int kt = 0; kt < n; ++kt) {
    const int st = kt % C::STAGES;
    mbar_wait(&full[st], (kt / C::STAGES) & 1);
    const uint32_t sa = smem_u32(smem + st * C::STAGE);
    const uint32_t sb = sa + C::A_BYTES;
#pragma unroll
    for (int j = 0; j < C::NB; ++j) hold(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc(sb + 32 * kk);  // 16 k further along the row
#pragma unroll
      for (int j = 0; j < C::NB; ++j)
        Mma<C::BN>::run(
            acc[j], desc(sa + (C::WGS * j + g) * kTileBytes + 2048 * kk), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < C::NB; ++j) hold(acc[j]);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < C::NB; ++j) hold(acc[j]);

  if (a.splits > 1) {
    wait_for_prior_grid();  // which zeroed the counts
    constexpr int kPart = C::NB * C::ACC * C::CONSUMERS;  // floats a block
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = a.part + (size_t)tile * a.splits * kPart;
    float* mine = part + (size_t)s * kPart;
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int r = 0; r < C::ACC; ++r)
        mine[(j * C::ACC + r) * C::CONSUMERS + tid] = acc[j][r];
    __threadfence();
    named_sync<1, C::CONSUMERS>();
    int* last = reinterpret_cast<int*>(smem + C::FLAG_OFF);
    if (tid == 0) *last = atomicAdd(a.count + tile, 1) == a.splits - 1;
    named_sync<1, C::CONSUMERS>();
    if (!*last) return;
    __threadfence();
    // in slice order, kRun accumulators at a time: their loads are in
    // flight together, within the registers the accumulators leave
    constexpr int kRun = cmin(C::ACC, C::NB == 2 ? 16 : 32);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int r0 = 0; r0 < C::ACC; r0 += kRun)
#pragma unroll 1
        for (int q = 0; q < a.splits; ++q) {
          const float* src =
              part + (size_t)q * kPart + (j * C::ACC + r0) * C::CONSUMERS + tid;
#pragma unroll
          for (int r = 0; r < kRun; ++r) {
            const float v = __ldcg(src + r * C::CONSUMERS);
            acc[j][r0 + r] = q == 0 ? v : acc[j][r0 + r] + v;
          }
        }
  }

  // epilogue: a [BN][BM] bf16 tile in the ring, then 16-byte stores
  named_sync<1, C::CONSUMERS>();  // every warpgroup is past its products
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int lane = tid & 31;
  const int col = 64 * g + 16 * ((tid & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < C::ACC; ++r) {
    const int tok = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
    const int c = col + 8 * ((r >> 1) & 1);
    float v = acc[0][r];
    if constexpr (C::NB == 2)
      v = v / (1.f + expf(-v)) * acc[1][r];  // silu(a) * b, as F.silu
    tile[tok * C::EPI_LD + c] = __float2bfloat16(v);
  }
  named_sync<1, C::CONSUMERS>();
  for (int e = tid; e < C::BN * (C::BM / 8); e += C::CONSUMERS) {
    const int row = e / (C::BM / 8), c = 8 * (e % (C::BM / 8));
    const int t = n0 + row, f = m0 + c;
    if (t < a.T && f < a.N)
      *reinterpret_cast<uint4*>(a.out + (size_t)t * a.N + f) =
          *reinterpret_cast<const uint4*>(tile + row * C::EPI_LD + c);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (the
// library does not link libcuda); null if it is not there.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 matrix [rows, cols] read in boxes of box_rows x 64
// columns, 128-byte swizzled (or not: w_norm as one row), zeros past its
// edges.  0 or the error.
inline int tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                      int box_rows, bool swizzle = true) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<void*>(base), dim, stride, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// One product's tiling (kernels/_gemm.py plan, mirrored).
struct Plan {
  int bn, bm, nk, q, splits, tiles;
  Plan(int T, int K, int N, int bn_, int bm_, int q_)
      : bn(bn_), bm(bm_), nk((K + kBK - 1) / kBK), q(q_),
        splits(q_ > 0 ? (nk + q_ - 1) / q_ : 0),
        tiles(bm_ > 0 ? ((T + bn_ - 1) / bn_) * ((N + bm_ - 1) / bm_) : 0) {}
  bool valid() const {
    return (bn == 8 || bn == 16 || bn == 32 || bn == 64 || bn == 128) &&
           (bm == 64 || bm == 128) && q >= 1;
  }
  // split-K partials, floats
  size_t part() const {
    return splits > 1 ? (size_t)tiles * splits * bm * bn : 0;
  }
};

// The workspace of the split product (kernels/_gemm.py workspace_bytes,
// mirrored): its arrival counts, then NORM's 1/rms [T], then its partials;
// each part 256-byte aligned.
inline size_t up256(size_t b) { return (b + 255) / 256 * 256; }

struct Workspace {
  size_t inv, part, bytes;
  Workspace(const Plan& p, int inv_rows)
      : inv(up256(4 * (size_t)p.tiles)),
        part(inv + up256(4 * (size_t)inv_rows)),
        bytes(part + up256(4 * p.part())) {}
};

template <class C>
cudaError_t launch(const CUtensorMap& w0, const CUtensorMap& w1,
                   const CUtensorMap& act, const CUtensorMap& wnorm,
                   const Args& a, bool dependent,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.T + C::BN - 1) / C::BN, (a.N + C::BM - 1) / C::BM,
                     a.splits);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, gemm_kernel<C>, w0, w1, act, wnorm, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation of a token tile.
template <int NB, bool NORM, int WGS>
cudaError_t launch_bn(const CUtensorMap& w0, const CUtensorMap& w1,
                      const CUtensorMap& act, const CUtensorMap& wnorm,
                      const Args& a, int bn, bool dependent, cudaStream_t s) {
  switch (bn) {
#define WG_BN(N)                                                              \
  case N:                                                                     \
    return launch<Cfg<N, NB, NORM, WGS>>(w0, w1, act, wnorm, a, dependent, s);
    WG_BN(8)
    WG_BN(16)
    WG_BN(32)
    WG_BN(64)
    WG_BN(128)
#undef WG_BN
    default:
      return cudaErrorInvalidValue;
  }
}

// The instantiation of the plan's tile: bn tokens by 64 columns for one
// weight without NORM (SwiGLU's down product), else by 128.
template <int NB, bool NORM>
cudaError_t launch_plan(const CUtensorMap& w0, const CUtensorMap& w1,
                        const CUtensorMap& act, const CUtensorMap& wnorm,
                        const Args& a, const Plan& p, bool dependent,
                        cudaStream_t s) {
  constexpr int kWGS = NB == 1 && !NORM ? 1 : 2;
  if (p.bm != 64 * kWGS) return cudaErrorInvalidValue;
  return launch_bn<NB, NORM, kWGS>(w0, w1, act, wnorm, a, p.bn, dependent, s);
}

// Args of one product over its plan and its part of the workspace.
inline Args args(const Plan& p, int T, int K, int N, bf16* out, float* part,
                 int* count) {
  Args a = {};
  a.T = T;
  a.K = K;
  a.N = N;
  a.nk = p.nk;
  a.q = p.q;
  a.splits = p.splits;
  a.out = out;
  a.part = part;
  a.count = count;
  return a;
}

}  // namespace wg
