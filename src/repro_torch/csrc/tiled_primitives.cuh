// Primitives of the port's tensor-core attention bodies: the span body
// (span_attention_tiled.cuh, PERF.md rows 1, 6, 9 and 11), the flash
// prefill body (flash_attention.cu, rows 3, 3n and 3w), the split
// decode bodies (decode_attention_split.cuh, rows 2, 2c, 2r and 2cr;
// decode_attention_quant_split.cuh, rows 2b, 2bc, 2br and 2bcr) and the
// int8 span body (span_attention_quant_tiled.cuh, rows 7, 8, 10 and 12).
// 16-byte cp.async copies (zero-filled where there is nothing to read),
// ldmatrix (.trans for V), mma.sync.m16n8k16 bf16 products into fp32 and
// m16n8k32 s8 products into s32, the byte transposition that makes int8 V
// rows B fragments, the bf16 hi + lo split of fp32 probabilities, a
// multiply-shift
// division by the page size, and fold_tile: one 64-slot K/V tile folded
// into a warp's 16 query rows (S = Q K^T, the online softmax, O += P V).
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiled {

using bf16 = __nv_bfloat16;

constexpr float kNone = -1e30f;  // running max before any visible score
constexpr float kLog2e = 1.4426950408889634f;

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1; the
// round-up method of CUTLASS's FastDivmod): the slot-to-page division of
// every staged slot without an integer division.
struct FastDiv {
  int d;
  unsigned mul;
  int shr;
  __host__ explicit FastDiv(int d_) : d(d_), mul(0), shr(0) {
    if (d == 1) return;
    int lg = 0;
    while ((1LL << lg) < d) ++lg;  // ceil(log2 d)
    const int p = 31 + lg;
    mul = (unsigned)(((1ULL << p) + (unsigned)d - 1) / (unsigned)d);
    shr = p - 32;
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

// ---------------------------------------------------------------------------
// Tensor-core and copy primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32, row) * b (32 x 8, col); s8 in, exact s32 accumulators
// (the int8 bodies: span_attention_quant_tiled.cuh and
// decode_attention_quant_split.cuh)
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[j] holds bytes (c = 0..3) of row j; o[c] gets byte c of rows 0..3: four
// slots' words of an int8 V row become the B fragments (four consecutive k)
// of four n-blocks
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// (x, y) as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// A 64-query-row block's tile step (the span and flash bodies): 4 warps,
// warp w owns query rows 16w..16w+15; a thread holds rows lane / 4 and
// lane / 4 + 8 of its warp (ri = 0, 1) and, of each 8-slot group nb of the
// tile, slots nb * 8 + 2 * (lane % 4) + {0, 1}.  K/V tiles are [64][LD]
// bf16 in shared memory (LD = HD + 8: rows padded by 16 bytes, so
// ldmatrix reads without bank conflicts).
// ---------------------------------------------------------------------------

// The warp's Q fragments, from the block's [64][LD] query rows.
template <int HD, int LD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4],
                                       const bf16* sq, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldsm_x4(qa[ks], sq + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                        ((lane >> 4) << 3));
}

// Where a warp's Q fragment for k-step ks (16 dims of its 16 query rows)
// comes from.  QRegs: registers loaded once (load_q), hd up to 128.
// QShared: the rows' padded [16][LD] copy in shared memory, re-read with
// ldmatrix at every k-step; at hd 256 the held fragments (64 words a
// thread) beside the accumulator's 128 would spill.
template <int HD>
struct QRegs {
  const uint32_t (&qa)[HD / 16][4];
  __device__ __forceinline__ void get(int ks, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qa[ks][i];
  }
};

template <int LD>
struct QShared {
  const bf16* rows;  // the warp's first query row
  int lane;
  __device__ __forceinline__ void get(int ks, uint32_t (&a)[4]) const {
    ldsm_x4(a, rows + (lane & 15) * LD + ks * 16 + ((lane >> 4) << 3));
  }
};

// Folds one tile into the warp's running softmax (m, l: the thread's two
// rows' max and sum, in log2 units; o: its accumulator fragments).
//   S = Q K^T, 16 rows x 64 slots, on the tensor cores; scores times c2 =
//   scale * log2 e; masked scores are -inf.  `full` (block-uniform): every
//   row sees every slot, no mask.  Otherwise `row(ri)` gives the predicate
//   of the thread's row ri: vis(n), does it see slot n of the tile.
//   The online softmax in fp32 with exp2; a row that sees nothing keeps
//   its state bit for bit (p = 0, its max unmoved: corr = 1).
//   O += (P_hi + P_lo) V with P = bf16 hi + lo = bf16(p - hi): one bf16 P
//   misses the kernels' limit (2^-7 |plain| + 1e-5) at mixtral's widths
//   by 17x (tests/test_torch_rolling_tiles.py).
// The fold order is the call order; nothing here depends on other blocks.
// fold_tile_q takes the Q fragments from `qsrc` (QRegs or QShared).
template <int HD, int LD, class QSrc, class RowMask>
__device__ __forceinline__ void fold_tile_q(
    const QSrc& qsrc, const bf16* tk, const bf16* tv, bool full, float c2,
    const RowMask& row, float (&m)[2], float (&l)[2], float (&o)[HD / 8][4],
    int lane) {
  // S = Q K^T: 16 rows x 64 slots per warp
  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t qa[4];
    qsrc.get(ks, qa);
#pragma unroll
    for (int nb2 = 0; nb2 < 4; ++nb2) {
      uint32_t b[4];
      ldsm_x4(b, tk + (nb2 * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD +
                     ks * 16 + (((lane >> 3) & 1) << 3));
      mma(s[2 * nb2], qa, b[0], b[1]);
      mma(s[2 * nb2 + 1], qa, b[2], b[3]);
    }
  }

  // masks and the online softmax, per query row
  float corr[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const auto vis = row(ri);
    float mx = kNone;
    if (full) {  // block-uniform: every score counts
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float x = s[nb][2 * ri + cc] * c2;
          s[nb][2 * ri + cc] = x;
          mx = fmaxf(mx, x);
        }
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int n = nb * 8 + 2 * (lane & 3) + cc;
          const float x = vis(n) ? s[nb][2 * ri + cc] * c2 : -INFINITY;
          s[nb][2 * ri + cc] = x;
          mx = fmaxf(mx, x);
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[ri], mx);
    corr[ri] = exp2f(m[ri] - mn);
    m[ri] = mn;
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float pr = exp2f(s[nb][2 * ri + cc] - mn);  // masked: 0
        s[nb][2 * ri + cc] = pr;
        sum += pr;
      }
    }
    l[ri] = l[ri] * corr[ri] + sum;
  }
  // the accumulator's rescale; a factor of exactly 1 (no row's max
  // moved) changes no bit, so the warp skips it
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
  }

  // O += (P_hi + P_lo) V
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ah[4], al[4];
    split(s[2 * ks][0], s[2 * ks][1], ah[0], al[0]);
    split(s[2 * ks][2], s[2 * ks][3], ah[1], al[1]);
    split(s[2 * ks + 1][0], s[2 * ks + 1][1], ah[2], al[2]);
    split(s[2 * ks + 1][2], s[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
    for (int nd2 = 0; nd2 < HD / 16; ++nd2) {
      uint32_t b[4];
      ldsm_x4_trans(b, tv + (ks * 16 + (((lane >> 3) & 1) << 3) +
                             (lane & 7)) * LD +
                            nd2 * 16 + ((lane >> 4) << 3));
      mma(o[2 * nd2], ah, b[0], b[1]);
      mma(o[2 * nd2], al, b[0], b[1]);
      mma(o[2 * nd2 + 1], ah, b[2], b[3]);
      mma(o[2 * nd2 + 1], al, b[2], b[3]);
    }
  }
}

// fold_tile_q with the warp's Q fragments held in registers (load_q).
template <int HD, int LD, class RowMask>
__device__ __forceinline__ void fold_tile(
    const uint32_t (&qa)[HD / 16][4], const bf16* tk, const bf16* tv,
    bool full, float c2, const RowMask& row, float (&m)[2], float (&l)[2],
    float (&o)[HD / 8][4], int lane) {
  fold_tile_q<HD, LD>(QRegs<HD>{qa}, tk, tv, full, c2, row, m, l, o, lane);
}

// The query group of the 64-row bodies (span, flash): g = H / Kv query
// heads share a kv head, 1 <= g <= kMaxGroup.  A block's 64 query rows are
// tq = 64 / g tokens (or positions) x g heads: row m is token m / g, head
// m % g.  Where g is not a power of two, rows tq * g .. 63 are idle (4 of
// 64 at g 5: 12 tokens x 5 heads): they map to token index tq, which a
// block never fills, so they load no query, see no slot and are written
// nowhere, and each row's softmax state and p-tile scale are its own.  m / g
// is a multiply and a shift: (m * mul) >> 10 with mul = ceil(1024 / g) is
// exact for m < 64 and g <= 16 (m = q g + r: the product is q + (r + m e /
// 1024) / g with e = mul g - 1024 < g, and r + m e / 1024 <= g - 1 + 63 *
// 15 / 1024 < g), and for a power of two it is m >> log2 g.  The int8 span
// body instantiates the power-of-two case apart (POW2: the shift and mask
// it had before any other g), the kernels' launch choosing by lg.
constexpr int kMaxGroup = 16;

struct Group {
  int g, tq, mul, lg;  // g 0: refused; lg: log2 g, or -1 if no power of 2
  __host__ static Group of(int H, int Kv) {
    if (Kv < 1 || H % Kv || H / Kv < 1 || H / Kv > kMaxGroup)
      return Group{0, 0, 0, -1};
    const int g = H / Kv;
    int lg = 0;
    while ((1 << lg) < g) ++lg;
    return Group{g, 64 / g, (1024 + g - 1) / g, (1 << lg) == g ? lg : -1};
  }
  template <bool POW2 = false>
  __device__ __forceinline__ int token(int m) const {
    return POW2 ? m >> lg : (m * mul) >> 10;
  }
  template <bool POW2 = false>
  __device__ __forceinline__ int head(int m) const {
    return POW2 ? m & (g - 1) : m - token(m) * g;
  }
};

// Above 48 KB of dynamic shared memory a kernel must opt in.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tiled
