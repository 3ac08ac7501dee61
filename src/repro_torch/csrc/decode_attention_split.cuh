// Split body of the two bf16 decode kernels, paged (paged_decode_attention)
// and over contiguous rows (contiguous_decode_attention), both in
// decode_attention.cu: PERF.md rows 2, 2r (paged, full cache and rolling)
// and 2c, 2cr (rows), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:72
// (decode_attention, body _kernel at :87): row b's new token attends, for
// the g query heads of each kv head, to slots 0..n-1 of its cache row, n =
// positions[b] + 1 (full cache), or min(positions[b] + 1, W) (rolling; the
// reference's jnp decode_attention(rolling_window=W),
// repro/models/transformer.py:102-167), capped at the row's width.  The
// rolling modes and the paged layout are the port's own; the contiguous
// full-cache mode is the TPU kernel's own layout.
//
// What bounds it: bytes.  Each visible slot costs 4 * hd bytes of K and V
// and 4 * g * hd operations, at most 64 per byte at g 16, far below the
// H100's ridge of ~295 bf16 operations per byte.  At chip_smoke.py's
// rolling case (mixtral-8x7b widths H 32, Kv 8, hd 128; B 8 at contexts
// 100-9000, W 4096) the least time is 0.0286 ms for the bytes.  The first
// kernel ran one 128-thread block per (row, kv head) over its whole row:
// 32 blocks for 132 SMs at mixtral's B 4, each staging one element a
// thread (a division, a dependent table load) into fp32 tiles and scoring
// with scalar FMAs.  What this body does about that:
//
//   1. A deterministic split of the visible slots (flash-decoding).  Slots
//      0..n-1 are cut into chunks of kChunk = 512 slots from slot 0; the
//      grid is (B, Kv, ceil(width / kChunk)), width the table's nb * bs or
//      the row's S (min with W when rolling): what the host knows, with no
//      synchronisation.  A block whose chunk starts at or past its row's n
//      exits.  Each block folds its chunk into an fp32 online softmax and
//      writes (max, sum, o[g][hd]) to a workspace; a second kernel of the
//      same C entry then merges chunks 0..ceil(n / kChunk)-1 of each (row,
//      kv head) in chunk order and writes the bf16 output.  A row of one
//      chunk is written by its block directly.
//   2. Tensor cores.  The g query heads of the kv head are the rows of one
//      16-row mma.sync.m16n8k16 tile (rows past g are zero: g <= 16).  Each
//      of the 4 warps takes 16 slots of every 64-slot tile and keeps its own
//      online softmax over them; S = Q K^T and O += P V are bf16 products
//      into fp32, P split into bf16 hi + lo (one bf16 P misses the kernels'
//      limit at mixtral's widths: tests/test_torch_decode_split.py).  The
//      4 warps' states are merged in warp order through shared memory at
//      the end of the chunk.
//   3. Asynchronous staging.  64-slot K and V tiles are staged in bf16 with
//      16-byte cp.async copies into a 2-deep ring, rows padded by 16 bytes
//      for ldmatrix (.trans for V).  A paged chunk's table entries (at most
//      kChunk / bs + 2) are copied to shared memory once, and a slot's page
//      is a multiply-shift division (tiled::FastDiv).  Slots past n are
//      zero-filled without a read and score -inf.
//   4. Occupancy.  74 KB of shared memory a block at hd 128, 40 KB at
//      hd 64, and up to 166 registers a thread: three blocks an SM.  At
//      mixtral's B 4 the grid holds up to 256 blocks.
//
// The split size and the ring's depth were chosen on the card
// (launch/decode_split_sweep.py, an H100 80GB HBM3 at 700 W): 512 slots
// and 2 stages took 0.0500 ms at chip_smoke.py's W = 4096 case against
// 0.0646 for 256 and 3, and were within 0.002 ms of the best at
// stablelm's, glm4-9b's and whisper's shapes.
//
// Invariants.  The fold order is fixed by slot index alone: chunks of
// kChunk from slot 0, 64-slot tiles within a chunk, 16 slots a warp, the
// warps merged in order, the chunks merged in order.  kChunk is a
// constant, never a function of nb, S, B or the table's bucket, so the
// paged and contiguous kernels give identical bits whenever the table's
// width nb * bs equals the row width S, and SiPipe and Naive fold alike.  No
// float atomics: two launches repeat bit for bit.  Instantiated for hd in
// {16, 32, 64, 128, 256}; 1 <= g <= 16 at run time.  At hd 256
// (recurrentgemma-9b, row 2cr) the query tile stays in shared memory and
// its fragments are re-read at every k-step (tiled::QShared), and a block
// takes ~142 KB of shared memory: one block an SM.
#pragma once

#include <cassert>
#include <cmath>
#include <cstdint>

#include "tiled_primitives.cuh"

namespace splitk {

using tiled::bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // the query tile: g heads, zero rows past g
constexpr int kSlots = 64;     // slots of a staged tile, 16 a warp
// The split size and the ring's depth; launch/decode_split_sweep.py
// builds other values with -D to time them
#ifndef DECODE_SPLIT_SLOTS
#define DECODE_SPLIT_SLOTS 512
#endif
#ifndef DECODE_SPLIT_STAGES
#define DECODE_SPLIT_STAGES 2
#endif
constexpr int kChunk = DECODE_SPLIT_SLOTS;   // slots of one split, from slot 0
constexpr int kStages = DECODE_SPLIT_STAGES;  // depth of the cp.async ring
static_assert(kChunk % kSlots == 0 && kSlots == 16 * kWarps && kStages >= 2,
              "tiling");

// Visible slots of a decode row at position pos, capped at the width.
__host__ __device__ __forceinline__ int visible(int pos, int window,
                                                int width) {
  const int n = window ? (pos + 1 < window ? pos + 1 : window) : pos + 1;
  return n < width ? n : width;
}

__host__ __device__ inline int n_splits(int width) {
  return (width + kChunk - 1) / kChunk;
}

// fp32 entries of one (row, kv head, chunk)'s partial state: max and sum of
// each of the g heads, then their unnormalised outputs [g][hd].
__host__ __device__ inline int partial_floats(int g, int hd) {
  return g * (hd + 2);
}

// ---------------------------------------------------------------------------
// Slot addresses of one (row, kv head), within one chunk
// ---------------------------------------------------------------------------

// Slots of one block-table row of a [n_blocks, bs, Kv, hd] cache; the
// entries of the chunk's pages are copied to shared memory by prepare().
struct PagedChunk {
  const bf16* k;
  const bf16* v;
  const int* table;  // this row's [nb] entries
  tiled::FastDiv bs;
  int Kv, kh, n_blocks;
  int* stab;
  int page0;
  // the pages of slots [c0, c1); a corrupt table fails loudly rather than
  // reading out of the pool
  __device__ void prepare(int c0, int c1, int* smem_table) {
    stab = smem_table;
    page0 = bs.div(c0);
    const int pages = bs.div(c1 - 1) - page0 + 1;
    for (int i = threadIdx.x; i < pages; i += kThreads) {
      const int b = table[page0 + i];
      assert(b >= 0 && b < n_blocks);
      stab[i] = b;
    }
  }
  template <int HD>
  __device__ size_t offset(int s) const {
    const int i = bs.div(s);
    return (((size_t)stab[i - page0] * bs.d + (s - i * bs.d)) * Kv + kh) *
           HD;
  }
};

// Slots of row `row` of a contiguous [R, S, Kv, hd] cache.
struct ContiguousChunk {
  const bf16* k;
  const bf16* v;
  int row, S, Kv, kh;
  __device__ void prepare(int, int, int*) {}
  template <int HD>
  __device__ size_t offset(int s) const {
    return (((size_t)row * S + s) * Kv + kh) * HD;
  }
};

// ---------------------------------------------------------------------------
// Shared memory of one block (bytes)
// ---------------------------------------------------------------------------
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;         // padded row, bf16
  static constexpr int TILE = kSlots * LD;  // one K or V stage, bf16
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + 2 * kRows * LD;
  static constexpr int V_OFF = K_OFF + 2 * kStages * TILE;
  static constexpr int TAB_OFF = V_OFF + 2 * kStages * TILE;
  static constexpr int BYTES = TAB_OFF + 4 * (kChunk + 2);
  // after the fold, from byte 0: each warp's state, for the block's merge
  static constexpr int MERGE_M = 0;                         // [kWarps][kRows]
  static constexpr int MERGE_L = MERGE_M + 4 * kWarps * kRows;
  static constexpr int MERGE_O = MERGE_L + 4 * kWarps * kRows;  // [..][HD]
  static_assert(K_OFF % 16 == 0 && V_OFF % 16 == 0, "16-byte stages");
  static_assert(MERGE_O + 4 * kWarps * kRows * HD <= TAB_OFF,
                "the merge fits in the ring");
};

// Stages slots [s0, s0 + 64) of the source into one ring entry (dk, dv:
// [kSlots][LD] bf16); slots at or past c1 are zero-filled without a read.
template <int HD, class Src>
__device__ __forceinline__ void stage(const Src& src, int s0, int c1,
                                      bf16* dk, bf16* dv) {
  constexpr int LD = Layout<HD>::LD, CPS = HD / 8;
  static_assert(kSlots * CPS % kThreads == 0, "whole copy rounds");
#pragma unroll
  for (int i = 0; i < kSlots * CPS / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int j = c / CPS, ch = c - j * CPS;
    const int s = s0 + j;
    const bool ok = s < c1;
    const size_t o = ok ? src.template offset<HD>(s) + ch * 8 : 0;
    tiled::cp_async16(dk + j * LD + ch * 8, src.k + o, ok);
    tiled::cp_async16(dv + j * LD + ch * 8, src.v + o, ok);
  }
}

// Chunk blockIdx.z of one decode row (q, out: its [H, HD] rows), for the
// g query heads of kv head kh, over its n visible slots.  ws: the (row, kv
// head)'s partial states, [n_splits][partial_floats(g, HD)].
template <int HD, class Src>
__device__ __forceinline__ void fold_chunk(Src src,
                                           const bf16* __restrict__ q, int n,
                                           int g, int kh, float scale,
                                           float* __restrict__ ws,
                                           bf16* __restrict__ out,
                                           unsigned char* smem) {
  using L = Layout<HD>;
  constexpr int LD = L::LD, CPS = HD / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.z;
  const int c0 = chunk * kChunk;
  if (c0 >= n) return;
  const int c1 = min(c0 + kChunk, n);
  const int nt = (c1 - c0 + kSlots - 1) / kSlots;

  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V_OFF);

  // the query tile (zeros past the g heads) and the chunk's table entries
  for (int c = tid; c < kRows * CPS; c += kThreads) {
    const int m = c / CPS, ch = c - m * CPS;
    const bool ok = m < g;
    tiled::cp_async16(sq + m * LD + ch * 8,
                      ok ? q + (size_t)(kh * g + m) * HD + ch * 8 : q, ok);
  }
  src.prepare(c0, c1, reinterpret_cast<int*>(smem + L::TAB_OFF));
  __syncthreads();

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {  // group 0 holds the queries
    if (st < nt)
      stage<HD>(src, c0 + st * kSlots, c1, sk + st * L::TILE,
                sv + st * L::TILE);
    tiled::cp_async_commit();
  }

  // hd 256 re-reads its Q fragments from shared memory at every k-step
  // (tiled::QShared): held, they would spill beside the accumulator
  constexpr bool kQShared = HD > 128;
  uint32_t qa[kQShared ? 1 : HD / 16][4];
  const tiled::QShared<LD> qs{sq, lane};
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {tiled::kNone, tiled::kNone}, l[2] = {0.f, 0.f};
  const float c2 = scale * tiled::kLog2e;

  for (int it = 0; it < nt; ++it) {
    tiled::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it is here; tile it - 1's entry is free
    const int nx = it + kStages - 1;
    if (nx < nt)
      stage<HD>(src, c0 + nx * kSlots, c1, sk + (nx % kStages) * L::TILE,
                sv + (nx % kStages) * L::TILE);
    tiled::cp_async_commit();
    if constexpr (!kQShared) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) qs.get(ks, qa[ks]);
      }
    }
    const int s0 = c0 + it * kSlots + warp * 16;  // this warp's 16 slots
    if (s0 >= c1) continue;  // none visible: the state stays as it is
    const bf16* tk = sk + (it % kStages) * L::TILE + warp * 16 * LD;
    const bf16* tv = sv + (it % kStages) * L::TILE + warp * 16 * LD;

    // S = Q K^T: 16 rows x 16 slots
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4], a[4];
      if constexpr (kQShared)
        qs.get(ks, a);
      else
        tiled::QRegs<HD>{qa}.get(ks, a);
      tiled::ldsm_x4(b, tk + (((lane >> 4) << 3) + (lane & 7)) * LD +
                            ks * 16 + (((lane >> 3) & 1) << 3));
      tiled::mma(s[0], a, b[0], b[1]);
      tiled::mma(s[1], a, b[2], b[3]);
    }

    // the online softmax of this warp's slots, per query row
    const bool full = s0 + 16 <= c1;
    float corr[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = tiled::kNone;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const bool vis = full || s0 + t * 8 + 2 * (lane & 3) + cc < c1;
          const float x = vis ? s[t][2 * ri + cc] * c2 : -INFINITY;
          s[t][2 * ri + cc] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[ri], mx);
      corr[ri] = exp2f(m[ri] - mn);
      m[ri] = mn;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float pr = exp2f(s[t][2 * ri + cc] - mn);  // masked: 0
          s[t][2 * ri + cc] = pr;
          sum += pr;
        }
      }
      l[ri] = l[ri] * corr[ri] + sum;
    }
    // a factor of exactly 1 (no row's max moved) changes no bit
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
    uint32_t ah[4], al[4];
    tiled::split(s[0][0], s[0][1], ah[0], al[0]);
    tiled::split(s[0][2], s[0][3], ah[1], al[1]);
    tiled::split(s[1][0], s[1][1], ah[2], al[2]);
    tiled::split(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
    for (int nd2 = 0; nd2 < HD / 16; ++nd2) {
      uint32_t b[4];
      tiled::ldsm_x4_trans(b, tv + ((((lane >> 3) & 1) << 3) + (lane & 7)) *
                                       LD +
                                  nd2 * 16 + ((lane >> 4) << 3));
      tiled::mma(o[2 * nd2], ah, b[0], b[1]);
      tiled::mma(o[2 * nd2], al, b[0], b[1]);
      tiled::mma(o[2 * nd2 + 1], ah, b[2], b[3]);
      tiled::mma(o[2 * nd2 + 1], al, b[2], b[3]);
    }
  }
  tiled::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the merge reuses it

  // each warp's state: its rows' max, sum (over the row's 4 lanes) and
  // accumulator
  float* mm = reinterpret_cast<float*>(smem + L::MERGE_M);
  float* ml = reinterpret_cast<float*>(smem + L::MERGE_L);
  float* mo = reinterpret_cast<float*>(smem + L::MERGE_O);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lsum = l[ri];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int r = warp * kRows + (lane >> 2) + ri * 8;
    if ((lane & 3) == 0) {
      mm[r] = m[ri];
      ml[r] = lsum;
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(mo + r * HD + nd * 8 + 2 * (lane & 3)) =
          make_float2(o[nd][2 * ri], o[nd][2 * ri + 1]);
  }
  __syncthreads();

  // the warps merged in order; a row of one chunk is finished here
  const bool single = n <= kChunk;
  float* part = ws + (size_t)chunk * partial_floats(g, HD);
  for (int i = tid; i < g * HD; i += kThreads) {
    const int j = i / HD, d = i - j * HD;
    float mx = tiled::kNone;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mm[w * kRows + j]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(mm[w * kRows + j] - mx);  // an idle warp: 0
      lsum += ml[w * kRows + j] * c;
      acc += mo[(w * kRows + j) * HD + d] * c;
    }
    if (single) {
      out[(size_t)(kh * g + j) * HD + d] =
          __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
    } else {
      if (d == 0) {
        part[j] = mx;
        part[g + j] = lsum;
      }
      part[2 * g + j * HD + d] = acc;
    }
  }
}

// Chunks 0..ceil(n / kChunk)-1 of one (row, kv head) merged in chunk order
// (ws: its [n_splits][partial_floats(g, hd)] states) into the bf16 output
// of its g heads (out: their [g][hd] rows).  Rows of one chunk were
// written by their block.
__device__ __forceinline__ void merge_chunks(const float* __restrict__ ws,
                                             int n, int g, int hd,
                                             bf16* __restrict__ out) {
  const int nch = (n + kChunk - 1) / kChunk;
  if (nch <= 1) return;
  const int stride = partial_floats(g, hd);
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    const int j = i / hd, d = i - j * hd;
    float mx = tiled::kNone;
    for (int c = 0; c < nch; ++c) mx = fmaxf(mx, ws[c * stride + j]);
    float lsum = 0.f, acc = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float* p = ws + c * stride;
      const float w = exp2f(p[j] - mx);
      lsum += p[g + j] * w;
      acc += p[2 * g + j * hd + d] * w;
    }
    out[j * hd + d] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace splitk
