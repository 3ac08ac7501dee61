// Split body of the int8 decode kernels, paged and over contiguous rows
// (decode_attention_quant.cu: PERF.md rows 2b and 2br, paged, full cache
// and rolling; 2bc and 2bcr over rows), on the int8 tensor cores.
//
// No TPU kernel precedes it: the reference runs the jnp
// decode_attention_quant (repro/models/attention.py:553) on the gathered
// view of its int8 cache or on its cache rows (repro/models/
// transformer.py:110-167).  Row b's new token attends, for the g query
// heads of each kv head, to slots 0..n-1 of its cache row, n =
// positions[b] + 1 (full cache) or min(positions[b] + 1, W) (rolling),
// capped at the row's width.  The int8 cache holds each K/V vector as
// int8 [hd] with one bf16 scale (paged_attention_quant.cuh: the
// quantization rule).  The function, per (row, query head):
//   1. q8, qs = quantize(q); s = ((float(q8 . k8) * qs) * ks) * scale over
//      the n slots, the dot exact in int32;
//   2. m = max s; e = expf(s - m); l = sum e;
//   3. pv = (e / l) * vs, and amax = max |pv|;
//   4. p8 = rint(pv / sp) clipped to +-127, sp = amax / 127 + 1e-8, and
//      ps = bf16(sp);
//   5. out = bf16(float(p8 . v8) * ps), the dot exact in int32.
// The softmax is normalised over the whole context BEFORE p * vs is
// quantized with one scale for the whole row, so a streaming online
// softmax would compute another function: the split below makes one pass
// a step instead.  Every multiply, subtraction and division is a
// separately rounded fp32 operation (the _rn intrinsics), in the plain
// version's order; only the fp32 sum l runs in another order, which
// kernels/_paged.py's quant_flip_term covers (a p8 one step apart at a
// slot whose pv / sp lies on a rounding half-integer).
//
// What bounds it: bytes.  A visible slot costs hd + 2 bytes of K and of V
// and 4 g hd int8 operations, far below the H100's ridge of ~590 int8
// operations per byte; at chip_smoke.py's rolling case (mixtral-8x7b
// widths H 32, Kv 8, hd 128; B 8 at contexts 100-9000, W 4096) the least
// time is 0.0145 ms.  The first kernel ran one 128-thread block per (row,
// kv head) over its whole row (32 blocks at mixtral's B 4), a thread a
// slot with __dp4a, its scores in a device-memory row read three times by
// one warp a head, and an AV product in which each thread walked all n
// slots for its (head, d) pairs through a dependent table load: 5.29 ms at
// that case on an H100 80GB HBM3 at 700 W.  What this body does:
//
//   1. A deterministic split.  Slots 0..n-1 are cut into chunks of kChunk
//      = 512 slots from slot 0, and each pass runs on the grid (B, Kv,
//      ceil(width / kChunk)), width the table's nb * bs or the row's S
//      (min with W when rolling): what the host knows, with no
//      synchronisation.  A block whose chunk starts at or past its row's n
//      exits.  Four launches of one C call, each a grid-wide step of the
//      function; each block repeats the merge of its (row, kv head)'s few
//      chunk values that it needs:
//        scores: step 1's s into the workspace and the chunk's max per
//                head; its slots' V scales for pass 3;
//        sums:   m = max of the chunk maxima (exact in any order), the
//                chunk's sum of e = expf(s - m);
//        pv:     l = the chunk sums added in chunk order; pv over s in the
//                workspace, and the chunk's max |pv|;
//        av:     amax = max of those (exact); p8, written back over pv (a
//                check reads them there); the chunk's int32 p8 . v8 added
//                to its (row, kv head)'s sums by integer atomics (exact in
//                any order); the block that counts itself last of its row's
//                chunks (a threadfence reduction) computes step 5.
//      The workspace (kernels/_paged.py quant_decode_workspace) stores a
//      score where recomputing it would read hd + 2 bytes of K again.
//      Passes 2-4 are launched as programmatic dependents of the pass
//      before (Hopper's griddepcontrol): their blocks start while it ends,
//      pass 4 staging its V rows, and wait for it before they read its
//      results.  Blocks of 128 or 256 slots (tried on the card; the same
//      bits) were faster only where the grid is small (glm4-9b's Kv 2) and
//      slower at mixtral's B 8.
//   2. Int8 tensor cores, mma.sync.m16n8k32 s8 x s8 -> s32 (exact), the g
//      query heads as the rows of one 16-row tile (rows past g are zero:
//      g <= 16).  Scores: B is K (k = hd, n = 8 slots); an exact dot may
//      walk hd in any order, so a lane's 16-byte unit of its slot's row
//      gives its B words of two k-steps, and the query's A words are read
//      from the same byte offsets (k_off).  AV: A is p8 from shared memory
//      (k = 32 slots), B is V (n = 8 d): a lane reads 4 WPT bytes of d
//      from each of its 8 slots and transposes them with byte permutes
//      (tiled::transpose4) into the B words of WPT x 4 n-blocks; column n
//      of n-block (i, c) is d = 4 (WPT n + i) + c.
//   3. Staging.  Passes 1 and 4 copy their chunk's K or V rows into
//      shared memory with 16-byte cp.async copies, all in flight at once
//      (64 KB at hd 128: three blocks an SM), while the block quantizes q
//      (pass 1) or p (pass 4); 16-byte units are swizzled (Tile) so the
//      fragment reads meet no bank conflict at hd 128.  A paged chunk's
//      table entries (at most kChunk / bs + 2) are copied to shared memory
//      once, and a slot's page is a multiply-shift division
//      (tiled::FastDiv); no dependent table load per slot is left.
//   4. Determinism.  The fold order is fixed by slot index alone: chunks
//      of kChunk from slot 0; in a chunk, a head's sum of e over lane l's
//      slots l, l + 32, ... in order, then a butterfly over the 32 lanes;
//      the chunk sums in chunk order.  Maxima and integer sums are exact in
//      any order.  No float atomics: two launches repeat bit for bit, and
//      the paged and contiguous kernels give identical bits whenever nb *
//      bs equals S.  Instantiated for hd in {16, 32, 64, 128}; 1 <= g <= 16
//      at run time.
#pragma once

#include <cmath>
#include <cstdint>

#include "paged_attention_quant.cuh"
#include "tiled_primitives.cuh"

namespace qsplit {

using tiled::bf16;
using i8 = signed char;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // the query tile: g heads, zero rows past g
// Whether passes 2-4 launch as programmatic dependents;
// launch/decode_quant_passes.py builds 0 with -D to time the passes apart
#ifndef QSPLIT_PDL
#define QSPLIT_PDL 1
#endif
constexpr int kChunk = 512;    // slots of one split, from slot 0
constexpr unsigned kAll = 0xffffffffu;

// A corrupt batch stops the kernel: the launch fails loudly.  (A trap, not
// assert: assert's call would make ptxas spill around it.)
__device__ __forceinline__ void check(bool ok) {
  if (!ok) __trap();
}

// Hopper's programmatic dependent launch: this grid's dependents may start
// (their launch overlaps its end), and: wait until the grid this one
// depends on has finished and its writes are visible.
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prior_pass() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__host__ __device__ inline int n_splits(int width) {
  return (width + kChunk - 1) / kChunk;
}

// The arguments every pass takes.
struct Args {
  const bf16* q;           // [B, H, hd]
  const i8* k8;            // the caches' vectors, hd int8 each
  const bf16* ks;          // their scales
  const i8* v8;
  const bf16* vs;
  const int* positions;    // [B]
  float* ws;               // kernels/_paged.py quant_decode_workspace
  bf16* out;               // [B, H * hd]
  int B, H, Kv, hd, n_split, window;
  float scale;
};

// One (row, kv head)'s part of the workspace.  p [n_split][g][kChunk]
// (head j's slot i at p[(i / kChunk) g + j][i % kChunk]); m, l, a
// [n_split][g]; vs [n_split kChunk]; acc [g][hd]; done [1].
struct Group {
  float* p;
  float* l;
  float* m;
  float* a;
  float* vs;
  int* acc;
  int* done;
  int g;
  // head j's entries from slot i on
  __device__ float* p_at(int j, int i) const {
    return p + ((size_t)(i / kChunk) * g + j) * kChunk + i % kChunk;
  }
};

__device__ inline Group group(const Args& a, int b, int kh) {
  const int g = a.H / a.Kv;
  const size_t heads = (size_t)a.B * a.H, bk = (size_t)b * a.Kv + kh;
  const int ns = a.n_split;
  float* l0 = a.ws + heads * ns * kChunk;
  float* m0 = l0 + heads * ns;
  float* a0 = m0 + heads * ns;
  float* vs0 = a0 + heads * ns;
  int* acc0 = reinterpret_cast<int*>(vs0 + (size_t)a.B * a.Kv * ns * kChunk);
  Group w;
  w.g = g;
  w.p = a.ws + bk * ns * g * kChunk;
  w.l = l0 + bk * ns * g;
  w.m = m0 + bk * ns * g;
  w.a = a0 + bk * ns * g;
  w.vs = vs0 + bk * ns * kChunk;
  w.acc = acc0 + bk * g * a.hd;
  w.done = acc0 + heads * a.hd + bk;
  return w;
}

// The maximum of head j's values v[c * g + j], c < count (exact in any
// order).
__device__ __forceinline__ float max_of(const float* v, int count, int g,
                                        int j) {
  float x = v[j];
  for (int c = 1; c < count; ++c) x = fmaxf(x, v[c * g + j]);
  return x;
}

// ---------------------------------------------------------------------------
// Slot addresses of one (row, kv head): the index, in vectors of hd, of a
// slot's K/V vector, also the index of its scale
// ---------------------------------------------------------------------------

// Through one block-table row of a [n_blocks, bs, Kv, hd] cache; the
// entries of the chunk's pages are copied to shared memory by prepare()
// (the caller synchronises before vec()).
struct PagedSlots {
  const int* table;  // this row's [nb] entries
  tiled::FastDiv bs;
  int Kv, kh, n_blocks;
  const int* stab;
  int page0;
  // the pages of slots [c0, c1); a corrupt table fails loudly rather than
  // reading out of the pool
  __device__ void prepare(int c0, int c1, int* smem_table) {
    stab = smem_table;
    page0 = bs.div(c0);
    const int pages = bs.div(c1 - 1) - page0 + 1;
    for (int i = threadIdx.x; i < pages; i += kThreads) {
      const int p = table[page0 + i];
      check(p >= 0 && p < n_blocks);
      smem_table[i] = p;
    }
  }
  __device__ size_t vec(int s) const {
    const int i = bs.div(s);
    return ((size_t)stab[i - page0] * bs.d + (s - i * bs.d)) * Kv + kh;
  }
};

// In one row of a contiguous [R, S, Kv, hd] cache.
struct RowSlots {
  size_t base;  // (row * S) * Kv + kh
  int Kv;
  __device__ void prepare(int, int, int*) {}
  __device__ size_t vec(int s) const { return base + (size_t)s * Kv; }
};

// The two layouts, as the kernels' first argument.
struct PagedRows {
  const int* tables;  // [B, nb]
  tiled::FastDiv bs;
  int nb, n_blocks;
  __device__ int width() const { return nb * bs.d; }
  __device__ PagedSlots slots(int b, int kh, int Kv) const {
    return PagedSlots{tables + (size_t)b * nb, bs, Kv, kh, n_blocks,
                      nullptr, 0};
  }
};

struct ContiguousRows {
  const int* rows;  // [B]: each decode row's cache row
  int R, S;
  __device__ int width() const { return S; }
  __device__ RowSlots slots(int b, int kh, int Kv) const {
    const int row = rows[b];
    check(row >= 0 && row < R);  // a corrupt batch fails loudly
    return RowSlots{(size_t)row * S * Kv + kh, Kv};
  }
};

// ---------------------------------------------------------------------------
// Shared memory of passes 1 and 4 (bytes): the chunk's K (pass 1) or V
// (pass 4) rows, dense, hd bytes each, 16-byte units swizzled so that the
// fragment reads below meet no bank conflict at hd 128
// ---------------------------------------------------------------------------
template <int HD>
struct Tile {
  static constexpr int HDP = HD < 32 ? 32 : HD;  // k-depth 32: hd 16 padded
  static constexpr int KS = HDP / 32;            // score k-steps
  static constexpr int UPR = HD / 16;            // 16-byte units of a row
  static constexpr int ROWS = kChunk * HD;
  static constexpr int TAB = kChunk + 2;         // page entries, at most
  // pass 1: K rows, q8 [kRows][LDQ], qs [kRows], ks [kChunk], the warps'
  // maxima [kWarps][kRows], the page table
  static constexpr int LDQ = HDP + 16;
  static constexpr int Q8_OFF = ROWS;
  static constexpr int QS_OFF = Q8_OFF + kRows * LDQ;
  static constexpr int KS_OFF = QS_OFF + 4 * kRows;
  static constexpr int RED_OFF = KS_OFF + 4 * kChunk;
  static constexpr int TAB1_OFF = RED_OFF + 4 * kWarps * kRows;
  static constexpr int BYTES1 = TAB1_OFF + 4 * TAB;
  // pass 4: V rows (then the warps' int32 sums [kRows][HD]), p8 [kRows]
  // [LDP], ps [kRows], the page table
  static constexpr int LDP = kChunk + 16;
  static constexpr int P8_OFF = ROWS;
  static constexpr int PS_OFF = P8_OFF + kRows * LDP;
  static constexpr int TAB4_OFF = PS_OFF + 4 * kRows;
  static constexpr int BYTES4 = TAB4_OFF + 4 * TAB;
  static_assert(ROWS % 16 == 0 && LDQ % 16 == 0 && LDP % 16 == 0, "units");
  static_assert(4 * kRows * HD <= ROWS, "the sums fit in the rows");
  // where unit u of K row r lies: at hd 128 rows r and r + 1 of an n-block
  // take their units in other bank groups
  __device__ static int k_unit(int u, int r) {
    return HD == 128 ? u ^ (4 * (r & 1)) : u;
  }
  // where unit u of V row r lies: a k-step's lane t4 reads rows with
  // (r / 4) % 4 == t4, so at hd 128 (hd 64) the four (two) values of t4
  // take other bank groups
  __device__ static int v_unit(int u, int r) {
    return HD == 128 ? u ^ (2 * ((r >> 2) & 3))
                     : HD == 64 ? u ^ (2 * ((r >> 2) & 1)) : u;
  }
};

// Copies rows [0, rows) of the chunk from slot c0 on (hd bytes each,
// the slot's vector through src) into dst, unit u of row r at unit
// unit(u, r); rows at or past len are zero-filled without a read.  UPR
// threads a row, one address computation each.
template <int HD, class Src, class Unit>
__device__ __forceinline__ void stage_rows(const Src& src, const i8* cache,
                                           int c0, int len, int rows,
                                           i8* dst, Unit unit) {
  constexpr int UPR = Tile<HD>::UPR, STEP = kThreads / UPR;
  const int u = threadIdx.x % UPR;
  for (int r = threadIdx.x / UPR; r < rows; r += STEP) {
    const bool ok = r < len;
    const i8* from = cache + (ok ? src.vec(c0 + r) * HD + 16 * u : 0);
    tiled::cp_async16(dst + r * HD + 16 * unit(u, r), from, ok);
  }
}

// The block's chunk of row b = blockIdx.x: its first slot c0 and length
// len, the row's visible slots n (pos + 1, or min(pos + 1, W) when
// rolling, capped at the width) and chunk count; false if it starts at or
// past n.
struct Chunk {
  int c0, len, n, nch;
};

template <class Rows>
__device__ __forceinline__ bool chunk_of(const Rows& rows, const Args& a,
                                         Chunk& c) {
  const int pos = a.positions[blockIdx.x];
  check(pos >= 0);  // a corrupt batch fails loudly
  c.n = min(a.window ? min(pos + 1, a.window) : pos + 1, rows.width());
  c.c0 = blockIdx.z * kChunk;
  if (c.c0 >= c.n) return false;
  c.len = min(kChunk, c.n - c.c0);
  c.nch = n_splits(c.n);
  return true;
}

// ---------------------------------------------------------------------------
// Pass 1: the scores of chunk blockIdx.z and its max per head; its slots'
// V scales; chunk 0 clears its (row, kv head)'s sums and count
// ---------------------------------------------------------------------------

// Byte offset, in a K row and in the query's int8 row, of the two words a
// lane (t4 = lane % 4) holds in k-step ks: k = 4 t4 .. 4 t4 + 3 (its first
// B word, A words 0 and 1) and 16 + 4 t4 .. 16 + 4 t4 + 3 (the word 4
// bytes on).  At hd >= 64 a lane's 16-byte unit 4 L + t4 of its slot's row
// holds k-steps 2 L and 2 L + 1; at hd 16 the second word is the zero
// padding.
template <int HD>
__device__ __forceinline__ int k_off(int ks, int t4) {
  if (HD >= 64) return 64 * (ks >> 1) + 16 * t4 + 8 * (ks & 1);
  if (HD == 32) return 8 * t4;
  return 4 * t4;
}

template <int HD, class Rows>
__global__ void __launch_bounds__(kThreads)
scores_kernel(Rows rows, Args a) {
  using T = Tile<HD>;
  constexpr int HDP = T::HDP, KS = T::KS, LDQ = T::LDQ;
  extern __shared__ __align__(16) unsigned char qsplit_smem[];
  i8* sk = reinterpret_cast<i8*>(qsplit_smem);
  i8* sq8 = reinterpret_cast<i8*>(qsplit_smem + T::Q8_OFF);
  float* sqs = reinterpret_cast<float*>(qsplit_smem + T::QS_OFF);
  float* sks = reinterpret_cast<float*>(qsplit_smem + T::KS_OFF);
  float* red = reinterpret_cast<float*>(qsplit_smem + T::RED_OFF);
  let_dependents_start();
  Chunk ch;
  if (!chunk_of(rows, a, ch)) return;
  const int b = blockIdx.x, kh = blockIdx.y, z = blockIdx.z;
  const int g = a.H / a.Kv, c0 = ch.c0, len = ch.len;
  const int nblk = (len + 7) >> 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const Group w = group(a, b, kh);
  auto src = rows.slots(b, kh, a.Kv);
  src.prepare(c0, c0 + len,
              reinterpret_cast<int*>(qsplit_smem + T::TAB1_OFF));
  __syncthreads();

  // the K rows in flight first; then the scales (ks here, vs to the
  // workspace for pass 3), the query, and the cleared sums
  stage_rows<HD>(src, a.k8, c0, len, 8 * nblk, sk,
                 [](int u, int r) { return T::k_unit(u, r); });
  tiled::cp_async_commit();
  for (int r = tid; r < 8 * nblk; r += kThreads) {
    float k = 0.f;
    if (r < len) {
      const size_t v = src.vec(c0 + r);
      k = __bfloat162float(a.ks[v]);
      w.vs[c0 + r] = __bfloat162float(a.vs[v]);
    }
    sks[r] = k;
  }
  // q8 and qs of the g heads (the quantization rule; one warp a head),
  // zero rows past g and bytes past hd
  const bf16* q = a.q + ((size_t)b * a.H + kh * g) * HD;
  for (int j = warp; j < kRows; j += kWarps) {
    if (j < g) {
      float amax = 0.f;
      for (int d = lane; d < HD; d += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(q[j * HD + d])));
      const float sc = pquant::quant_scale(pquant::warp_max(amax));
      for (int d = lane; d < HDP; d += 32)
        sq8[j * LDQ + d] =
            d < HD ? (i8)pquant::quant_value(__bfloat162float(q[j * HD + d]),
                                             sc)
                   : 0;
      if (lane == 0) sqs[j] = pquant::bf16_round(sc);
    } else {
      for (int d = lane; d < HDP; d += 32) sq8[j * LDQ + d] = 0;
      if (lane == 0) sqs[j] = 0.f;
    }
  }
  if (z == 0) {
    for (int e = tid; e < g * HD; e += kThreads) w.acc[e] = 0;
    if (tid == 0) *w.done = 0;
  }
  tiled::cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = k_off<HD>(ks, t4);
    const auto word = [&](int row, int o) {
      return *reinterpret_cast<const uint32_t*>(sq8 + row * LDQ + o);
    };
    qa[ks][0] = word(gq, off);
    qa[ks][1] = word(gq + 8, off);
    qa[ks][2] = HD == 16 ? 0u : word(gq, off + 4);
    qa[ks][3] = HD == 16 ? 0u : word(gq + 8, off + 4);
  }
  const float qs0 = sqs[gq], qs1 = sqs[gq + 8];
  const auto score = [&](int s32, float qs, float k) {
    return __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(s32), qs), k),
                     a.scale);
  };

  // n-blocks of 8 slots, warp w taking w, w + 4, ...: B column gq is slot
  // gq of the n-block; a lane holds the scores of slots 2 t4, 2 t4 + 1 of
  // rows gq and gq + 8
  float* p0 = w.p_at(gq, c0);
  float* p1 = w.p_at(gq + 8, c0);
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int nbk = warp; nbk < nblk; nbk += kWarps) {
    const int r = nbk * 8 + gq;
    const i8* kr = sk + r * HD;
    uint32_t kb[KS][2];
    if constexpr (HD >= 64) {
#pragma unroll
      for (int L = 0; L < HD / 64; ++L) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            kr + 16 * T::k_unit(4 * L + t4, r));
        kb[2 * L][0] = v.x;
        kb[2 * L][1] = v.y;
        kb[2 * L + 1][0] = v.z;
        kb[2 * L + 1][1] = v.w;
      }
    } else if constexpr (HD == 32) {
      const uint2 v = *reinterpret_cast<const uint2*>(kr + 8 * t4);
      kb[0][0] = v.x;
      kb[0][1] = v.y;
    } else {
      kb[0][0] = *reinterpret_cast<const uint32_t*>(kr + 4 * t4);
      kb[0][1] = 0u;
    }
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tiled::mma(acc, qa[ks], kb[ks][0], kb[ks][1]);
    const int i = nbk * 8 + 2 * t4;
    const float k0 = sks[i], k1 = sks[i + 1];
    const float s0 = score(acc[0], qs0, k0), s1 = score(acc[1], qs0, k1);
    const float s2 = score(acc[2], qs1, k0), s3 = score(acc[3], qs1, k1);
    const bool v0 = i < len, v1 = i + 1 < len;
    mx0 = fmaxf(mx0, fmaxf(v0 ? s0 : -INFINITY, v1 ? s1 : -INFINITY));
    mx1 = fmaxf(mx1, fmaxf(v0 ? s2 : -INFINITY, v1 ? s3 : -INFINITY));
    if (gq < g) *reinterpret_cast<float2*>(p0 + i) = make_float2(s0, s1);
    if (gq + 8 < g) *reinterpret_cast<float2*>(p1 + i) = make_float2(s2, s3);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kAll, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kAll, mx1, o));
  }
  if (t4 == 0) {
    red[warp * kRows + gq] = mx0;
    red[warp * kRows + gq + 8] = mx1;
  }
  __syncthreads();
  if (tid < g)
    w.m[z * g + tid] = fmaxf(fmaxf(red[tid], red[kRows + tid]),
                             fmaxf(red[2 * kRows + tid], red[3 * kRows + tid]));
}

// ---------------------------------------------------------------------------
// Pass 2: the sum of e = expf(s - m) over chunk blockIdx.z per head (one
// warp a head)
// ---------------------------------------------------------------------------
template <class Rows>
__global__ void __launch_bounds__(kThreads)
sums_kernel(Rows rows, Args a) {
  constexpr int PER = kChunk / 32;  // slots a lane
  let_dependents_start();
  Chunk ch;
  if (!chunk_of(rows, a, ch)) return;
  const int g = a.H / a.Kv, z = blockIdx.z, len = ch.len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Group w = group(a, blockIdx.x, blockIdx.y);
  wait_for_prior_pass();
  for (int j = warp; j < g; j += kWarps) {
    const float m = max_of(w.m, ch.nch, g, j);
    const float* p = w.p_at(j, ch.c0);
    float x[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      x[k] = i < len ? p[i] : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (lane + 32 * k < len) sum += expf(__fsub_rn(x[k], m));
    sum = pquant::warp_sum(sum);
    if (lane == 0) w.l[z * g + j] = sum;
  }
}

// ---------------------------------------------------------------------------
// Pass 3: pv = (e / l) * vs over the scores of chunk blockIdx.z, and its
// max |pv|
// ---------------------------------------------------------------------------
template <class Rows>
__global__ void __launch_bounds__(kThreads)
pv_kernel(Rows rows, Args a) {
  constexpr int PER = kChunk / 32;  // slots a lane
  let_dependents_start();
  Chunk ch;
  if (!chunk_of(rows, a, ch)) return;
  const int b = blockIdx.x, kh = blockIdx.y, z = blockIdx.z;
  const int g = a.H / a.Kv, c0 = ch.c0, len = ch.len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Group w = group(a, b, kh);
  wait_for_prior_pass();
  for (int j = warp; j < g; j += kWarps) {
    const float m = max_of(w.m, ch.nch, g, j);
    float l = 0.f;
    for (int c = 0; c < ch.nch; ++c) l += w.l[c * g + j];  // chunk order
    float* p = w.p_at(j, c0);
    float x[PER], v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      x[k] = i < len ? p[i] : 0.f;
      v[k] = i < len ? w.vs[c0 + i] : 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      if (i < len) {
        const float pv =
            __fmul_rn(__fdiv_rn(expf(__fsub_rn(x[k], m)), l), v[k]);
        p[i] = pv;
        amax = fmaxf(amax, fabsf(pv));
      }
    }
    amax = pquant::warp_max(amax);
    if (lane == 0) w.a[z * g + j] = amax;
  }
}

// ---------------------------------------------------------------------------
// Pass 4: p8 over pv, the chunk's int32 p8 . v8 added to its (row, kv
// head)'s sums, and, in the chunk that completes them, the output
// ---------------------------------------------------------------------------
template <int HD, class Rows>
__global__ void __launch_bounds__(kThreads)
av_kernel(Rows rows, Args a) {
  using T = Tile<HD>;
  constexpr int LDP = T::LDP, PER = kChunk / 32;
  // 32-bit words of a V row a lane reads per slot (hd 16: lanes gq < 4)
  constexpr int WPT = HD >= 32 ? HD / 32 : 1;
  extern __shared__ __align__(16) unsigned char qsplit_smem[];
  i8* sv = reinterpret_cast<i8*>(qsplit_smem);
  int* so = reinterpret_cast<int*>(qsplit_smem);  // after the products
  i8* sp8 = reinterpret_cast<i8*>(qsplit_smem + T::P8_OFF);
  float* sps = reinterpret_cast<float*>(qsplit_smem + T::PS_OFF);
  __shared__ int last;
  let_dependents_start();
  Chunk ch;
  if (!chunk_of(rows, a, ch)) return;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = a.H / a.Kv, c0 = ch.c0, len = ch.len;
  const int nsteps = (len + 31) >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const Group w = group(a, b, kh);
  auto src = rows.slots(b, kh, a.Kv);
  src.prepare(c0, c0 + len,
              reinterpret_cast<int*>(qsplit_smem + T::TAB4_OFF));
  __syncthreads();
  // the V rows need nothing of the passes before
  stage_rows<HD>(src, a.v8, c0, len, 32 * nsteps, sv,
                 [](int u, int r) { return T::v_unit(u, r); });
  tiled::cp_async_commit();
  wait_for_prior_pass();

  // p8 = quant_value(pv, sp) of the chunk's slots (zero past len and g),
  // into shared memory and, as floats, over pv
  for (int j = warp; j < kRows; j += kWarps) {
    i8* row = sp8 + j * LDP;
    if (j < g) {
      const float sp = pquant::quant_scale(max_of(w.a, ch.nch, g, j));
      if (lane == 0) sps[j] = pquant::bf16_round(sp);
      float* p = w.p_at(j, c0);
      float x[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane + 32 * k;
        x[k] = i < len ? p[i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane + 32 * k;
        int v = 0;
        if (i < len) {
          v = (int)pquant::quant_value(x[k], sp);
          p[i] = (float)v;
        }
        row[i] = (i8)v;
      }
    } else {
      for (int i = lane; i < kChunk; i += 32) row[i] = 0;
    }
  }
  tiled::cp_async_wait<0>();
  __syncthreads();

  // k-steps of 32 slots, warp w taking w, w + 4, ...: a lane's B words come
  // from slots s0 + 4 t4 + (0..3) (first word) and s0 + 16 + 4 t4 + (0..3)
  // (second), 4 WPT bytes of d from each, at d = 4 WPT gq
  int acc[WPT][4][4];
#pragma unroll
  for (int i = 0; i < WPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0;
  const bool lane_d = HD >= 32 || gq < 4;  // hd 16: d = 4 gq + c < 16
  for (int st = warp; st < nsteps; st += kWarps) {
    const int s0 = st * 32;
    uint32_t vw[8][WPT];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = s0 + 4 * t4 + (j & 3) + 16 * (j >> 2);
      const i8* vr = sv + r * HD;
      if constexpr (WPT == 4) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(vr + 16 * T::v_unit(gq, r));
        vw[j][0] = v.x;
        vw[j][1] = v.y;
        vw[j][2] = v.z;
        vw[j][3] = v.w;
      } else if constexpr (WPT == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            vr + 16 * T::v_unit(gq >> 1, r) + 8 * (gq & 1));
        vw[j][0] = v.x;
        vw[j][1] = v.y;
      } else {
        vw[j][0] = lane_d ? *reinterpret_cast<const uint32_t*>(vr + 4 * gq)
                          : 0u;
      }
    }
    const auto pword = [&](int row, int o) {
      return *reinterpret_cast<const uint32_t*>(sp8 + row * LDP + o);
    };
    const uint32_t pa[4] = {pword(gq, s0 + 4 * t4), pword(gq + 8, s0 + 4 * t4),
                            pword(gq, s0 + 16 + 4 * t4),
                            pword(gq + 8, s0 + 16 + 4 * t4)};
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const uint32_t w0[4] = {vw[0][i], vw[1][i], vw[2][i], vw[3][i]};
      const uint32_t w1[4] = {vw[4][i], vw[5][i], vw[6][i], vw[7][i]};
      uint32_t b0[4], b1[4];
      tiled::transpose4(w0, b0);
      tiled::transpose4(w1, b1);
#pragma unroll
      for (int c = 0; c < 4; ++c) tiled::mma(acc[i][c], pa, b0[c], b1[c]);
    }
  }

  // the warps' products summed in shared memory over the V rows, then
  // added to the (row, kv head)'s sums (integers: exact in any order);
  // accumulator r of n-block (i, c) is row gq + 8 (r / 2), column 2 t4 +
  // r % 2, d = 4 (WPT column + i) + c
  __syncthreads();
  for (int e = tid; e < kRows * HD; e += kThreads) so[e] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < WPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = gq + 8 * (r >> 1), col = 2 * t4 + (r & 1);
        const int d = 4 * (WPT * col + i) + c;
        if (row < g && d < HD) atomicAdd(&so[row * HD + d], acc[i][c][r]);
      }
  __syncthreads();
  for (int e = tid; e < g * HD; e += kThreads) atomicAdd(&w.acc[e], so[e]);
  // the chunk that completes the sums writes the output (threadfence
  // reduction: the sums are visible to it before it reads them)
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.done, 1) == ch.nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  bf16* out = a.out + ((size_t)b * a.H + kh * g) * HD;
  for (int e = tid; e < g * HD; e += kThreads)
    out[e] = __float2bfloat16(
        __fmul_rn(__int2float_rn(__ldcg(&w.acc[e])), sps[e / HD]));
}

// Passes 2-4 start as programmatic dependents of the pass before.
template <class Kernel, class Rows>
cudaError_t launch_dependent(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t s, const Rows& rows,
                             const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = QSPLIT_PDL ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, rows, a);
}

// The four passes on the caller's stream; 0 or the CUDA error of the first
// launch that failed.  The caller has checked the shapes.
template <int HD, class Rows>
cudaError_t launch_hd(const Rows& rows, const Args& a, cudaStream_t s) {
  using T = Tile<HD>;
  const dim3 grid(a.B, a.Kv, a.n_split);
  cudaError_t err = tiled::prepare_smem(scores_kernel<HD, Rows>, T::BYTES1);
  if (err != cudaSuccess ||
      (err = tiled::prepare_smem(av_kernel<HD, Rows>, T::BYTES4)) !=
          cudaSuccess)
    return err;
  scores_kernel<HD, Rows><<<grid, kThreads, T::BYTES1, s>>>(rows, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_dependent(sums_kernel<Rows>, grid, 0, s, rows, a)) !=
      cudaSuccess)
    return err;
  if ((err = launch_dependent(pv_kernel<Rows>, grid, 0, s, rows, a)) !=
      cudaSuccess)
    return err;
  return launch_dependent(av_kernel<HD, Rows>, grid, T::BYTES4, s, rows, a);
}

template <class Rows>
cudaError_t launch(const Rows& rows, const Args& a, cudaStream_t s) {
  switch (a.hd) {
    case 16: return launch_hd<16>(rows, a, s);
    case 32: return launch_hd<32>(rows, a, s);
    case 64: return launch_hd<64>(rows, a, s);
    case 128: return launch_hd<128>(rows, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace qsplit
