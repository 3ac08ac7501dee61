// Tiled body of the four int8 span-attention kernels on the tensor cores:
// the full-cache kernels, paged (paged_span_attention_quant.cu, PERF.md
// row 7) and over contiguous rows (span_attention_quant.cu, row 10), and
// the rolling kernels, paged (paged_span_attention_rolling_quant.cu, row 8)
// and over contiguous rows (span_attention_rolling_quant.cu, row 12).
//
// Replaces the TPU kernels repro/kernels/span_attention.py:656
// (paged_span_attention_quant), :239 (span_attention_quant), :761
// (paged_span_attention_rolling_quant) and :456
// (span_attention_rolling_quant).
//
// The function.  The visible slots are those of the bf16 body
// (span_attention_tiled.cuh: a prefix from slot 0 over the full cache; one
// arc of the ring, then the row's own fresh span, when rolling).  The int8
// cache holds each K/V vector as int8 [hd] with one bf16 scale.  Per query
// row (token t, head j; q quantized per row as the reference's quantize_kv
// does), per p-tile of `tile` slots from slot 0 (the reference's kv_block,
// part of the function):
//   1. s = ((float(q8 . k8) * qs) * ks) * scale, the dot exact in int32;
//   2. m' = max(m, max s);
//   3. p = expf(s - m'), l = l * expf(m - m') + sum p;
//   4. p8, ps = quantize(p * vs) over the p-tile (max |p vs| / 127 + 1e-8,
//      rintf, clip to +-127, the scale kept as bf16);
//   5. acc = acc * expf(m - m') + float(p8 . v8) * ps, the dot exact.
// Every multiply, subtraction and division of 1-5 is a separately rounded
// fp32 operation (the _rn intrinsics: no fused multiply-add), in the plain
// version's order, so p8 and ps come out with the plain version's bits;
// only the fp32 sums of l (and of the fresh span) run in another order.
// Then, rolling, the span's own bf16 fresh K/V with full-precision dots
// under the same running softmax (tiled::fold_tile, in log2 units: m is
// scaled by log2 e once, at the switch).  out = acc / max(l, 1e-30).
//
// What bounds it.  Bytes, at both of chip_smoke.py's shapes: mixtral's
// rolling chunk (H 32, Kv 8, hd 128; 256 tokens over 4 rows at W 4096)
// must move its rows' int8 windows, scales, span, q and output once
// (0.0092 ms at 3.35 TB/s) against ~13 G int8 operations for the two
// products (0.0066 ms at 1979 TOP/s); stablelm's full-cache chunk (H = Kv
// = 32, hd 64; prefixes of 96-512 slots) 0.0019 ms of bytes.  The three
// passes below triple the S products (still ~0.02 ms at the int8 rate);
// what keeps the kernel at ~35x its bound (PERF.md rows 7, 8, 10, 12) is
// the fp32 work around each score (two expf, the quotient p vs / scale,
// the mask, the scales, four conversions at a quarter of the fp32 rate)
// and the latency around each sub-tile's step, with one block an SM: the
// mixtral chunk's grid is 128 blocks.  What the design does:
//
//   1. Query tiles: the planning pass and the query-tile layout of the
//      bf16 body (tiled::plan_kernel).  One block computes 64 query rows
//      (64 / g tokens of one cache row x the g heads of one kv head), one
//      warp per 16 rows, so a row's window is read once per 64 query rows
//      instead of once per token.  At hd 128 two warps share each 16
//      rows, one 32-slot half of every sub-tile each (8 warps a block, for
//      the latency): their row maxima and max |p vs| meet in shared memory
//      once a p-tile (exact), their sums l and accumulators are added at
//      the end (fp32 sums in another order).  q8 and qs are computed once
//      per block (paged_attention_quant.cuh's rule); q8 stays in registers
//      as the A fragments.  hd 16 is zero-padded to the k-depth 32.
//   2. Both dots on the int8 tensor cores, mma.sync.m16n8k32 s8 x s8 ->
//      s32: exact, as the function needs.  A warp's 16 rows x a 512-slot
//      p-tile of fp32 scores would take 256 registers a thread, so a
//      p-tile of several 64-slot sub-tiles is walked three times, each
//      pass recomputing S = Q8 K8^T from the staged K (the same bits: the
//      dot is exact): pass 1 the row max, pass 2 p, sum p and max |p vs|,
//      pass 3 p8 (as the A fragments, straight from the S accumulators)
//      and O32 += P8 V8 in int32 over the whole p-tile, then the fp32
//      rescale.  The re-read K sub-tiles (64 KB a p-tile and kv head at
//      hd 128) come from L2; a p-tile of one sub-tile (W 64, one page) is
//      staged once and all three passes run on it.  The scores are not
//      kept in shared memory: 64 x 512 fp32 is 128 KB, one block an SM,
//      and the recomputation costs three k-steps of int8 products a
//      sub-tile, where the softmax's fp32 work per score (two expf, a
//      correctly rounded division) is the larger cost.
//   3. V for the int8 product: m16n8k32's B operand holds four
//      consecutive k (slots) of one n (d) in a register, and the cache
//      keeps d contiguous.  The slots of a k-step are numbered so that a
//      thread's four p8 values of a row are the four S accumulators it
//      already holds (slots 2t, 2t+1, 2t+8, 2t+9 of each 16), and the d
//      columns of n-block c of a 32-wide group are d = 4n + c: a thread
//      then loads four 32-bit words (four d of each of its four slots)
//      and transposes them with byte permutes into the B fragments of
//      four n-blocks.  Its accumulators hold d = 8t .. 8t + 7 of each
//      group, written out as one 16-byte store (full cache) or moved to
//      the bf16 fragment layout through shared memory at the switch to
//      the fresh span (rolling).
//   4. Skipping, exactly.  Sub-tiles that no query row of the block sees
//      are skipped, and sub-tiles that every row sees whole skip the mask.
//      A masked score gets p = 0 (the plain version's -1e30 gives p = 0
//      too once the row has seen a slot), so a row that has seen a slot
//      keeps its state bit for bit on a skipped or invisible sub-tile.  A
//      row that has seen nothing yet (m = -1e30) gets p = 1 there in the
//      plain version; its next visible score sets corr = expf(-1e30 - m')
//      = 0, which wipes those terms exactly, and a visible slot always
//      follows (the prefix holds slot 0; the fresh span holds the token
//      itself).  tests/test_torch_int8_span_tiles.py states the argument.
//   5. Staging: K (and in pass 3 V) sub-tiles of 64 slots by 16-byte
//      cp.async into a 2-deep ring, rows padded by 16 bytes (ldmatrix and
//      the V word loads without bank conflicts), each slot's address
//      computed once by the threads that copy it; the bf16 scales by
//      ordinary loads issued with the copies and converted and stored
//      after the step, so their latency is waited for there.
//      Every score of a 32-slot half is computed without a branch (masked
//      ones are selected away), so a thread's 16 chains interleave; the
//      quotient p vs / scale is a product with the correctly rounded
//      reciprocal, redone with the correctly rounded division only where
//      its rint could differ (within 4 ulp of a half-integer).
//      Addresses through tiled::PagedRowOf (the row's table in shared
//      memory, a multiply-shift page division; a corrupt entry fails
//      loudly) or tiled::ContiguousRowOf.
//   6. Determinism: p-tiles from slot 0, then the fresh entries in index
//      order; no atomics, no split-K, so two launches repeat bit for bit,
//      and the paged and contiguous kernels give identical bits whenever
//      nb * bs == S (one fold order).
//   7. Registers: the fp32 output accumulators live in shared memory
//      (each thread's own entries, read and written once a p-tile), which
//      leaves the registers to the int32 accumulators and the softmax's
//      chains (no spills at any hd); ~168 KB of shared memory a block at
//      hd 128 rolling (the ring sized for the fresh span's bf16 tiles):
//      one 8-warp block an SM, as the mixtral grid has anyway; ~54 KB at
//      hd 64 (stablelm), two 4-warp blocks an SM (block_min).
//
// Why mma.sync and not wgmma: a warp's p8 fragments come from its own S
// accumulators in registers, row by row, with the softmax's per-row state;
// wgmma's A from registers would do the same for a warpgroup of 64 rows,
// but its B must be in shared memory in a K-major layout, which for V
// needs the same transposition staged through shared memory, and these
// kernels spend their time in the softmax's fp32 work, not in the
// products (the int8 products are ~1% of the instructions).
#pragma once

#include "paged_attention_quant.cuh"
#include "span_attention_tiled.cuh"

namespace tiled {
namespace q8 {

using i8 = signed char;

// four 8 x 16-byte matrices (ldmatrix .b16 moves bytes as pairs)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const i8* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// ---------------------------------------------------------------------------
// Shared memory of one block
// ---------------------------------------------------------------------------
template <int HD, bool FULL>
struct QLayout {
  static constexpr int HDP = HD < 32 ? 32 : HD;  // int8 row: k-depth 32
  static constexpr int LD8 = HDP + 16;           // padded int8 row, bytes
  static constexpr int LD16 = Layout<HD>::LD;    // padded bf16 row
  // the ring: DEPTH entries of K8, V8 [kSlots][LD8] and fp32 ks, vs
  // [kSlots] (old cache), or (rolling) two of bf16 K, V [kSlots][LD16]
  // and positions [kSlots] (fresh) in the same bytes
  static constexpr int DEPTH = 2;
  static constexpr int STAGE =
      (2 * kSlots * LD8 + 2 * 4 * kSlots + 15) / 16 * 16;
  static constexpr int FRESH_STAGE =
      (2 * 2 * kSlots * LD16 + 4 * kSlots + 15) / 16 * 16;
  static constexpr int RING = FULL || DEPTH * STAGE > 2 * FRESH_STAGE
                                  ? DEPTH * STAGE
                                  : 2 * FRESH_STAGE;
  // hd 128: 8 warps, two a 16-row group, each taking one 32-slot half of
  // every sub-tile (NH = 2 halves); hd <= 64: 4 warps, two blocks an SM
  static constexpr int NH = HD >= 128 ? 2 : 1;
  static constexpr int THREADS = kThreads * NH;
  static constexpr int MIN_BLOCKS = NH == 2 ? 1 : 2;
  // the output accumulators, fp32 [NH][HDP / 2][kThreads]: each thread's
  // int8-layout fragments (entry (4 n-block + r) * kThreads + its index
  // in its half)
  static constexpr int ACC_OFF = RING;
  // NH 2: the halves' row maxima and max |p vs| ([2][kRows] each) and the
  // second half's sums l ([kThreads][2])
  static constexpr int X_OFF = ACC_OFF + NH * 4 * (HDP / 2) * kThreads;
  static constexpr int Q_OFF = X_OFF + (NH == 2 ? 4 * 8 * kRows : 0);
  static constexpr int Q8_OFF = Q_OFF + 2 * kRows * LD16;  // int8 [kRows][LD8]
  static constexpr int QS_OFF = Q8_OFF + kRows * LD8;   // fp32 [kRows]
  static constexpr int TOK_OFF = QS_OFF + 4 * kRows;    // 4 x int [kRows]
  static constexpr int MISC_OFF = TOK_OFF + 4 * 4 * kRows;  // int [8]
  static constexpr int ITEMS_OFF = MISC_OFF + 32;       // int [...]
  static_assert(Q8_OFF % 16 == 0, "16-byte rows");
  // candidate items: the 64-slot sub-tiles of the p-tiles over w_slots,
  // then (rolling) the fresh tiles; units: at most three passes an item
  __host__ __device__ static int subs(int tile) {
    return (tile + kSlots - 1) / kSlots;
  }
  __host__ __device__ static int old_items(int w_slots, int tile) {
    return (w_slots + tile - 1) / tile * subs(tile);
  }
  __host__ __device__ static int items(int w_slots, int tile, int T) {
    return old_items(w_slots, tile) + (FULL ? 0 : (T + kSlots - 1) / kSlots);
  }
  __host__ __device__ static size_t bytes(int w_slots, int tile, int T,
                                          int table_ints) {
    return ITEMS_OFF + 4 * (4 * (size_t)items(w_slots, tile, T) + table_ints);
  }
};

// The block of the body for head width hd: its threads, and the blocks an
// SM that its registers leave room for (__launch_bounds__)
template <int HD>
constexpr int block_threads() {
  return QLayout<HD, true>::THREADS;
}
template <int HD>
constexpr int block_min() {
  return QLayout<HD, true>::MIN_BLOCKS;
}

// A unit of the walk: an item, its pass, and where it stands in its p-tile
constexpr int kItemMask = (1 << 24) - 1;
constexpr int kPassShift = 24;  // 0: all three passes (a one-sub-tile p-tile)
constexpr int kFirst = 1 << 26;
constexpr int kLast = 1 << 27;  // (kFull, 1 << 30: no row needs the mask)

// Stages old-cache slots [s0, s0 + live) of kv head kh's row with the
// block's NT threads, NT / 64 a slot (one address computation a thread): K
// (and, with_v, V) into dk / dv ([kSlots][LD8]; bytes past HD and slots
// past live are zero-filled without a read).  Returns the slot's ks (the
// slot's first thread) or vs (its second) as bf16 bits, 0 past live: the
// caller converts and stores it after the step, so the load's latency is
// waited for there and not here.
template <int HD, int NT, class Src>
__device__ __forceinline__ unsigned short stage_old(
    const Src& src, const bf16* __restrict__ ks, const bf16* __restrict__ vs,
    int s0, int live, bool with_v, i8* dk, i8* dv) {
  using L = QLayout<HD, true>;
  constexpr int LD = L::LD8, CPS = L::HDP / 16;  // 16-byte chunks a slot
  constexpr int TPS = NT / kSlots, CPT = CPS / TPS;
  static_assert(TPS >= 2 && CPT >= 1 && CPS % TPS == 0, "whole chunks");
  const int j = threadIdx.x / TPS, part = threadIdx.x % TPS;
  const bool ok = j < live;
  const size_t v = ok ? src.vec(s0 + j) : 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = part * CPT + c;
    const bool in = ok && ch * 16 < HD;
    const size_t o = in ? v * HD + ch * 16 : 0;
    cp_async16(dk + j * LD + ch * 16, src.k + o, in);
    if (with_v) cp_async16(dv + j * LD + ch * 16, src.v + o, in);
  }
  if (part >= 2 || !ok) return 0;
  return reinterpret_cast<const unsigned short*>(part == 0 ? ks : vs)[v];
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// S = Q8 K8^T for slots 32 kk .. 32 kk + 31 of a staged sub-tile: n-block
// i holds slots 32 kk + 8 i + 2 (lane % 4) + {0, 1} of rows lane / 4 and
// lane / 4 + 8.
template <int HDP, int LD>
__device__ __forceinline__ void scores32(int (&s)[4][4],
                                         const uint32_t (&qa)[HDP / 32][4],
                                         const i8* tk, int kk, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0;
#pragma unroll
  for (int ks = 0; ks < HDP / 32; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];
      ldsm_x4(b, tk + (32 * kk + 16 * h + ((lane >> 4) << 3) + (lane & 7)) *
                          LD +
                      ks * 32 + (((lane >> 3) & 1) << 4));
      mma(s[2 * h], qa[ks], b[0], b[1]);
      mma(s[2 * h + 1], qa[ks], b[2], b[3]);
    }
  }
}

// The block's 64 query rows (tile blockIdx.x of the plan, kv head
// blockIdx.y) over its row's int8 cache (src: k8, v8; scales ks, vs at
// src.vec) and, rolling, its fresh span entries; POW2: g is a power of two
// (grp.lg >= 0), rows map to tokens by a shift.  q [T, H, hd]; k_span /
// v_span [T, Kv, hd] bf16 (rolling); out [T, H * hd].  FULL: offsets,
// k_span and v_span are not read; window and n_valid are ignored.
template <int HD, bool FULL, bool POW2, class Src>
__device__ __forceinline__ void attend(
    Src src, const bf16* __restrict__ ks, const bf16* __restrict__ vs,
    const bf16* __restrict__ q, const bf16* __restrict__ k_span,
    const bf16* __restrict__ v_span, const int* __restrict__ positions,
    const int* __restrict__ offsets, const int* __restrict__ plan,
    bf16* __restrict__ out, int T, int H, int Kv, Group grp, int rows,
    int w_slots, int tile, int window, int n_valid, float scale,
    unsigned char* smem) {
  using L = QLayout<HD, FULL>;
  constexpr int HDP = L::HDP, LD8 = L::LD8, LD16 = L::LD16;
  constexpr int NB = HDP / 8;   // int8-layout accumulator n-blocks
  constexpr int NH = L::NH, NT = L::THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3;               // the warp's 16 query rows
  const int half = warp >> 2;            // NH 2: its half of each sub-tile
  const int rtid = tid & (kThreads - 1); // its thread among its half's
  const int g = grp.g, tq = grp.tq;
  const int kh = blockIdx.y;
  const Plan p = carve_plan(const_cast<int*>(plan), T, rows, tq);
  const int tile_i = blockIdx.x;
  if (tile_i >= *p.n_tiles) return;
  const int row = p.tiles[3 * tile_i], qfirst = p.tiles[3 * tile_i + 1];
  const int cnt = p.tiles[3 * tile_i + 2];
  const int ffirst = p.row_start[row], nfresh = FULL ? 0 : p.row_n[row];
  const int nsp = L::subs(tile);

  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  i8* sq8 = reinterpret_cast<i8*>(smem + L::Q8_OFF);
  float* sqs = reinterpret_cast<float*>(smem + L::QS_OFF);
  int* tok = reinterpret_cast<int*>(smem + L::TOK_OFF);
  int* tpos = tok + kRows;
  int* tarc = tpos + kRows;   // first slot of each token's arc
  int* tlen = tarc + kRows;   // its length (0: sees no old slot)
  int* misc = reinterpret_cast<int*>(smem + L::MISC_OFF);
  int* items = reinterpret_cast<int*>(smem + L::ITEMS_OFF);

  // 1. the tile's tokens, their arcs, and the block's extent (every
  // entry: a g that is no power of two leaves idle rows at token index tq)
  if (warp == 0) {
    int n_old = 0, pmin = INT_MAX, pmax = INT_MIN;
    for (int j = lane; j < kRows; j += 32) {
      int t = -1, pos = -1, a = 0, len = 0;
      if (j < cnt) {
        t = p.order[qfirst + j];
        pos = positions[t];
        if (FULL) {
          // a corrupt batch fails loudly
          assert(pos >= 0);
          len = min(pos + 1, w_slots);  // slots 0..len-1
          n_old = max(n_old, len);
        } else {
          const int off = offsets[t];
          // a corrupt batch fails loudly
          assert(pos >= off && off >= 0);
          const int lo = max(max(pos - window + 1, off - w_slots), 0);
          len = off - lo;  // positions lo..off-1
          a = len > 0 ? lo % w_slots : 0;
          n_old = max(n_old, min(off, w_slots));
        }
        pmin = min(pmin, pos);
        pmax = max(pmax, pos);
      }
      tok[j] = t;
      tpos[j] = pos;
      tarc[j] = a;
      tlen[j] = max(len, 0);
    }
    for (int o = 16; o > 0; o >>= 1) {
      n_old = max(n_old, __shfl_xor_sync(0xffffffffu, n_old, o));
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, o));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    }
    if (lane == 0) {
      misc[0] = n_old;
      misc[1] = pmin;
      misc[2] = pmax;
    }
  }
  __syncthreads();
  const int n_old = misc[0], pmin = misc[1], pmax = misc[2];
  const int n_old_i = (n_old + tile - 1) / tile * nsp;  // old candidates
  const int n_cand = n_old_i + (nfresh + kSlots - 1) / kSlots;
  int* units = items + n_cand;

  // the query rows in bf16 (zeros past the tile's tokens)
  constexpr int CPQ = HD / 8;
  if (tid < kThreads) {
#pragma unroll
    for (int i = 0; i < kRows * CPQ / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int m = c / CPQ, ch = c - m * CPQ;
      const int t = tok[grp.token<POW2>(m)];
      const bool ok = t >= 0;
      const bf16* s = ok ? q + ((size_t)t * H + kh * g +
                                grp.head<POW2>(m)) * HD
                               + ch * 8
                         : q;
      cp_async16(sq + m * LD16 + ch * 8, s, ok);
    }
  }
  cp_async_commit();
  src.prepare(n_old);

  // 2. which sub-tiles some query row sees (kFull: every row sees all 64
  // of its slots, no mask); fresh tiles (conservatively) by the block's
  // positions and window
  for (int i = tid; i < n_cand; i += NT) items[i] = 0;
  __syncthreads();
  for (int i = tid; i < n_old_i; i += NT) {
    const int P = i / nsp;
    const int s0 = P * tile + (i - P * nsp) * kSlots;
    if (s0 >= n_old) continue;
    const int send = min(s0 + kSlots, (P + 1) * tile);
    const int s1 = min(send, n_old);
    bool need = false, full = send == s0 + kSlots;
    for (int j = 0; j < cnt; ++j) {
      need = need || arc_hits(tarc[j], tlen[j], w_slots, s0, s1);
      full = full && arc_covers(tarc[j], tlen[j], w_slots, s0, send);
    }
    items[i] = full ? kFull : need;
  }
  for (int e = tid; e < nfresh; e += NT) {
    const int u = p.order[ffirst + e];
    if (u < n_valid) {
      const int up = positions[u];
      if (up <= pmax && up > pmin - window) items[n_old_i + e / kSlots] = 1;
    }
  }
  __syncthreads();
  // compacted in order, in place (warp 0)
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_cand; base += 32) {
      const int i = base + lane;
      const int flag = i < n_cand ? items[i] : 0;
      const unsigned b = __ballot_sync(0xffffffffu, flag != 0);
      __syncwarp();
      if (flag) items[n + __popc(b & ((1u << lane) - 1u))] = i | (flag & kFull);
      n += __popc(b);
      __syncwarp();
    }
    if (lane == 0) misc[3] = n;
  }
  __syncthreads();
  // the walk (thread 0): each visible p-tile's sub-tiles once with all
  // three passes when it has one, else in three passes; then the fresh
  // tiles
  if (tid == 0) {
    const int n_vis = misc[3];
    int n = 0, i = 0;
    while (i < n_vis && (items[i] & kItemMask) < n_old_i) {
      const int P = (items[i] & kItemMask) / nsp;
      int e = i + 1;
      while (e < n_vis && (items[e] & kItemMask) < n_old_i &&
             (items[e] & kItemMask) / nsp == P)
        ++e;
      if (e - i == 1) {
        units[n++] = items[i] | kFirst | kLast;
      } else {
        for (int pass = 1; pass <= 3; ++pass)
          for (int k = i; k < e; ++k)
            units[n++] = items[k] | (pass << kPassShift) |
                         (k == i ? kFirst : 0) | (k == e - 1 ? kLast : 0);
      }
      i = e;
    }
    misc[4] = n;
    for (; i < n_vis; ++i) units[n++] = (items[i] & kItemMask) - n_old_i;
    misc[5] = n;
  }

  // 3. q8 and qs of the warp's 16 rows (the quantization rule),
  // then its A fragments
  cp_async_wait<0>();
  __syncthreads();
  const int n_old_u = misc[4], n_units = misc[5];
  for (int r = 0; r < 16 && half == 0; ++r) {
    const int mrow = rg * 16 + r;
    const bf16* qr = sq + mrow * LD16;
    float amax = 0.f;
    for (int d = lane; d < HD; d += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(qr[d])));
    const float qsc = pquant::quant_scale(pquant::warp_max(amax));
    for (int d = lane; d < HDP; d += 32)
      sq8[mrow * LD8 + d] =
          d < HD ? (i8)pquant::quant_value(__bfloat162float(qr[d]), qsc) : 0;
    if (lane == 0) sqs[mrow] = pquant::bf16_round(qsc);
  }
  __syncthreads();
  uint32_t qa[HDP / 32][4];
#pragma unroll
  for (int kb = 0; kb < HDP / 32; ++kb)
    ldsm_x4(qa[kb], sq8 + (rg * 16 + (lane & 15)) * LD8 + kb * 32 +
                        ((lane >> 4) << 4));
  const float qs[2] = {sqs[rg * 16 + gq], sqs[rg * 16 + gq + 8]};
  // the tokens (indices into tok, tpos, tarc, tlen) of those two rows
  const int jr[2] = {grp.token<POW2>(rg * 16 + gq),
                     grp.token<POW2>(rg * 16 + gq + 8)};

  // the output accumulators stay in shared memory, each thread's own
  // entries (read and written once a p-tile): the registers go to the
  // softmax's 16 independent chains a half
  float* acc = reinterpret_cast<float*>(smem + L::ACC_OFF) +
               half * (HDP / 2) * kThreads + rtid;
  float* xm = reinterpret_cast<float*>(smem + L::X_OFF);  // (NH 2)
  float* xa = xm + 2 * kRows;
  float* lx = xa + 2 * kRows;
  int o32[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[(4 * i + r) * kThreads] = 0.f;
    o32[i][0] = o32[i][1] = o32[i][2] = o32[i][3] = 0;
  }
  float m[2] = {kNone, kNone}, l[2] = {0.f, 0.f};
  // the current p-tile: its max, sum, max |p vs|, rescale, scales
  float tmx[2] = {kNone, kNone}, mnew[2] = {kNone, kNone};
  float psum[2] = {0.f, 0.f}, amx[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  float sp[2] = {1.f, 1.f}, rc[2] = {1.f, 1.f}, ps[2] = {0.f, 0.f};

  // a unit's slots: s0, its length in the p-tile, what the row holds
  const auto geom = [&](int unit, int& s0, int& len, int& live) {
    const int it = unit & kItemMask, P = it / nsp;
    s0 = P * tile + (it - P * nsp) * kSlots;
    len = min(kSlots, (P + 1) * tile - s0);
    live = min(len, n_old - s0);
  };
  const auto stage_unit = [&](int unit, int buf) {
    int s0, len, live;
    geom(unit, s0, len, live);
    const int pass = (unit >> kPassShift) & 3;
    i8* dk = reinterpret_cast<i8*>(smem + buf * L::STAGE);
    return stage_old<HD, NT>(src, ks, vs, s0, live, pass == 0 || pass == 3,
                             dk, dk + kSlots * LD8);
  };

  // 4. the old cache, staged DEPTH - 1 units ahead (the scales a unit
  // later: issued with its copies, stored after the step)
  constexpr int DEPTH = L::DEPTH;
  // where this thread's scale goes: ks [kSlots] then vs [kSlots]
  const int sc_at = tid % (NT / kSlots) < 2
                        ? (tid % (NT / kSlots)) * kSlots + tid / (NT / kSlots)
                        : -1;
  const auto scales = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * L::STAGE + 2 * kSlots * LD8);
  };
  unsigned short pre = 0;
  for (int k = 0; k < DEPTH - 1; ++k) {
    if (k < n_old_u) {
      pre = stage_unit(units[k], k);
      if (sc_at >= 0) scales(k)[sc_at] = bf16_bits_to_float(pre);
    }
    cp_async_commit();
  }
  for (int u = 0; u < n_old_u; ++u) {
    const int buf = u % DEPTH, unit = units[u];
    const int ahead = u + DEPTH - 1;
    if (ahead < n_old_u) pre = stage_unit(units[ahead], ahead % DEPTH);
    cp_async_commit();
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
    const i8* tk = reinterpret_cast<const i8*>(smem + buf * L::STAGE);
    const i8* tv = tk + kSlots * LD8;
    const float* ksv = reinterpret_cast<const float*>(tv + kSlots * LD8);
    const float* vsv = ksv + kSlots;
    int s0, len, live;
    geom(unit, s0, len, live);
    const int pass = (unit >> kPassShift) & 3;
    const bool first = unit & kFirst, last = unit & kLast;
    // the thread's 32 scores of the sub-tile that count: bit
    // 16 kk + 4 i + 2 ri + cc (slot 32 kk + 8 i + 2 t4 + cc, row ri)
    unsigned vis = ~0u;  // kFull: all 64 slots, every row
    if (!(unit & kFull)) {
      vis = 0u;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int ra = tarc[jr[ri]], rlen = tlen[jr[ri]];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (NH == 2 && kk != half) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int n = 32 * kk + 8 * i + 2 * t4 + cc;
              const int sl = s0 + n;
              bool ok;
              if (FULL) {
                ok = sl < rlen;
              } else {
                int d = sl - ra;
                if (d < 0) d += w_slots;
                ok = sl < w_slots && d < rlen;
              }
              vis |= (unsigned)(ok && n < len)
                     << (16 * kk + 4 * i + 2 * ri + cc);
            }
          }
        }
      }
    }
    const int nk = len > 32 ? 2 : 1;  // 32-slot halves with slots in them
    // the halves this warp takes
    const int kk0 = NH == 2 ? half : 0, kk1 = NH == 2 ? min(half + 1, nk) : nk;
    // one score of the scores32 block s: (i, ri, cc) of half kk
    const auto score = [&](const int (&s)[4][4], int kk, int i, int ri,
                           int cc) {
      const int n = 32 * kk + 8 * i + 2 * t4 + cc;
      return __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(s[i][2 * ri + cc]),
                                           qs[ri]),
                                 ksv[n]),
                       scale);
    };
    // p * vs of one score under the p-tile's max (0 where it does not
    // count); every element of a half is computed without a branch, so the
    // 16 chains of a thread interleave
    const auto pv_of = [&](const int (&s)[4][4], int kk, int i, int ri,
                           int cc) {
      const float pr = expf(__fsub_rn(score(s, kk, i, ri, cc), mnew[ri]));
      const float pv = __fmul_rn(pr, vsv[32 * kk + 8 * i + 2 * t4 + cc]);
      return vis >> (16 * kk + 4 * i + 2 * ri + cc) & 1u ? pv : 0.f;
    };
    if (pass == 0 || pass == 1) {  // the p-tile's row max
      if (first) tmx[0] = tmx[1] = -INFINITY;
      for (int kk = kk0; kk < kk1; ++kk) {
        int s[4][4];
        scores32<HDP, LD8>(s, qa, tk, kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float x = score(s, kk, i, ri, cc);
              tmx[ri] = fmaxf(tmx[ri],
                              vis >> (16 * kk + 4 * i + 2 * ri + cc) & 1u
                                  ? x : -INFINITY);
            }
      }
      if (last) {
        float x[2];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          x[ri] = tmx[ri];
          x[ri] = fmaxf(x[ri], __shfl_xor_sync(0xffffffffu, x[ri], 1));
          x[ri] = fmaxf(x[ri], __shfl_xor_sync(0xffffffffu, x[ri], 2));
        }
        if (NH == 2) {  // the two halves' maxima
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
            if (t4 == 0) xm[half * kRows + rg * 16 + gq + 8 * ri] = x[ri];
          __syncthreads();
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
            x[ri] = fmaxf(xm[rg * 16 + gq + 8 * ri],
                          xm[kRows + rg * 16 + gq + 8 * ri]);
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) mnew[ri] = fmaxf(m[ri], x[ri]);
      }
    }
    if (pass == 0 || pass == 2) {  // p, its sum, max |p vs|
      if (first) psum[0] = psum[1] = amx[0] = amx[1] = 0.f;
      for (int kk = kk0; kk < kk1; ++kk) {
        int s[4][4];
        scores32<HDP, LD8>(s, qa, tk, kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float pr =
                  expf(__fsub_rn(score(s, kk, i, ri, cc), mnew[ri]));
              const bool on = vis >> (16 * kk + 4 * i + 2 * ri + cc) & 1u;
              psum[ri] += on ? pr : 0.f;
              amx[ri] = fmaxf(
                  amx[ri],
                  on ? fabsf(__fmul_rn(pr, vsv[32 * kk + 8 * i + 2 * t4 + cc]))
                     : 0.f);
            }
      }
      if (last) {
        float x[2];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          x[ri] = amx[ri];
          x[ri] = fmaxf(x[ri], __shfl_xor_sync(0xffffffffu, x[ri], 1));
          x[ri] = fmaxf(x[ri], __shfl_xor_sync(0xffffffffu, x[ri], 2));
        }
        if (NH == 2) {  // the two halves' max |p vs|
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
            if (t4 == 0) xa[half * kRows + rg * 16 + gq + 8 * ri] = x[ri];
          __syncthreads();
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
            x[ri] = fmaxf(xa[rg * 16 + gq + 8 * ri],
                          xa[kRows + rg * 16 + gq + 8 * ri]);
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          sp[ri] = pquant::quant_scale(x[ri]);
          rc[ri] = __frcp_rn(sp[ri]);
          ps[ri] = pquant::bf16_round(sp[ri]);
          corr[ri] = expf(__fsub_rn(m[ri], mnew[ri]));
          l[ri] = l[ri] * corr[ri] + psum[ri];
          m[ri] = mnew[ri];
        }
      }
    }
    if (pass == 0 || pass == 3) {  // p8, O32 += P8 V8, the rescale
      if (first) {
#pragma unroll
        for (int i = 0; i < NB; ++i)
          o32[i][0] = o32[i][1] = o32[i][2] = o32[i][3] = 0;
      }
      for (int kk = kk0; kk < kk1; ++kk) {
        int s[4][4];
        scores32<HDP, LD8>(s, qa, tk, kk, lane);
        // A: k 4 t4 + b <-> slot 32 kk + 8 (b / 2) + 2 t4 + b % 2 (+ 16 for
        // the upper half), the thread's own accumulators.  p8 = rint(x /
        // sp) clipped, x = p vs: the quotient as x * rc (rc = 1 / sp
        // correctly rounded) is within 1.5 ulp of the correctly rounded
        // one, so its rint is that of x / sp unless it lies within 4 ulp of
        // a half-integer; those (rare) elements are redone with the
        // correctly rounded division (pquant::quant_value).
        uint32_t pa[4] = {0u, 0u, 0u, 0u};
        unsigned rare = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float x = pv_of(s, kk, i, ri, cc);
              const float qv = __fmul_rn(fabsf(x), rc[ri]);
              const float fr = __fsub_rn(qv, floorf(qv));
              rare |= (unsigned)(fabsf(fr - 0.5f) <= qv * 4.76837158e-7f)
                      << (4 * i + 2 * ri + cc);
              const int v = (int)copysignf(fminf(rintf(qv), 127.f), x);
              pa[(i >> 1) * 2 + ri] |= (uint32_t)(v & 0xff)
                                       << (8 * ((i & 1) * 2 + cc));
            }
        if (__any_sync(0xffffffffu, rare != 0u)) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int ri = 0; ri < 2; ++ri)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                if (rare >> (4 * i + 2 * ri + cc) & 1u) {
                  const int v = (int)pquant::quant_value(
                      pv_of(s, kk, i, ri, cc), sp[ri]);
                  const int sh = 8 * ((i & 1) * 2 + cc);
                  uint32_t& w = pa[(i >> 1) * 2 + ri];
                  w = (w & ~(0xffu << sh)) | ((uint32_t)(v & 0xff) << sh);
                }
        }
        // B: slots 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 (+ 16) of the half,
        // d = 32 dg + 4 gq + c for n-block (dg, c)
        const i8* vb = tv + (32 * kk + 2 * t4) * LD8 + 4 * gq;
#pragma unroll
        for (int dg = 0; dg < HDP / 32; ++dg) {
          uint32_t w[4], b0[4], b1[4];
          w[0] = *reinterpret_cast<const uint32_t*>(vb + 32 * dg);
          w[1] = *reinterpret_cast<const uint32_t*>(vb + LD8 + 32 * dg);
          w[2] = *reinterpret_cast<const uint32_t*>(vb + 8 * LD8 + 32 * dg);
          w[3] = *reinterpret_cast<const uint32_t*>(vb + 9 * LD8 + 32 * dg);
          transpose4(w, b0);
          w[0] = *reinterpret_cast<const uint32_t*>(vb + 16 * LD8 + 32 * dg);
          w[1] = *reinterpret_cast<const uint32_t*>(vb + 17 * LD8 + 32 * dg);
          w[2] = *reinterpret_cast<const uint32_t*>(vb + 24 * LD8 + 32 * dg);
          w[3] = *reinterpret_cast<const uint32_t*>(vb + 25 * LD8 + 32 * dg);
          transpose4(w, b1);
#pragma unroll
          for (int c = 0; c < 4; ++c) mma(o32[4 * dg + c], pa, b0[c], b1[c]);
        }
      }
      if (last) {
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[(4 * i + r) * kThreads] = __fadd_rn(
                __fmul_rn(acc[(4 * i + r) * kThreads], corr[r >> 1]),
                __fmul_rn(__int2float_rn(o32[i][r]), ps[r >> 1]));
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
    if (ahead < n_old_u && sc_at >= 0)
      scales(ahead % DEPTH)[sc_at] = bf16_bits_to_float(pre);
  }
  cp_async_wait<0>();

  // NH 2: the second half's partial sums l to the first half's threads,
  // which finish; acc_at(a, e): entry e of the thread's accumulators over
  // both halves (a: its first half's)
  if (NH == 2) {
    if (half == 1) {
      lx[2 * rtid] = l[0];
      lx[2 * rtid + 1] = l[1];
    }
    __syncthreads();
    if (half == 0) {
      l[0] += lx[2 * rtid];
      l[1] += lx[2 * rtid + 1];
    }
  }
  const auto acc_at = [&](const float* a, int e) {
    return NH == 2 ? a[e * kThreads] + a[(HDP / 2 + e) * kThreads]
                   : a[e * kThreads];
  };

  if (FULL) {
    if (half == 1) return;
    // out = acc / l, rounded to bf16: a thread's accumulators of n-block
    // (dg, c) hold d = 32 dg + 8 t4 + 4 e + c of its rows (r = 2 ri + e)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float lsum = l[ri];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float den = fmaxf(lsum, 1e-30f);
      const int mrow = rg * 16 + gq + ri * 8;
      const int j = jr[ri];
      if (j < cnt) {
        bf16* dst = out + ((size_t)tok[j] * H + kh * g +
                           grp.head<POW2>(mrow)) * HD;
#pragma unroll
        for (int dg = 0; dg < HDP / 32; ++dg) {
          const int d0 = 32 * dg + 8 * t4;
          if (d0 >= HD) continue;
          uint4 v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int h = 0; h < 4; ++h) {  // d0 + 2 h, d0 + 2 h + 1
            const int e = h >> 1, c = (h & 1) * 2;
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(
                acc_at(acc, 4 * (4 * dg + c) + 2 * ri + e) / den,
                acc_at(acc, 4 * (4 * dg + c + 1) + 2 * ri + e) / den);
            w[h] = *reinterpret_cast<const uint32_t*>(&b2);
          }
          *reinterpret_cast<uint4*>(dst + d0) = v;
        }
      }
    }
    return;
  }

  // 5. (rolling) the switch to the fresh span: the accumulators into the
  // bf16 fragment layout of tiled::fold_tile (d = 8 nd + 2 t4 + e of row
  // gq + 8 ri, held by lane gq * 4 + (d % 32) / 8 of this warp as r = 2 ri
  // + (d % 8) / 4 of n-block 4 (d / 32) + d % 4), m into log2 units, the
  // bf16 query fragments; the first half's warps fold the fresh span
  __syncwarp();
  float o[HD / 8][4];
  {
    const float* wacc =
        reinterpret_cast<const float*>(smem + L::ACC_OFF) + rg * 32;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = 8 * nd + 2 * t4 + (r & 1);
        const int i = 4 * (d >> 5) + (d & 3);
        const int rr = 2 * (r >> 1) + ((d >> 2) & 1);
        o[nd][r] = acc_at(wacc + gq * 4 + ((d & 31) >> 3), 4 * i + rr);
      }
  }
  __syncthreads();  // the ring is restaged below
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) m[ri] = m[ri] == kNone ? kNone : m[ri] * kLog2e;
  uint32_t qb[HD / 16][4];
  load_q<HD, LD16>(qb, sq, rg, lane);
  const float c2 = scale * kLog2e;
  const int* forder = p.order + ffirst;
  const int n_fresh_u = n_units - n_old_u;
  const auto fresh_stage = [&](int f, int buf) {
    if (tid >= kThreads) return;
    bf16* dk = reinterpret_cast<bf16*>(smem + buf * L::FRESH_STAGE);
    stage_fresh<HD>(k_span, v_span, positions, forder,
                    units[n_old_u + f] * kSlots, nfresh, n_valid, Kv, kh, dk,
                    dk + kSlots * LD16,
                    reinterpret_cast<int*>(dk + 2 * kSlots * LD16));
  };
  if (n_fresh_u > 0) fresh_stage(0, 0);
  cp_async_commit();
  for (int f = 0; f < n_fresh_u; ++f) {
    const int buf = f & 1;
    if (f + 1 < n_fresh_u) fresh_stage(f + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tk =
        reinterpret_cast<const bf16*>(smem + buf * L::FRESH_STAGE);
    const int* up = reinterpret_cast<const int*>(tk + 2 * kSlots * LD16);
    const auto row_mask = [&](int ri) {
      const int rpos = tpos[jr[ri]];
      return [=](int n) {
        const int u = up[n];
        return u <= rpos && u > rpos - window;
      };
    };
    if (half == 0)
      fold_tile<HD, LD16>(qb, tk, tk + kSlots * LD16, false, c2, row_mask,
                          m, l, o, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  if (half == 1) return;

  // out = O / l, rounded to bf16; rows past the tile's tokens are dropped
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lsum = l[ri];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float den = fmaxf(lsum, 1e-30f);
    const int mrow = rg * 16 + gq + ri * 8;
    const int j = jr[ri];
    if (j < cnt) {
      bf16* dst = out + ((size_t)tok[j] * H + kh * g +
                         grp.head<POW2>(mrow)) * HD
                  + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
            __floats2bfloat162_rn(o[nd][2 * ri] / den,
                                  o[nd][2 * ri + 1] / den);
    }
  }
}

}  // namespace q8
}  // namespace tiled
