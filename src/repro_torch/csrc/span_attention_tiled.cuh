// Tiled body of the four bf16 span-attention kernels on the tensor cores:
// the full-cache kernels, paged (paged_span_attention.cu, PERF.md row 1)
// and over contiguous rows (span_attention.cu, row 9), and the rolling
// kernels, paged (paged_span_attention_rolling.cu, row 6) and over
// contiguous rows (span_attention_rolling.cu, row 11).
//
// Replaces the TPU kernels repro/kernels/span_attention.py:611
// (paged_span_attention), :132 (span_attention), :703
// (paged_span_attention_rolling) and :519 (span_attention_rolling).
//
// Full cache (FULL = true).  The engine writes the chunk's K/V into the
// cache before the call; token t (position pos, cache row seq_idx[t])
// attends slots [0, min(pos + 1, w_slots)) of its row, w_slots the table's
// nb * bs or the row's S.  Every token of a query tile sees a prefix of its
// row from slot 0, so only the tiles that cross some token's last slot
// need the mask, and tiles past the tile's longest prefix are skipped.
//
// Rolling (FULL = false).  Token t (position pos, cache row seq_idx[t],
// whose rolling cache holds positions [0, off = offsets[t]) with position
// p at slot p mod w_slots) attends, under one running fp32 softmax:
//   1. the old cache: slot s < min(off, w_slots) counts iff the position it
//      stores, off-1-((off-1-s) mod w_slots), lies inside the window
//      (> pos - W).  Those slots form one arc of the ring: positions
//      [max(pos-W+1, off-w_slots, 0), off-1], at slots position mod w_slots;
//   2. the span's own fresh K/V: entry u counts iff it is of the same row,
//      at or before pos, inside the window, and u < n_valid (bucket padding
//      repeats the last valid token).
// (The full-cache mode is the arc from slot 0 of length min(pos + 1,
// w_slots), with no fresh span.)
//
// What bounds it.  At chip_smoke.py's rolling case (mixtral-8x7b widths:
// H 32, Kv 8, hd 128; a 256-token chunk over 4 rows, W 4096) the least
// time is 0.0167 ms for the bytes (each row's visible window read once)
// and about 0.013 ms for the operations at the bf16 tensor-core rate: the
// two are close, so the design has to cut both the bytes re-read and the
// instructions around each product.  The full-cache case (stablelm: H = Kv
// = 32, hd 64, the same chunk over prefixes of 96-512 slots) is bound by
// its bytes, 0.0031 ms: a few thousand slots of 128 B of K and V per kv
// head, which a block per token would read once per token.  What the
// design does:
//
//   1. Query tiles.  One block (4 warps) computes 64 query rows for one kv
//      head: 64/g tokens of ONE cache row x the g query heads of that kv
//      head (row m of the tile is token m / g, head m % g).  Every K/V tile
//      it stages serves all of them, so a row's window is read once per
//      64 query rows instead of once per token.  A planning pass
//      (plan_kernel, one block) groups the tokens by row, in index order,
//      whatever the order of seq_idx, and cuts each row's tokens into
//      tiles; the main grid is ceil(T / (64/g)) + min(rows, T) blocks (an
//      upper bound known on the host), and blocks past the plan's tile
//      count exit.  Nothing goes back to the host.
//   2. Tensor cores.  S = Q K^T and O += P V are mma.sync.m16n8k16 bf16
//      products with fp32 accumulators, one warp per 16 query rows (as in
//      FlashAttention-2); Q stays in registers.  The online softmax is
//      kept per query row in fp32 registers (exp2 of scores pre-scaled by
//      log2 e).  P is split into bf16 hi + lo = bf16(p - hi) and both are
//      multiplied into the same fp32 accumulator (tiled::fold_tile).  Each
//      query row's mask comes from its own pos and off (its arc; its
//      fresh-window bounds).
//   3. Asynchronous staging.  K and V tiles of 64 slots are staged in bf16
//      with 16-byte cp.async copies into a 2-deep ring (one kv head's slot
//      is hd * 2 contiguous bytes), rows padded by 16 bytes so ldmatrix
//      (.trans for V) reads without bank conflicts.  A paged row's table
//      is copied to shared memory once per block (one global read per
//      page), so a slot's address is a shared-memory read and a multiply-
//      shift division by the page size.  Tiles that no query row of the
//      block can see are skipped, and tiles that every query row sees
//      whole skip the mask; slots past the block's largest visible extent
//      and fresh entries past n_valid are zero-filled and never read.
//   4. The fresh span (rolling only).  A block folds only its own row's
//      span entries (the plan lists them, wherever they lie), staged the
//      same way, after the old cache.
//   5. Occupancy.  Shared memory holds the bf16 values themselves, no fp32
//      copies: about 88 KB a block at hd 128, two blocks an SM.
//
// Invariants.  The fold order is fixed: cache tiles of 64 slots from
// slot 0, then (rolling) the row's fresh entries in index order in tiles
// of 64.  A tile a query row cannot see leaves its state bit for bit as it
// was (its probabilities are exactly 0 and its max does not move), so
// skipping it changes nothing; the paged and contiguous kernels of each
// mode therefore give identical bits whenever the table's width nb * bs
// equals the row width S.  No atomics, no split-K: two launches repeat
// bit for bit.  Instantiated for hd in {16, 32, 64, 128}; g = H / Kv in
// 1..16 is a runtime tiled::Group (at g 16 a tile is 4 tokens x 16 heads,
// at g 5 12 tokens x 5 heads and 4 idle rows).  The
// copy and tensor-core primitives and the tile step are in
// tiled_primitives.cuh, shared with the flash and split decode bodies; the
// plan, the row addressing and the fresh-span staging serve the int8 span
// body too (span_attention_quant_tiled.cuh, PERF.md rows 7, 8, 10, 12).
#pragma once

#include <cassert>
#include <climits>
#include <cmath>
#include <cstdint>

#include "tiled_primitives.cuh"

namespace tiled {

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kRows = 64;      // query rows of a block
constexpr int kSlots = 64;     // K/V slots (or fresh entries) of a tile
constexpr int kFull = 1 << 30;   // a tile's flag: every query row sees it all

// ---------------------------------------------------------------------------
// The plan: int32 workspace, laid out as
//   [0]                      number of tiles
//   tiles[3 * max_tiles]     (cache row, first index into order, tokens)
//   order[T]                 the span's indices grouped by row, in index
//                            order within a row
//   rank[T]                  index of token t among its row's tokens
//   row_start[rows]          first entry of each row in order
//   row_n[rows]              tokens of each row
//   tile_base[rows]          first tile of each row
// ---------------------------------------------------------------------------
__host__ __device__ inline int max_tiles(int T, int rows, int tq) {
  return (T + tq - 1) / tq + (rows < T ? rows : T);
}

__host__ __device__ inline long long plan_ints(int T, int rows, int tq) {
  return 1 + 3LL * max_tiles(T, rows, tq) + 2LL * T + 3LL * rows;
}

struct Plan {
  int* n_tiles;
  int* tiles;
  int* order;
  int* rank;
  int* row_start;
  int* row_n;
  int* tile_base;
};

__host__ __device__ inline Plan carve_plan(int* p, int T, int rows, int tq) {
  Plan s;
  s.n_tiles = p;
  s.tiles = p + 1;
  s.order = s.tiles + 3 * max_tiles(T, rows, tq);
  s.rank = s.order + T;
  s.row_start = s.rank + T;
  s.row_n = s.row_start + rows;
  s.tile_base = s.row_n + rows;
  return s;
}

// One block: rank each token among its row's tokens (warp 0, 32 tokens a
// step, __match_any_sync), prefix the rows (thread 0), then scatter the
// order and the tiles.
__global__ void __launch_bounds__(kThreads)
plan_kernel(const int* __restrict__ seq_idx, int T, int rows, int tq,
            int* plan) {
  const Plan p = carve_plan(plan, T, rows, tq);
  const int tid = threadIdx.x;
  for (int r = tid; r < rows; r += blockDim.x) p.row_n[r] = 0;
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    for (int base = 0; base < T; base += 32) {
      const int t = base + lane;
      const int r = t < T ? seq_idx[t] : -1;
      // a corrupt batch fails loudly
      assert(t >= T || (r >= 0 && r < rows));
      const unsigned peers = __match_any_sync(0xffffffffu, r);
      const int before = __popc(peers & ((1u << lane) - 1u));
      const int seen = t < T ? p.row_n[r] : 0;
      __syncwarp();
      if (t < T) {
        p.rank[t] = seen + before;
        if (before == 0) p.row_n[r] = seen + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid == 0) {
    int start = 0, tile = 0;
    for (int r = 0; r < rows; ++r) {
      const int n = p.row_n[r];
      p.row_start[r] = start;
      p.tile_base[r] = tile;
      start += n;
      tile += (n + tq - 1) / tq;
    }
    *p.n_tiles = tile;
  }
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) {
    const int r = seq_idx[t], k = p.rank[t];
    p.order[p.row_start[r] + k] = t;
    if (k % tq == 0) {
      const int j = p.tile_base[r] + k / tq;
      p.tiles[3 * j] = r;
      p.tiles[3 * j + 1] = p.row_start[r] + k;
      p.tiles[3 * j + 2] = min(tq, p.row_n[r] - k);
    }
  }
}

// ---------------------------------------------------------------------------
// Slot addresses of one cache row, for one kv head
// ---------------------------------------------------------------------------

// Slots of one block-table row of a [n_blocks, bs, Kv, hd] cache of T
// (bf16; int8 in span_attention_quant_tiled.cuh); the row's table entries
// are copied to shared memory (stab) by prepare().  vec(s): the index of
// slot s's kv-head-kh vector (an int8 cache's scale sits at that index of
// its [n_blocks, bs, Kv] scale cache); offset: its first element.
template <class T>
struct PagedRowOf {
  const T* k;
  const T* v;
  const int* table;  // this row's [nb] entries
  FastDiv bs;
  int Kv, kh, n_blocks;
  int* stab;
  // entries of the pages below n_old; a corrupt table fails loudly
  // rather than reading out of the pool
  __device__ void prepare(int n_old) const {
    for (int i = threadIdx.x; i < bs.div(n_old + bs.d - 1); i += blockDim.x) {
      const int b = table[i];
      assert(b >= 0 && b < n_blocks);
      stab[i] = b;
    }
  }
  __device__ size_t vec(int s) const {
    const int i = bs.div(s);
    return ((size_t)stab[i] * bs.d + (s - i * bs.d)) * Kv + kh;
  }
  template <int HD>
  __device__ size_t offset(int s) const {
    return vec(s) * HD;
  }
};
using PagedRow = PagedRowOf<bf16>;

// Slots of row `row` of a contiguous [R, S, Kv, hd] cache of T.
template <class T>
struct ContiguousRowOf {
  const T* k;
  const T* v;
  int row, S, Kv, kh;
  __device__ void prepare(int) const {}
  __device__ size_t vec(int s) const {
    return ((size_t)row * S + s) * Kv + kh;
  }
  template <int HD>
  __device__ size_t offset(int s) const {
    return vec(s) * HD;
  }
};
using ContiguousRow = ContiguousRowOf<bf16>;

// Does the arc of `len` slots from slot a (mod w) meet slots [s0, s1)?
__device__ __forceinline__ bool arc_hits(int a, int len, int w, int s0,
                                         int s1) {
  if (len <= 0) return false;
  if (a >= s0 && a < s1) return true;
  int d = s0 - a;
  if (d < 0) d += w;
  return d < len;
}

// Does that arc hold all of slots [s0, s1)?
__device__ __forceinline__ bool arc_covers(int a, int len, int w, int s0,
                                           int s1) {
  int d = s0 - a;
  if (d < 0) d += w;
  return d + (s1 - s0) <= len;
}

// ---------------------------------------------------------------------------
// Shared memory of one block
// ---------------------------------------------------------------------------
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;            // padded row, bf16
  static constexpr int TILE = kSlots * LD;     // one K or V stage, bf16
  static constexpr int Q_OFF = 0;              // bytes
  static constexpr int K_OFF = Q_OFF + 2 * kRows * LD;
  static constexpr int V_OFF = K_OFF + 2 * 2 * TILE;
  static constexpr int UPOS_OFF = V_OFF + 2 * 2 * TILE;  // int [2][kSlots]
  static constexpr int TOK_OFF = UPOS_OFF + 4 * 2 * kSlots;  // 4 x int [kRows]
  static constexpr int MISC_OFF = TOK_OFF + 4 * 4 * kRows;   // int [4]
  static constexpr int ITEMS_OFF = MISC_OFF + 16;            // int [...]
  static_assert(K_OFF % 16 == 0 && V_OFF % 16 == 0, "16-byte stages");
  // items: one per candidate tile; then the paged row's table
  __host__ __device__ static int items(int w_slots, int T) {
    return (w_slots + kSlots - 1) / kSlots + (T + kSlots - 1) / kSlots;
  }
  __host__ __device__ static size_t bytes(int w_slots, int T,
                                          int table_ints) {
    return ITEMS_OFF + 4 * ((size_t)items(w_slots, T) + table_ints);
  }
};

// Stages fresh entries e0 .. e0 + kSlots - 1 of a row (the span indices
// order[0 .. nfresh)) into one ring entry (dk, dv: [kSlots][LD] bf16; up:
// their positions).  Entries past nfresh or n_valid are zero-filled
// without a read.
template <int HD>
__device__ __forceinline__ void stage_fresh(
    const bf16* __restrict__ k_span, const bf16* __restrict__ v_span,
    const int* __restrict__ positions, const int* __restrict__ order, int e0,
    int nfresh, int n_valid, int Kv, int kh, bf16* dk, bf16* dv, int* up) {
  constexpr int LD = Layout<HD>::LD, CPS = HD / 8;
  static_assert(kSlots * CPS % kThreads == 0, "whole copy rounds");
#pragma unroll
  for (int i = 0; i < kSlots * CPS / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int j = c / CPS, ch = c - j * CPS;
    const int e = e0 + j;
    const int u = e < nfresh ? order[e] : -1;
    const bool ok = u >= 0 && u < n_valid;
    const size_t o = ok ? ((size_t)u * Kv + kh) * HD + ch * 8 : 0;
    cp_async16(dk + j * LD + ch * 8, k_span + o, ok);
    cp_async16(dv + j * LD + ch * 8, v_span + o, ok);
    if (ch == 0) up[j] = ok ? positions[u] : INT_MAX;
  }
}

// Stages candidate tile `item` of a block into one ring entry (dk, dv:
// [kSlots][LD] bf16; up: the fresh entries' positions): old-cache tiles
// (item < n_old_t) from src, fresh tiles from the row's span entries
// order[0 .. nfresh).  Slots at or past n_old and entries past n_valid are
// zero-filled without a read.
template <int HD, class Src>
__device__ __forceinline__ void stage(
    const Src& src, const bf16* __restrict__ k_span,
    const bf16* __restrict__ v_span, const int* __restrict__ positions,
    const int* __restrict__ order, int item, int n_old_t, int n_old,
    int nfresh, int n_valid, int Kv, int kh, bf16* dk, bf16* dv, int* up) {
  constexpr int LD = Layout<HD>::LD, CPS = HD / 8;
  static_assert(kSlots * CPS % kThreads == 0, "whole copy rounds");
  if (item < n_old_t) {
    const int s0 = item * kSlots;
#pragma unroll
    for (int i = 0; i < kSlots * CPS / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int j = c / CPS, ch = c - j * CPS;
      const int s = s0 + j;
      const bool ok = s < n_old;
      const size_t o = ok ? src.template offset<HD>(s) + ch * 8 : 0;
      cp_async16(dk + j * LD + ch * 8, src.k + o, ok);
      cp_async16(dv + j * LD + ch * 8, src.v + o, ok);
    }
  } else {
    stage_fresh<HD>(k_span, v_span, positions, order,
                    (item - n_old_t) * kSlots, nfresh, n_valid, Kv, kh, dk,
                    dv, up);
  }
}

// The block's 64 query rows (tile blockIdx.x of the plan, kv head
// blockIdx.y) over its row's cache (src) and, rolling, its fresh span
// entries.  q [T, H, hd]; k_span/v_span [T, Kv, hd] (rolling); out
// [T, H * hd].  FULL: offsets, k_span and v_span are not read; window and
// n_valid are ignored.
template <int HD, bool FULL, class Src>
__device__ __forceinline__ void attend(
    Src src, const bf16* __restrict__ q, const bf16* __restrict__ k_span,
    const bf16* __restrict__ v_span, const int* __restrict__ positions,
    const int* __restrict__ offsets, const int* __restrict__ plan,
    bf16* __restrict__ out, int T, int H, int Kv, Group grp, int rows,
    int w_slots, int window, int n_valid, float scale,
    unsigned char* smem) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int CPS = HD / 8;  // 16-byte chunks of one slot (or query row)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = grp.g, tq = grp.tq;
  const int kh = blockIdx.y;
  const Plan p = carve_plan(const_cast<int*>(plan), T, rows, tq);
  const int tile = blockIdx.x;
  if (tile >= *p.n_tiles) return;
  const int row = p.tiles[3 * tile], qfirst = p.tiles[3 * tile + 1];
  const int cnt = p.tiles[3 * tile + 2];
  const int ffirst = p.row_start[row], nfresh = FULL ? 0 : p.row_n[row];

  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V_OFF);
  int* upos = reinterpret_cast<int*>(smem + L::UPOS_OFF);
  int* tok = reinterpret_cast<int*>(smem + L::TOK_OFF);
  int* tpos = tok + kRows;
  int* tarc = tpos + kRows;   // first slot of each token's arc
  int* tlen = tarc + kRows;   // its length (0: sees no old slot)
  int* misc = reinterpret_cast<int*>(smem + L::MISC_OFF);
  int* items = reinterpret_cast<int*>(smem + L::ITEMS_OFF);

  // 1. the tile's tokens, their arcs, and the block's extent (every
  // entry of the arrays: a g that is no power of two leaves idle rows at
  // token index tq)
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
  const int n_old_t = (n_old + kSlots - 1) / kSlots;
  const int n_cand = n_old_t + (nfresh + kSlots - 1) / kSlots;

  // the query rows (zeros past the tile's tokens), in the first group
#pragma unroll
  for (int i = 0; i < kRows * CPS / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int m = c / CPS, ch = c - m * CPS;
    const int t = tok[grp.token(m)];
    const bool ok = t >= 0;
    const bf16* s = ok ? q + ((size_t)t * H + kh * g + grp.head(m)) * HD
                             + ch * 8
                       : q;
    cp_async16(sq + m * LD + ch * 8, s, ok);
  }
  src.prepare(n_old);
  for (int i = tid; i < n_cand; i += kThreads) items[i] = 0;
  __syncthreads();

  // 2. which tiles some query row sees: old tiles by the tokens' arcs
  // (kFull: every token sees every slot, no mask to apply); fresh tiles
  // (conservatively) by the block's positions and window
  for (int i = tid; i < n_old_t; i += kThreads) {
    const int s0 = i * kSlots, s1 = min(s0 + kSlots, n_old);
    bool need = false, full = s1 == s0 + kSlots;
    for (int j = 0; j < cnt; ++j) {
      need = need || arc_hits(tarc[j], tlen[j], w_slots, s0, s1);
      full = full && arc_covers(tarc[j], tlen[j], w_slots, s0, s1);
    }
    items[i] = full ? kFull : need;
  }
  for (int e = tid; e < nfresh; e += kThreads) {
    const int u = p.order[ffirst + e];
    if (u < n_valid) {
      const int up = positions[u];
      if (up <= pmax && up > pmin - window) items[n_old_t + e / kSlots] = 1;
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
  const int n_items = misc[3];

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNone, kNone}, l[2] = {0.f, 0.f};
  const float c2 = scale * kLog2e;

  const int* forder = p.order + ffirst;
  if (n_items > 0)
    stage<HD>(src, k_span, v_span, positions, forder, items[0] & (kFull - 1),
              n_old_t, n_old, nfresh, n_valid, Kv, kh, sk, sv, upos);
  cp_async_commit();  // group 0: the query rows and the first tile
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    const int item = items[it] & (kFull - 1);
    const bool full = items[it] & kFull;
    if (it + 1 < n_items)
      stage<HD>(src, k_span, v_span, positions, forder,
                items[it + 1] & (kFull - 1),
                n_old_t, n_old, nfresh, n_valid, Kv, kh,
                sk + (buf ^ 1) * L::TILE, sv + (buf ^ 1) * L::TILE,
                upos + (buf ^ 1) * kSlots);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_q<HD, LD>(qa, sq, warp, lane);
    const bool old = item < n_old_t;
    const int s0 = item * kSlots;
    const int* up = upos + buf * kSlots;
    // this thread's query row warp * 16 + lane / 4 + 8 * ri: its token's
    // arc and position, read from shared memory on every tile rather than
    // held in registers (hd 64 would spill); pos -1 past the tile's tokens
    // sees nothing
    const auto row_mask = [&](int ri) {
      const int j = grp.token(warp * 16 + (lane >> 2) + ri * 8);
      const int rpos = tpos[j], ra = tarc[j], rlen = tlen[j];
      return [=](int n) {
        if (old) {
          const int sl = s0 + n;
          if (FULL) return sl < rlen;
          // the last tile may run past w_slots (w_slots % 64 != 0)
          int d = sl - ra;
          if (d < 0) d += w_slots;
          return sl < w_slots && d < rlen;
        }
        const int u = up[n];
        return u <= rpos && u > rpos - window;
      };
    };
    fold_tile<HD, LD>(qa, sk + buf * L::TILE, sv + buf * L::TILE, full, c2,
                      row_mask, m, l, o, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // out = O / l, rounded to bf16; rows past the tile's tokens are dropped
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lsum = l[ri];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float den = fmaxf(lsum, 1e-30f);
    const int mrow = warp * 16 + (lane >> 2) + ri * 8;
    const int j = grp.token(mrow);
    if (j < cnt) {
      bf16* dst = out + ((size_t)tok[j] * H + kh * g + grp.head(mrow)) * HD
                  + 2 * (lane & 3);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
            __floats2bfloat162_rn(o[nd][2 * ri] / den,
                                  o[nd][2 * ri + 1] / den);
    }
  }
}

}  // namespace tiled
