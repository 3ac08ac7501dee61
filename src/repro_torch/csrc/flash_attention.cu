// Prefill attention: causal (optionally windowed) for the monolithic
// prefill step (prefill_fn), or non-causal (every key of the batch row:
// the whisper encoder's self-attention and the decoder's cross-attention
// to the encoder output).  PERF.md rows 3 (causal), 3w (window band) and
// 3n (non-causal).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:80
// (flash_attention, body _kernel) together with its layout adapter
// repro/kernels/ops.py:27 (flash_attention_bshd): it reads q [B, Sq, H, hd]
// and k/v [B, Skv, Kv, hd] in the model's layout and writes
// out [B, Sq, H*hd], so nothing is transposed around it.  GQA maps query
// head h to kv head h / g (g = H / Kv), as the Pallas BlockSpec index map
// did.  The TPU kernel walked the kv tiles as the sequential minor grid
// axis with the running softmax in VMEM scratch; here one block loops over
// its kv tiles itself.
//
// What bounds it: the least work is 4 * hd flops per visible (query, key)
// pair and head against 2 * (2H Sq + 2Kv Skv) * hd bytes of q, k, v and
// the output per batch row; the H100 does ~295 bf16 tensor-core flops per
// byte.  So:
//   - row 3n at whisper's encoder (B 4, Sq = Skv = 1500, H = Kv = 12, hd
//     64; every pair visible) is bound by its operations (0.028 ms), and
//     the cross-attention (Sq 4 over 1500 keys) by reading the keys;
//   - row 3 at the engine's prompts (S 397, H = Kv = 32, hd 64; causal) is
//     bound by its bytes (0.0078 ms): each kv tile must be read from
//     device memory about once, not once per query head and query tile;
//   - row 3w at mixtral's prefill (S 4500, W 4096, H 32, Kv 8, hd 128) is
//     bound by its operations (0.33 ms).
// What the design does about each:
//
//   1. Query tiles on the tensor cores.  One block (4 warps, one per 16
//      query rows, as FlashAttention-2) computes 64 query rows of one kv
//      head and batch row: 64 / g positions x the g query heads that share
//      the kv head (row m of the tile is position m / g, head m % g), so
//      every K/V tile it stages serves all g heads and is read once per 64
//      query rows.  S = Q K^T and O += P V are mma.sync.m16n8k16 bf16
//      products with fp32 accumulators; Q stays in registers, loaded once
//      with ldmatrix.  The online softmax is fp32 per row, with exp2 of
//      scores pre-scaled by log2 e (tiled::fold_tile, shared with the span
//      body).
//   2. P as bf16 hi + lo = bf16(p - hi), both multiplied into one
//      accumulator: the Pallas kernel keeps P in fp32, and one bf16 P
//      misses the kernels' limit (2^-7 |plain| + 1e-5) at mixtral's widths
//      (tests/test_torch_flash_tiles.py).  It costs half again as many
//      tensor-core products (P V twice beside Q K^T once), not more bytes.
//   3. Asynchronous staging.  K/V tiles of 64 keys are staged in bf16 (no
//      fp32 copies) through a 2-deep ring of 16-byte cp.async copies, rows
//      padded by 16 bytes so ldmatrix(.trans) reads without bank conflicts;
//      keys past Skv are zero-filled without a read.  About 87 KB a block
//      at hd 128: two blocks an SM.
//   4. Masks only where needed.  Causal: the block visits only the kv tiles
//      inside [min_q - W + 1, max_q] of its positions (the Pallas kernel's
//      pl.when), and masks only the tiles that cross some row's diagonal
//      or window edge (or the ragged end of the keys).  Non-causal: every
//      tile of the row, q_pos not read, only the tail tile masked.  Ragged
//      edges: Sq and Skv need not be multiples of 64 or equal (prompts
//      right-padded to the longest, 1500 frames, a few cross queries); rows
//      past Sq are computed from zeros and never stored.
//   5. Determinism: kv tiles are folded from low to high, no atomics and no
//      split-K, so two launches repeat bit for bit.
//
//   6. hd 256 (recurrentgemma-9b's local attention, row 3w): the same
//      body with its query rows kept in shared memory and their fragments
//      re-read at every k-step (tiled::QShared; held, Q's 64 words a thread
//      beside O's 128 would spill), ~165 KB of shared memory: one block an
//      SM.
//
// Full-rate Hopper products (wgmma fed by TMA, warp specialisation) are
// the step beyond this body.  Instantiated for hd in {16, 32, 64, 128,
// 256};
// g = H / Kv in 1..16 is a runtime tiled::Group (at g 5 a block is 12
// positions x 5 heads, and its 4 other rows are idle).
#include <climits>

#include "tiled_primitives.cuh"

namespace {

using tiled::bf16;

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kRows = 64;      // query rows of a block
constexpr int kKeys = 64;      // keys of a kv tile

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;              // padded row, bf16
  static constexpr int TILE = kKeys * LD;        // one K or V stage, bf16
  static constexpr int Q_OFF = 0;                // bytes
  static constexpr int K_OFF = Q_OFF + 2 * kRows * LD;
  static constexpr int V_OFF = K_OFF + 2 * 2 * TILE;
  static constexpr int POS_OFF = V_OFF + 2 * 2 * TILE;  // int [kRows]
  static constexpr int MISC_OFF = POS_OFF + 4 * kRows;  // int [2]
  static constexpr int BYTES = MISC_OFF + 16;
  static_assert(K_OFF % 16 == 0 && V_OFF % 16 == 0, "16-byte stages");
};

// Stages kv tile `t` of batch row b, kv head kh into (dk, dv); keys past
// Skv are zero-filled without a read.
template <int HD>
__device__ __forceinline__ void stage(const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, int t,
                                      int b, int kh, int Skv, int Kv,
                                      bf16* dk, bf16* dv) {
  constexpr int LD = Layout<HD>::LD, CPS = HD / 8;
  static_assert(kKeys * CPS % kThreads == 0, "whole copy rounds");
#pragma unroll
  for (int i = 0; i < kKeys * CPS / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int j = c / CPS, ch = c - j * CPS;
    const int s = t * kKeys + j;
    const bool ok = s < Skv;
    const size_t o = ok ? (((size_t)b * Skv + s) * Kv + kh) * HD + ch * 8 : 0;
    tiled::cp_async16(dk + j * LD + ch * 8, k + o, ok);
    tiled::cp_async16(dv + j * LD + ch * 8, v + o, ok);
  }
}

// One block: query tile blockIdx.x (64 / g positions), kv head
// blockIdx.y, batch row blockIdx.z.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const int* __restrict__ q_pos, bf16* __restrict__ out,
                       int Sq, int Skv, int H, int Kv, tiled::Group grp,
                       int causal, int window, float scale) {
  using L = Layout<HD>;
  constexpr int LD = L::LD, CPS = HD / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* sq = reinterpret_cast<bf16*>(flash_smem + L::Q_OFF);
  bf16* sk = reinterpret_cast<bf16*>(flash_smem + L::K_OFF);
  bf16* sv = reinterpret_cast<bf16*>(flash_smem + L::V_OFF);
  int* tpos = reinterpret_cast<int*>(flash_smem + L::POS_OFF);
  int* misc = reinterpret_cast<int*>(flash_smem + L::MISC_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = grp.g, np = grp.tq;         // positions of a block
  const int p0 = blockIdx.x * np, kh = blockIdx.y, b = blockIdx.z;
  const int cnt = min(np, Sq - p0);         // positions inside Sq

  // the block's positions (causal) and their extent; -1 past Sq and at
  // the idle rows' index np (a g that is no power of two)
  if (warp == 0) {
    int pmin = INT_MAX, pmax = INT_MIN;
    for (int j = lane; j < kRows; j += 32) {
      int pos = -1;
      if (j < cnt) {
        pos = causal ? q_pos[p0 + j] : 0;
        pmin = min(pmin, pos);
        pmax = max(pmax, pos);
      }
      tpos[j] = pos;
    }
    for (int o = 16; o > 0; o >>= 1) {
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, o));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    }
    if (lane == 0) {
      misc[0] = pmin;
      misc[1] = pmax;
    }
  }
  // the query rows (zeros past Sq), in the first copy group
#pragma unroll
  for (int i = 0; i < kRows * CPS / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int m = c / CPS, ch = c - m * CPS;
    const int j = grp.token(m);
    const bool ok = j < cnt;
    const bf16* s =
        ok ? q + (((size_t)b * Sq + p0 + j) * H + kh * g + grp.head(m)) *
                         HD +
                     ch * 8
           : q;
    tiled::cp_async16(sq + m * LD + ch * 8, s, ok);
  }
  __syncthreads();
  const int pmin = misc[0], pmax = misc[1];
  // the kv tiles some row can see: [lo, hi) of the keys
  int lo = 0, hi = Skv;
  if (causal) {
    hi = min(Skv, pmax + 1);
    if (window) lo = max(0, pmin - window + 1);
  }
  const int t_lo = lo / kKeys;
  const int n_items = hi > lo ? (hi + kKeys - 1) / kKeys - t_lo : 0;

  // hd 256 re-reads its Q fragments from shared memory at every k-step
  // (tiled::QShared): held, they would spill beside the accumulator
  constexpr bool kQShared = HD > 128;
  uint32_t qa[kQShared ? 1 : HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {tiled::kNone, tiled::kNone}, l[2] = {0.f, 0.f};
  const float c2 = scale * tiled::kLog2e;

  if (n_items > 0) stage<HD>(k, v, t_lo, b, kh, Skv, Kv, sk, sv);
  tiled::cp_async_commit();  // group 0: the query rows and the first tile
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    const int s0 = (t_lo + it) * kKeys;
    if (it + 1 < n_items)
      stage<HD>(k, v, t_lo + it + 1, b, kh, Skv, Kv,
                sk + (buf ^ 1) * L::TILE, sv + (buf ^ 1) * L::TILE);
    tiled::cp_async_commit();
    tiled::cp_async_wait<1>();
    __syncthreads();
    if constexpr (!kQShared)
      if (it == 0) tiled::load_q<HD, LD>(qa, sq, warp, lane);
    // every row sees every key of the tile: no mask (block-uniform)
    bool full = s0 + kKeys <= Skv;
    if (causal)
      full = full && s0 + kKeys - 1 <= pmin &&
             (!window || s0 > pmax - window);
    // this thread's row warp * 16 + lane / 4 + 8 * ri: its position, read
    // from shared memory on every tile rather than held in registers
    const auto row_mask = [&](int ri) {
      const int rpos = tpos[grp.token(warp * 16 + (lane >> 2) + ri * 8)];
      return [=](int n) {
        const int kp = s0 + n;
        return kp < Skv &&
               (!causal || (kp <= rpos && (!window || kp > rpos - window)));
      };
    };
    if constexpr (kQShared)
      tiled::fold_tile_q<HD, LD>(tiled::QShared<LD>{sq + warp * 16 * LD, lane},
                                 sk + buf * L::TILE, sv + buf * L::TILE, full,
                                 c2, row_mask, m, l, o, lane);
    else
      tiled::fold_tile<HD, LD>(qa, sk + buf * L::TILE, sv + buf * L::TILE,
                               full, c2, row_mask, m, l, o, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tiled::cp_async_wait<0>();

  // out = O / l, rounded to bf16; rows past Sq are dropped
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lsum = l[ri];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float den = fmaxf(lsum, 1e-30f);
    const int mrow = warp * 16 + (lane >> 2) + ri * 8;
    const int j = grp.token(mrow);
    if (j < cnt) {
      bf16* dst = out +
                  (((size_t)b * Sq + p0 + j) * H + kh * g + grp.head(mrow)) *
                      HD +
                  2 * (lane & 3);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
            __floats2bfloat162_rn(o[nd][2 * ri] / den,
                                  o[nd][2 * ri + 1] / den);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, void* out, int B, int Sq, int Skv,
                   int H, int Kv, tiled::Group grp, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::BYTES;
  auto kernel = flash_attention_kernel<HD>;
  cudaError_t err = tiled::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + grp.tq - 1) / grp.tq, Kv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)q_pos,
      (bf16*)out, Sq, Skv, H, Kv, grp, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, hd], k/v [B, Skv, Kv, hd] bf16, 16-byte aligned; q_pos [Sq]
// int32 (read only when causal; may be null otherwise); out [B, Sq, H*hd]
// bf16.  hd must be 16, 32, 64, 128 or 256 and H / Kv in 1..16; a window
// needs the causal form.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, void* out, int B, int Sq,
                               int Skv, int H, int Kv, int hd, int causal,
                               int window, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (!causal && window) return (int)cudaErrorInvalidValue;
  const tiled::Group grp = tiled::Group::of(H, Kv);
  if (!grp.g || Skv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, grp, causal, window, scale, s);
    case 32: return (int)launch<32>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, grp, causal, window, scale, s);
    case 64: return (int)launch<64>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, grp, causal, window, scale, s);
    case 128: return (int)launch<128>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, grp, causal, window, scale, s);
    case 256: return (int)launch<256>(q, k, v, q_pos, out, B, Sq, Skv, H, Kv, grp, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
