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
// So the fusion is two launches of the shared wgmma body (gemm_wgmma.cuh)
// on the caller's stream:
//   1. gate-up: both products of a 128-column ff tile from the same x
//      tiles (two weights a stage), h = bf16(silu(a) * b) to a [T, ff]
//      workspace the wrapper allocates; its first block also zeroes the
//      down product's arrival counts;
//   2. down: h @ w2 over 64-column d tiles, launched as a programmatic
//      dependent of gate-up, so its blocks load their first w2 tiles while
//      gate-up ends and wait for it only before they read h.
// h's round trip is 2 * T * ff * 2 bytes: 5.8 MB at stablelm's T = 256
// (8% of the 71 MB the call must read, and it stays in the 50 MB L2), 1.3%
// at a mixtral expert.
//
// What bounds it: the weights.  3 * d * ff bf16 values against 6 * T * d *
// ff flops is T flops per byte, below the H100's ~295 for every T the
// engine gives (decode: 4; a chunk: 256), so memory bounds it.  The body
// streams the weights by TMA into rings of 100-220 KB a block; the down
// product, whose d / 64 = 32 column tiles (stablelm) leave SMs idle, takes
// a deterministic split-K in two over ff (kernels/_gemm.py plan: tiles,
// slices and workspace are functions of the shapes).  Gate-up takes no
// split: with its own counts zeroed by a launch ahead of it, a split
// measured slower.  Token tiles (wgmma's N) are the fastest grid axis, so
// the blocks that share a weight tile run together.
#include "gemm_wgmma.cuh"

// x [T, d], w1/w3 [d, ff], w2 [ff, d], y [T, d], h a [T, ff] workspace; all
// bf16, contiguous, 16-byte aligned; d and ff multiples of 16.  ws: the
// down product's split-K workspace of ws_bytes (kernels/_gemm.py
// workspace_bytes); bn the token tile of both products, q_down the down
// product's k-steps a slice (kernels/_gemm.py swiglu_plans; gate-up takes
// 128 columns and no split, the down product 64 columns).  0 or the CUDA
// error.
extern "C" int swiglu(const void* x, const void* w1, const void* w3,
                      const void* w2, void* h, void* y, void* ws,
                      long long ws_bytes, int T, int d, int ff, int bn,
                      int q_down, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || d <= 0 || ff <= 0 || d % 16 || ff % 16)
    return (int)cudaErrorInvalidValue;
  const wg::Plan up(T, d, ff, bn, 128, (d + wg::kBK - 1) / wg::kBK);
  const wg::Plan down(T, ff, d, bn, 64, q_down);
  if (!up.valid() || !down.valid()) return (int)cudaErrorInvalidValue;
  const wg::Workspace lay(down, 0);
  if (ws_bytes < 0 || (size_t)ws_bytes < lay.bytes)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mw1, mw3, mx, mw2, mh;
  int rc;
  if ((rc = wg::tensor_map(&mw1, w1, d, ff, wg::kBK)) ||
      (rc = wg::tensor_map(&mw3, w3, d, ff, wg::kBK)) ||
      (rc = wg::tensor_map(&mx, x, T, d, bn)) ||
      (rc = wg::tensor_map(&mw2, w2, ff, d, wg::kBK)) ||
      (rc = wg::tensor_map(&mh, h, T, ff, bn)))
    return rc;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* base = (unsigned char*)ws;
  // gate-up zeroes the down product's arrival counts as it starts
  wg::Args a = wg::args(up, T, d, ff, (wg::bf16*)h, nullptr, nullptr);
  a.zero = (int*)base;
  a.n_zero = down.splits > 1 ? down.tiles : 0;
  const cudaError_t err =
      wg::launch_plan<2, false>(mw1, mw3, mx, mx, a, up, false, s);
  if (err != cudaSuccess) return (int)err;
  a = wg::args(down, T, ff, d, (wg::bf16*)y, (float*)(base + lay.part),
               (int*)base);
  return (int)wg::launch_plan<1, false>(mw2, mw2, mh, mh, a, down, true, s);
}
