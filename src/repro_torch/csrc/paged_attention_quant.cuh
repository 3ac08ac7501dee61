// The int8 quantization rule and warp reductions shared by the port's int8
// attention bodies: the split decode body (decode_attention_quant_split.
// cuh, PERF.md rows 2b, 2bc, 2br and 2bcr) and the tiled span body
// (span_attention_quant_tiled.cuh, rows 7, 8, 10 and 12).
//
// The int8 KV cache holds each K/V vector as int8 [hd] with one bf16
// scale; both attention contractions are exact int8 dots and the scales
// are folded in outside them, as in the reference
// (repro/models/attention.py:544-650).
//
// Quantization follows the reference's quantize_kv op for op: the scale
// is max|x| / 127 + 1e-8 in fp32 (correctly rounded division, never a
// reciprocal), values are rintf(x / scale) (round half to even, as
// jnp.round) clipped to [-127, 127], and the scale kept for the
// dequantization is that fp32 scale rounded to bf16.  exp is expf, the
// function PyTorch's exp runs on the card, so the kernels and their plain
// versions differ only in the order of the fp32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pquant {

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The reference's scale of a vector whose largest magnitude is amax.
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(amax, 127.f) + 1e-8f;
}

__device__ __forceinline__ float quant_value(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

}  // namespace pquant
