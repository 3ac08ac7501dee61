// Paged packed span attention over the int8 KV cache, for the chunked
// prefill step (chunk_fn) of a kv_quant model.
//
// Replaces the TPU kernel repro/kernels/span_attention.py:656
// (paged_span_attention_quant, body _quant_kernel :183).  Token t of the
// packed span attends, for each query head, to logical slots
// 0..positions[t] of block-table row seq_idx[t].  Grid: one block per
// (token, kv head); the block reads its row and position itself (the TPU
// kernel got them by scalar prefetch).
//
// The slots are walked in tiles of `tile` slots, the p-quantization tile:
// the probabilities of one tile are quantized with one scale per head, so
// the tile width is part of the function.  The Pallas kernel used one
// page (bs); the reference engine off the TPU uses kv_block = 512 clipped
// and halved until it divides the table's nb * bs slots
// (attention.py:829); the caller chooses.  Per tile: scores into shared
// memory (exact __dp4a dots), the tile's max and the running max/sum,
// p = expf(s - m), p * vs quantized per head, the exact int8 AV dot, and
// acc = acc * corr + o32 * ps.  Tiles past positions[t] are skipped: all
// their probabilities are exactly 0, so they would add nothing.  Shared
// pieces, numerics and bound: paged_attention_quant.cuh.
#include "paged_attention_quant.cuh"

__global__ void __launch_bounds__(pquant::kThreads)
paged_span_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ k8,
    const __nv_bfloat16* __restrict__ ks, const signed char* __restrict__ v8,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ positions, const int* __restrict__ seq_idx,
    __nv_bfloat16* __restrict__ out, int H, int Kv, int hd, int bs, int B,
    int nb, int n_blocks, int tile, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, kh = blockIdx.y;
  const int g = H / Kv;
  const int row = seq_idx[t], pos = positions[t];
  assert(row >= 0 && row < B && pos >= 0);  // a corrupt batch fails loudly
  const int* table = tables + (size_t)row * nb;
  float* buf;
  const pquant::Smem s = pquant::carve(smem, g, hd, g * tile, &buf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_slots = min(pos + 1, nb * bs);
  pquant::check_table(table, n_slots, bs, n_blocks);
  pquant::load_query(q + ((size_t)t * H + kh * g) * hd, g, hd, s);
  __syncthreads();

  for (int start = 0; start < n_slots; start += tile) {
    const int live = min(tile, n_slots - start);
    pquant::score(k8, ks, table, start, live, bs, Kv, kh, g, hd, scale, s,
                  buf, tile);
    __syncthreads();
    for (int j = warp; j < g; j += pquant::kWarps) {
      float* r = buf + j * tile;
      float mx = pquant::kNegInf;
      for (int i = lane; i < live; i += 32) mx = fmaxf(mx, r[i]);
      const float m_old = s.m[j];
      const float m_new = fmaxf(m_old, pquant::warp_max(mx));
      float sum = 0.f, amax = 0.f;
      for (int i = lane; i < live; i += 32) {
        const float p = expf(r[i] - m_new);
        sum += p;
        const float pv = p * __bfloat162float(
            vs[pquant::slot_index(table, start + i, bs, Kv, kh)]);
        r[i] = pv;
        amax = fmaxf(amax, fabsf(pv));
      }
      sum = pquant::warp_sum(sum);
      amax = pquant::warp_max(amax);
      __syncwarp();
      pquant::quantize_row(r, live, amax, s.ps + j);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s.c[j] = corr;
        s.l[j] = s.l[j] * corr + sum;
        s.m[j] = m_new;
      }
    }
    __syncthreads();
    pquant::av(v8, table, start, live, bs, Kv, kh, g, hd, buf, tile, s, true);
    __syncthreads();
  }
  __nv_bfloat16* o = out + ((size_t)t * H + kh * g) * hd;
  for (int i = threadIdx.x; i < g * hd; i += pquant::kThreads)
    o[i] = __float2bfloat16(s.acc[i] / fmaxf(s.l[i / hd], 1e-30f));
}

// q [T, H, hd] bf16; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs
// [n_blocks, bs, Kv] bf16; tables [B, nb], positions/seq_idx [T] int32;
// out [T, H*hd] bf16.  hd must be a multiple of 16.
extern "C" int paged_span_attention_quant(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* tables, const void* positions,
    const void* seq_idx, void* out, int T, int H, int Kv, int hd, int bs,
    int B, int nb, int n_blocks, int tile, float scale, void* stream) {
  if (T == 0) return 0;
  if (hd % 16 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pquant::smem_bytes(H / Kv, hd, (H / Kv) * tile);
  cudaError_t err = pquant::prepare_smem(paged_span_attention_quant_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_span_attention_quant_kernel<<<dim3(T, Kv), pquant::kThreads, smem,
                                      (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const signed char*)k8,
      (const __nv_bfloat16*)ks, (const signed char*)v8,
      (const __nv_bfloat16*)vs, (const int*)tables, (const int*)positions,
      (const int*)seq_idx, (__nv_bfloat16*)out, H, Kv, hd, bs, B, nb,
      n_blocks, tile, scale);
  return (int)cudaGetLastError();
}
