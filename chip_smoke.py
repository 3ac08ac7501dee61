#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py [--phases kernels,rolling,engine,serving,mixtral,configs,contiguous,reference,whisper,families,fused]

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports the port (``src/repro_torch``) and nothing of the JAX package.
Phases, each printing its own lines; any failure raises (exit code != 0):

1. build  — compiles every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the seconds.
2. kernels — runs each of the five full-cache kernels at the main path's
   shapes (stablelm-1.6b: H = Kv = 32, hd = 64, 16-slot pages; prefill
   of 4 right-padded prompts, S = 397) and at one GQA shape (g = 4, with
   decode contexts as short as one slot), holds it against its plain
   PyTorch version run in fp32 on the same inputs (|error| <=
   KERNEL_REL * |plain| + KERNEL_ABS, ``kernels/_paged.py``; a second
   launch must repeat the
   first bit for bit), and times kernel, plain version (bf16, as the
   port runs it) and, where one exists, one PyTorch call computing the
   same function (``scaled_dot_product_attention``; a yardstick the port
   never calls) beside the kernel's bound.  The int8 span kernel runs at
   both p-quantization tiles: one page (the Pallas kernel's) and the
   engine's (the reference engine's kv_block = 512).  The tensor-core
   kernels (the bf16 decode kernels, rows 2, 2c, 2r, 2cr; the int8 decode
   kernels, rows 2b, 2bc, 2br, 2bcr; the bf16 span kernels, rows 1, 9, 6,
   11; the int8 span kernels, rows 7, 10, 8, 12; the flash kernel, rows 3,
   3w, 3n; here and in 3, 6 and 8) are timed on
   the device alone (``_device_ms``, beside SDPA's device time where one
   call computes the function, and the back-to-back ``call_ms``).  The flash
   kernel's extra held cases (``SEED + 12``): causal at S = 64 and 65 (one
   tile, one tile and a row), and glm4-9b's widths (H 32, Kv 2, hd 128: g
   16) at S 397.  Then rows 1, 7, 2, 2b and 3 again at llama4-maverick's
   widths (H 40, Kv 8, hd 128: g 5, no power of two; a tiled block holds
   12 tokens x 5 heads and 4 idle rows), held and timed beside SDPA with
   ``enable_gqa`` and their bounds as the kernels line's ``<name>_g5``
   entries (rows 6 and 8 likewise in 3, rows 9-12 in 6).  The int8
   decode kernels (here and in 3 and
   6) are held to the limit plus ``kernels/_paged.py``'s flip term (one
   quantized-probability step at each slot on a rounding boundary), on
   their cases and on QUANT_DRAWS extra draws of their own; where the
   limit without the term is exceeded, the slots whose quantized
   probability differs are printed.
3. rolling — the sliding-window kernels at mixtral-8x7b's widths (H 32,
   Kv 8, hd 128): rolling span attention in bf16 and int8 (a 256-token
   chunk over rows on both sides of W = 4096), the rolling modes of both
   decode kernels (contexts 100-9000) and flash attention's window band
   (S = 4500), then each again at W = 64, where every row has wrapped
   many times (the span with bucket padding), checked and timed as in 2;
   the span kernels (bf16 and int8) also on a mixed step (1-token decode
   rows beside chunks, bucket padding) and on that step with its rows
   interleaved in seq_idx.
4. engine — serves full-width stablelm-1.6b (random weights from SEED)
   through the port's SiPipeEngine (pp = 2, paged KV), each path with
   every launch counter set to 0 just before it and read just after:
   the chunked policy (256-token chunks; greedy tokens of a 2-request
   run must equal NaivePPEngine's, then 8 requests of 64-512 prompt
   tokens and 32 sampled tokens each must all finish); the default
   policy (monolithic prefill, no chunk budget); and the int8 KV cache
   under the chunked policy and under monolithic prefill.  The last
   three serve the same 8 prompts greedily to 32 tokens, and SiPipe's
   streams must equal NaivePPEngine's (int8 monolithic: printed beside
   int8 chunked, which differs from it by design).
5. mixtral — mixtral-8x7b at its published widths, cut to 16 of its 32
   layers (32 are ~93 GB of bf16 weights, over one card's 80 GB),
   through SiPipeEngine (pp = 2, paged rolling KV, max_seq_len 5120):
   8 greedy requests of 32 tokens, six of 64-512 prompt tokens and two
   of 4200-4800, longer than the window, under the chunked policy and
   monolithic prefill, in bf16 and with the int8 cache; on each path
   every request must finish, its kernels must have launched, and a
   2-request run (one prompt over W, one request per microbatch) must
   give SiPipe's greedy streams equal to NaivePPEngine's.
5b. configs — right after the mixtral phase: the other architectures the
   engine serves, each built on the card from SEED and freed before the
   next (the allocated GiB printed before each build):
   llama4-maverick-400b-a17b at its published widths (128 experts top-1
   with a shared expert, every other layer; H 40 over Kv 8: g 5) cut to
   4 of its 48 layers (``repro_torch.configs.llama4_maverick_400b_a17b.
   ONE_CARD_LAYERS``: 4 are ~70 GB of bf16 weights), then glm4-9b (40
   layers, H 32 over Kv 2: g 16), codeqwen1.5-7b (32 layers) and
   minicpm-2b (40 layers, vocab 122753) at full depth.  Each path serves 8
   greedy requests of 64-512 prompt tokens and 32 new through
   SiPipeEngine (pp = 2, paged KV): every request must finish, the path's
   kernels must launch, every stage must replay its decode graphs and
   every KV block must be free at the end; then a 2-request pair, one
   request per microbatch, where SiPipe's schedule and greedy streams
   must equal NaivePPEngine's.  glm4-9b and llama4 run chunked (256-token
   chunks) and monolithic, in bf16 and with the int8 cache; codeqwen
   chunked and minicpm monolithic in bf16; llama4 also monolithic with
   its shared expert fused into the MoE sum (``fuse_shared_expert``),
   whose pair streams must equal the separate branch's.  llama4's
   launches are those of the g 5 entries below.
6. contiguous — the contiguous KV layout (one cache row per sequence):
   first its kernels, over [R, S, Kv, hd] rows read out of order, checked
   and timed as in 2 and 3 (rows 9-12 of PERF.md's kernel table and the
   contiguous modes of both decode kernels, at stablelm's shapes over
   rows of S = 640 and at mixtral's over rolling rows of W = 4096 and
   64), the split decode bodies' extra cases, bf16 and int8 (``SEED +
   11``, ``SEED + 14``: glm4-9b's widths, g 16; contexts of 1 slot and on
   either side of one and two 512-slot splits, rows == pages bit for bit)
   and the full-cache span bodies' (rows 1 and 9, and rows 7 and 10 at
   p-tiles 16 and 512, ``SEED + 13``: the chunk with its rows interleaved
   round robin in seq_idx; glm4-9b's widths, g 16), each over pages and
   over rows of one logical cache, where the two kernels must give the
   same bits, as must rows 11 and 6 and rows 12 and 8 on the rolling
   phase's main and mixed steps; then, right after the engine phase
   and with its weights and prompts, stablelm-1.6b over contiguous rows
   on its four paths, and, right after the mixtral phase, mixtral-8x7b
   over rolling rows of W slots, chunked and monolithic in bf16 and
   chunked in int8. On each path every request must finish, SiPipe's
   greedy schedules and streams must equal NaivePPEngine's, the
   contiguous kernels must launch and no paged kernel may; the bf16
   greedy streams must equal the paged paths' from the same run (the
   kernels share their bodies), and the int8 ones are printed beside them
   with the largest logit difference (the int8 span's p-tile is S's over
   rows and the table's when paged, so there the two layouts compute
   different functions).
7. reference — smoke-size models' logits on the card must agree with the
   same models on the CPU: chunk steps then a decode step, and a prefill
   then a decode step, with a bf16 and with an int8 cache, for
   stablelm-1.6b-smoke and for mixtral-8x7b-smoke (its W = 32 rolling
   cache wrapped).
8. whisper — whisper-small (audio encoder-decoder: 12 + 12 layers, d 768,
   H = Kv = 12, hd 64, vocab 51865) through the port's model API
   (``build_model(cfg).prefill`` / ``.decode``; the engine does not serve
   this family).  First the non-causal form of the flash kernel at its
   shapes (the encoder, B 4, Sq = Skv = 1500; the cross prefill, Sq 4;
   then GQA at hd 128 over 1000 keys), checked and timed as in 2 beside
   SDPA without a mask.  Then, with the decoder's cross-attention gates
   set to 1.0 (their init, zeros, would hide the encoder): 4 rows of 1500
   frames and a 4-token prompt, prefill and 32 greedy decode steps over a
   36-slot cache; every logit must be finite, each row must have its 32
   tokens, the causal and non-causal flash kernels and the contiguous
   decode kernel must have launched, a second run must give the same
   tokens and logits, and other frames must move the prefill logits.
   Last, whisper-small-smoke (1500 frames, hd 16) on the card
   against the CPU, as in 7.
8b. families — right after the whisper phase: the hybrid, ssm and vlm
   families through the model API (the engines do not serve them).
   First rows 3w and 2cr at recurrentgemma-9b's widths (H 16 over Kv 1:
   g 16, hd 256, W 2048), where the flash and bf16 decode bodies keep Q
   in shared memory: the flash kernel's window band over a 2300-token
   prompt, at S 65 and at W 64, its non-causal form at hd 256, and the
   contiguous rolling decode kernel over contexts 64-2300 and at W 64,
   held and timed beside their bounds and SDPA with ``enable_gqa`` (the
   kernels line's ``<name>_hd256`` entries); the four bf16 decode modes at
   hd 256 on the split edges (rows == pages bit for bit); the ptxas lines
   of the hd-256 kernels.  Rows 3, 3n and 2c at llama-3.2-vision-90b's
   widths (H 64 over Kv 8: g 8, hd 128): the causal flash kernel over a
   1024-token prompt, the non-causal form over the 6400 patches' keys,
   the contiguous decode kernel over cross rows of 6400 slots (the
   kernels line's ``<name>_g8`` entries), and its cross and self decode
   paged and as rows.  Then recurrentgemma-9b (38 layers),
   xlstm-1.3b (48) and llama-3.2-vision-90b (``repro_torch.configs.
   llama_3_2_vision_90b.ONE_CARD_LAYERS`` = 25 of its 100 layers: 100 are
   ~175 GB of bf16 weights) at their published widths, each built from
   SEED on the card and freed before the next (the vlm's cross-attention
   gates set to 1.0): 4 prompts (64-2300 tokens; recurrentgemma's longest
   crosses W) prefilled one by one, then 32 greedy decode steps of the
   4 rows as one batch (``Model.init_cache(fill=[...])``), with every
   launch counter set to 0 just before and read just after.  Every logit
   must be finite, the path's kernels must launch (recurrentgemma: rows 3w
   and 2cr at hd 256; the vlm: rows 3, 3n and 2c), a second run must give
   the same tokens and logits, and for the vlm other patches must move the
   prefill logits.  Last, each ``-smoke`` twin on the card against the
   CPU, as in 7.
9. fused — the reference's fused-op entry point (``kernels/ops.py``):
   first its two kernels on the wgmma body, swiglu and rmsnorm_matmul,
   at the full widths of the products they fuse (stablelm-1.6b's MLP at
   T 256 and 4, one mixtral-8x7b expert at C 80; the norm and w1 of
   stablelm's MLP entry, both models' LM heads at T 4), at three ragged
   shapes and at the body's edges (T 1, 16, 17, 64, 257: every token
   tile, split-K slices with a short last one),
   each held against its plain version run on the same bf16 values with
   its own casts (|error| <= 2^-7 * |plain| + 2^-12 * (|lhs| @ |rhs|) +
   1e-5, ``kernels/_gemm.py``; a second launch must repeat the first bit
   for bit) and timed beside its bound and a cuBLAS composition (a
   yardstick; no one PyTorch call computes either function); then the
   path: full-width stablelm-1.6b (random weights from SEED), layer 0's
   ``x + ops.swiglu_fused(rmsnorm(x, ln), ...)`` against the model's
   unfused ``mlp_block`` and ``ops.rmsnorm_matmul_fused(x, lnf, head)``
   against ``lm_head``, at a decode batch [4, d] and a [1, 256, d] chunk,
   within tests/test_kernels.py's oracle tolerance (the model rounds the
   two gate products to bf16; the kernel keeps them in fp32); both kernels
   must have launched there.
10. serving — right after the engine phase (and its contiguous paths),
   with its weights and prompts: the serving front end through the
   launcher's entry points (``repro_torch.launch.serve``).  The HTTP
   smoke (``start_smoke_server`` and ``_http_smoke``: SSE chunks and
   [DONE], an offline /v1/batches job that completes while the one
   active slot is held, 429 with Retry-After once the queue is full,
   /metrics as Prometheus text) against two SiPipeEngine replicas behind
   the least-loaded-KV router, monolithic prefill, each warmed by one
   short request; a non-streamed greedy completion of one prompt, sent
   alone, must equal ``SiPipeEngine.run()`` on that prompt alone; then
   an online replay (``run_online``: 16 Poisson arrivals at 8
   requests/s, 32 sampled tokens, every 5th aborted after its first
   token, 4 offline requests, 256-token chunks) under a 120 s deadline,
   whose accounting must hold.  The launch counters are read over two
   windows: the HTTP server's traffic, where the decode and flash
   kernels (rows 2, 3) must launch, and the online replay, where the
   span and decode kernels (rows 1, 2) must; warm-ups and the engine run
   the greedy check compares with are counted in neither.  Every stage
   of both replicas must replay a decode graph, and both replicas must
   drain to an empty ``load()``.  It prints TTFT, TPOT and queue delay
   (mean, p99), the offline tier's figures and the 429 count.

Every engine path (4, 5, 5b, 6) runs its decode steps as CUDA graphs, the
engine's default on the card (``core/step_graphs.py``): each stage must
hold exactly one graph per decode shape (batch, table width) the path
scheduled and must have replayed it; each path prints its graphs per
stage, replays and capture ms.  Four paths also run an eager twin
(``EngineConfig(cuda_graphs=False)``) on the same greedy requests:
stablelm's paged monolithic (row 2) and int8 monolithic over rows (row
2bc), and the 2-request runs of mixtral's paged int8 monolithic (row
2br) and bf16 monolithic over rows (row 2cr); the twin's token streams,
kernel launch counts and logits must equal the graph run's (a replay
repeats the eager step bit for bit); the peak memory, TTFT and TPOT of
both are printed.

Then it prints the card's name and power limit, one JSON line describing
each kernel, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with code 2 and prints no result.  Each phase prints its
seconds.  ``--phases`` runs a subset (engine, configs, whisper and
families need kernels, serving needs kernels and engine, mixtral needs rolling,
contiguous needs both, fused needs none;
its engine runs follow the engine and mixtral phases when they run) and
prints no result line.

The int8 monolithic and chunked streams are compared, not required to
be equal: monolithic prefill attends full-precision K/V and chunks the
int8 cache.  The reference pins their agreement on its own smoke weights
and prompts; the port holds that pin on the CPU with those weights
(tests/test_torch_engine.py::test_chunked_int8_kv_token_identical_to_
monolithic), which this script cannot load.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# the attention kernels' limit against their plain versions in fp32 on the
# same values is the port's (KERNEL_REL, KERNEL_ABS in kernels/_paged.py,
# shared with the tests): one bf16 step of the output plus fp32
# summation-order noise
LOGIT_TOL = 0.1        # smoke model logits, card vs CPU (bf16 matmuls)
SLEEP_CYCLES = 50_000_000  # ~25-30 ms of device sleep ahead of timed calls
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
BF16_FLOP_S = 989e12   # H100 SXM dense bf16 tensor-core rate
INT8_OP_S = 1979e12    # H100 SXM dense int8 tensor-core rate


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _paged_case(gen, positions, rows, n_rows, h, kv, hd, bs, dev):
    """bf16 q [N, H, hd]; shuffled physical caches whose unused blocks and
    trash block hold random values; int32 tables [n_rows, nb]."""
    import torch
    n = len(positions)
    ctx = np.zeros(n_rows, np.int64)
    for r, p in zip(rows, positions):
        ctx[r] = max(ctx[r], p + 1)
    nb = int(-(-ctx.max() // bs))
    n_phys = n_rows * nb + 1                       # + the trash block
    perm = gen.permutation(n_phys - 1)
    tables = np.full((n_rows, nb), n_phys - 1, np.int32)
    used = 0
    for r in range(n_rows):
        k = int(-(-ctx[r] // bs))
        tables[r, :k] = perm[used:used + k]
        used += k

    def rand(*shape):
        return torch.tensor(gen.standard_normal(shape, np.float32),
                            device=dev).to(torch.bfloat16)

    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return dict(q=rand(n, h, hd), k=rand(n_phys, bs, kv, hd),
                v=rand(n_phys, bs, kv, hd), tables=t(tables),
                positions=t(positions), rows=t(rows), ctx=ctx)


def _bound(case, h, hd, quant=False):
    """Least time for the function: each row's K/V prefix read once (int8
    values and bf16 scales for the int8 cache), q and the output once
    (bytes); 4*H*hd operations per visible slot, at the bf16 or int8
    tensor-core rate."""
    kv, n = case["k"].shape[2], case["q"].shape[0]
    per_slot = (hd + 2) * 2 if quant else hd * 2 * 2
    kv_bytes = int(case["ctx"].sum()) * kv * per_slot
    io_bytes = 2 * n * h * hd * 2 + 4 * (_table_ints(case) + 2 * n)
    ops = 4 * h * hd * int((case["positions"].long() + 1).sum())
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_S
    t_ops = ops / (INT8_OP_S if quant else BF16_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _flash_bound(b, sq, skv, h, kv, hd, pairs, causal=True):
    """Least time for prefill attention: q and k, v read once, the output
    written once, and (causal) the query positions read (bytes); 4*hd
    flops per visible (query, key) pair and head, ``pairs`` of them per
    batch row and head, at the bf16 tensor-core rate."""
    n_bytes = 2 * b * (2 * h * sq + 2 * kv * skv) * hd + (4 * sq if causal
                                                          else 0)
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = 4 * hd * h * b * pairs / BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sdpa_args(case, h, hd, decode: bool, views=None):
    """Padded [B, H, C, hd] queries, the gathered [B, Kv, S, hd] view (or
    ``views``, each batch row's [B, S, Kv, hd] K and V) and a boolean mask,
    for the library yardstick."""
    import torch
    from repro_torch.models.attention import gather_paged_cache
    if views is None:
        views = [gather_paged_cache(case[n], case["tables"]) for n in "kv"]
    k, v = (x.transpose(1, 2) for x in views)
    b, s = k.shape[0], k.shape[2]
    rows = case.get("batch_rows", case["rows"]).long().cpu().numpy()
    pos = case["positions"].long()
    counts = np.bincount(rows, minlength=b)
    c = 1 if decode else int(counts.max())
    slot = np.zeros(len(rows), np.int64)
    seen = np.zeros(b, np.int64)
    for i, r in enumerate(rows):
        slot[i], seen[r] = seen[r], seen[r] + 1
    rows_t = torch.tensor(rows, device=k.device)
    slot_t = torch.tensor(slot, device=k.device)
    q = torch.zeros((b, c, h, hd), dtype=k.dtype, device=k.device)
    q[rows_t, slot_t] = case["q"]
    mask = torch.zeros((b, c, s), dtype=torch.bool, device=k.device)
    mask[rows_t, slot_t] = torch.arange(s, device=k.device)[None] <= pos[:, None]
    return q.transpose(1, 2), k, v, mask[:, None]


def _held(name, kernel, plain, args, label, **kw):
    """One launch of ``kernel`` (not counted) held against ``plain`` run
    in fp32 on the same values, and a second that must repeat it bit for
    bit; returns the max |error|."""
    import torch
    from repro_torch.kernels._paged import KERNEL_ABS, KERNEL_REL
    launches = kernel.launches
    out = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    kernel.launches = launches
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {label}: two launches on the same "
                             f"inputs differ")
    ref = plain(*[a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args], **kw)
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    excess = float((diff - KERNEL_REL * ref.abs()).max())
    finite = bool(torch.isfinite(out.float()).all())
    print(f"kernel {name} {label}: max_abs_err={err:.3e} "
          f"max(|err| - {KERNEL_REL:.2e}*|plain|)={excess:.3e} "
          f"(tol {KERNEL_ABS:.0e}) finite={finite}", flush=True)
    if not finite or not excess <= KERNEL_ABS:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _held_quant_decode(name, kernel, plain, args, label, window=0):
    """:func:`_held` for the int8 decode modes (rows 2b, 2bc, 2br, 2bcr):
    their limit adds ``kernels/_paged.py``'s flip term (one quantized
    probability step at each slot whose plain x = p * vs / scale lies within
    its delta of a rounding half-integer).  Where the limit without the term
    is exceeded, prints the element, the slots whose quantized probability
    differs between the kernel (read back from its workspace, which holds
    them after the call: ``kernels/_paged.py`` quant_decode_p8) and the
    plain version, and the plain x there.  args: q, k8, ks, v8, vs, tables
    or rows, positions."""
    import torch
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels._paged import (KERNEL_ABS, KERNEL_REL,
                                            quant_decode_p8,
                                            quant_decode_workspace,
                                            quant_decode_x, quant_flip_term)
    from repro_torch.models.attention import gather_paged_cache
    q, k8, ks, v8, vs, index, positions = args
    paged = index.dim() == 2
    b, h, hd = q.shape
    kv = k8.shape[2]
    width = index.shape[1] * k8.shape[1] if paged else k8.shape[1]
    w_slots = min(width, window) if window else width
    call = kda._decode_quant if paged else kda._rows_decode_quant
    ws = torch.empty(quant_decode_workspace(b, h, kv, hd, w_slots),
                     dtype=torch.float32, device=q.device)
    launches = kernel.launches
    out = call(kernel, *args, window, workspace=ws)
    again = call(kernel, *args, window)
    torch.cuda.synchronize()
    kernel.launches = launches
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {label}: two launches on the same "
                             f"inputs differ")
    ref = plain(q.float(), *args[1:], rolling_window=window)
    if paged:
        views = [gather_paged_cache(c, index) for c in (k8, ks, v8, vs)]
    else:
        views = [c[index.long()] for c in (k8, ks, v8, vs)]
    term = quant_flip_term(q, *views, positions, rolling_window=window)
    diff = (out.float() - ref).abs()
    over = diff - KERNEL_REL * ref.abs()
    err, bare = float(diff.max()), float(over.max())
    excess = float((over - term).max())
    finite = bool(torch.isfinite(out.float()).all())
    print(f"kernel {name} {label}: max_abs_err={err:.3e} "
          f"max(|err| - {KERNEL_REL:.2e}*|plain|)={bare:.3e}, less the flip "
          f"term {excess:.3e} (tol {KERNEL_ABS:.0e}; term > 0 at "
          f"{int((term > 0).sum())} elements) finite={finite}", flush=True)
    if bare > KERNEL_ABS:
        i = int(over.argmax())
        bi, head, d = i // (h * hd), i % (h * hd) // hd, i % hd
        g = h // k8.shape[2]
        x, delta, _ = quant_decode_x(q, views[0], views[1], views[3],
                                     positions, rolling_window=window)
        pos = int(positions[bi])
        n = min(min(pos + 1, window) if window else pos + 1, width)
        at = (bi, head // g, head % g)
        xr, dr = x[at][:n], delta[at][:n]
        mine = quant_decode_p8(ws, b, h, kv, w_slots)[bi, head, :n]
        theirs = torch.round(xr).clamp(-127, 127)
        apart = (mine != theirs).nonzero().flatten().tolist()
        print(f"  element (b={bi}, head={head}, d={d}): p8 differs at "
              f"{len(apart)} of {n} slots", flush=True)
        for s in apart[:10]:
            ax = float(xr[s].abs())
            print(f"  element (b={bi}, head={head}, d={d}): p8 at slot {s}: "
                  f"kernel {float(mine[s]):.0f}, plain {float(theirs[s]):.0f}"
                  f"; plain x = {float(xr[s]):.9f}, "
                  f"{abs(ax - np.floor(ax) - 0.5):.3e} from a half-integer "
                  f"(delta {float(dr[s]):.3e})",
                  flush=True)
    if not finite or not excess <= KERNEL_ABS:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


QUANT_DRAWS = 6   # extra draws of each int8 decode mode (row 2bcr's check)


def _quant_decode_draws(name, kernel, plain, make, window=0):
    """The int8 decode mode's extra held cases: QUANT_DRAWS draws of its
    inputs (``make(gen)`` -> args) from a generator of their own, so the
    other cases keep theirs."""
    gen = np.random.default_rng(SEED + 10)
    for i in range(QUANT_DRAWS):
        _held_quant_decode(name, kernel, plain, make(gen),
                           f"draw {i + 1} of {QUANT_DRAWS}", window)


def _kernel_ms(kernel, fn, reps=50):
    """Kernel time; the timing launches do not count."""
    launches = kernel.launches
    ms = _time_ms(fn, reps=reps)
    kernel.launches = launches
    return ms


def _device_ms(kernel, fn, reps=20):
    """Device time of one ``fn()``: the stream first sleeps long enough
    for the host to enqueue all ``reps`` calls, so the events time them
    back to back on the card, without the host's launch work between
    them (at decode shapes that work is longer than the kernels: a
    back-to-back loop through the wrapper then times the host).  Raises
    if the host did not finish enqueuing before the sleep ended.  The
    timing launches of ``kernel`` (if given) do not count."""
    import torch
    launches = None if kernel is None else kernel.launches
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event(enable_timing=True)
    mark = torch.cuda.Event(enable_timing=True)
    mark.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if kernel is not None:
        kernel.launches = launches
    sleep_ms = mark.elapsed_time(slept)
    if not host_ms < sleep_ms:
        raise RuntimeError(f"the host took {host_ms:.1f} ms to enqueue "
                           f"{reps} calls, over the {sleep_ms:.1f} ms sleep")
    return start.elapsed_time(end) / reps


def _entry(name, src, replaces, err, ms, plain_ms, bound, lib_ms, card,
           call_ms=None):
    """Print a kernel's times beside its bound; its kernels-line entry
    (``launches`` filled in by the engine runs).  ``call_ms``: where ``ms``
    is a device time, the back-to-back time through the wrapper."""
    bound_ms, bound_by = bound
    lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
    call = "" if call_ms is None else f" call_ms={call_ms:.4f}"
    print(f"kernel {name}: ms={ms:.4f}{call} plain_ms={plain_ms:.4f} "
          f"library_ms={lib} bound_ms={bound_ms:.5f} ({bound_by}) on {card}",
          flush=True)
    entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                 launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    if call_ms is not None:
        entry["call_ms"] = call_ms
    return entry


def _quant(case):
    """The bf16 case's K/V cache quantized as the engine stores it."""
    from repro_torch.models.attention import quantize_kv
    (k8, ks), (v8, vs) = quantize_kv(case["k"]), quantize_kv(case["v"])
    return [case["q"], k8, ks, v8, vs, case["tables"], case["positions"]]


def _row_quant(case):
    """The contiguous case's int8 decode arguments (its cache rows
    quantized as the engine stores them)."""
    from repro_torch.models.attention import quantize_kv
    (k8, ks), (v8, vs) = quantize_kv(case["k"]), quantize_kv(case["v"])
    return [case["q"], k8, ks, v8, vs, case["rows"], case["positions"]]


def _flash_cases(dev):
    """The flash kernel's (rows 3, 3w, 3n) extra held cases, drawn from a
    generator of their own: causal at stablelm's widths (H = Kv = 32, hd
    64, B 2) over S = 64 (one whole tile) and S = 65 (a whole tile, then
    one more row and key), and at glm4-9b's widths (H 32, Kv 2, hd 128:
    g 16, 4 positions x 16 heads a block) over S = 397, B 2.  Returns the
    largest |error|; these launches do not count."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    gen = np.random.default_rng(SEED + 12)
    err = 0.0
    for b, s, h, kv, hd, label in ((2, 64, 32, 32, 64, "one tile"),
                                   (2, 65, 32, 32, 64, "a tile and a row"),
                                   (2, 397, 32, 2, 128, "glm4-9b widths")):
        q, k, v = (torch.tensor(gen.standard_normal((b, s, n, hd), np.float32),
                                device=dev).to(torch.bfloat16)
                   for n in (h, kv, kv))
        qpos = torch.arange(s, dtype=torch.int32, device=dev)
        err = max(err, _held("flash_attention", kfa.flash_attention,
                             kfa.flash_attention_plain, [q, k, v, qpos],
                             f"{label}: B={b} S={s} H={h} Kv={kv} hd={hd}"))
    return err


# llama4-maverick's attention widths: H 40 over Kv 8, hd 128.  g = 5 is no
# power of two: a tiled body's 64-row block holds 12 tokens (or positions)
# x 5 heads and 4 idle rows (csrc/tiled_primitives.cuh, tiled::Group)
G5 = (40, 8, 128)
G5_SPANS = [(0, 96), (200, 64), (448, 64), (120, 32)]   # the kernels phase's
G5_ROLLING = [(100, 64), (4050, 64), (4500, 64), (9000, 64)]  # rolling's


def _g5_entry(name, kernel, plain, args, label, bound, src, replaces, card,
              sdpa=None, kw=None, quant_decode=False):
    """A kernel at g 5 (``G5``), held against its plain version with the
    tolerance of its main shape (the int8 decode mode with its flip term),
    then timed on the device beside its plain version, its bound and, where
    one call computes the function, SDPA with ``enable_gqa`` (``sdpa``):
    the kernels line's entry ``<name>_g5``, whose launches the configs
    phase's llama4-maverick paths fill in.  These launches do not count."""
    kw = kw or {}
    text = f"g 5 (H={G5[0]} Kv={G5[1]} hd={G5[2]}) {label}"
    if quant_decode:
        err = _held_quant_decode(name, kernel, plain, args, text)
    else:
        err = _held(name, kernel, plain, args, text, **kw)
    plain_ms = _time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
    fn = lambda: kernel(*args, **kw)
    if sdpa is None:
        ms, call_ms = _device_ms(kernel, fn), _kernel_ms(kernel, fn)
        lib_ms = None
    else:
        ms, call_ms, lib_ms = _tiled_times(kernel, fn, sdpa)
    return kernel, _entry(f"{name}_g5", src, replaces, err, ms, plain_ms,
                          bound, lib_ms, card, call_ms)


def _g5_kernels(dev, card):
    """Rows 1, 7, 2, 2b and 3 at g 5 on the kernels phase's main shapes:
    the 256-token chunk over 4 ragged rows (16-slot pages; row 7 at the
    engine's 512-slot p-tile), a decode batch of 8 with contexts of
    100-1000, and the prefill of 4 prompts of S = 397, drawn from a
    generator of their own."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import span_attention as ksa
    gen = np.random.default_rng(SEED + 15)
    h, kv, hd = G5
    sdpa = F.scaled_dot_product_attention
    seq = np.concatenate([np.full(n, r) for r, (_, n) in enumerate(G5_SPANS)])
    pos = np.concatenate([o + np.arange(n) for o, n in G5_SPANS])
    out = []
    case = _paged_case(gen, pos, seq, len(G5_SPANS), h, kv, hd, 16, dev)
    q4, k4, v4, m4 = _sdpa_args(case, h, hd, False)
    out.append(_g5_entry(
        "paged_span_attention", ksa.paged_span_attention,
        ksa.paged_span_attention_plain,
        [case["q"], case["k"], case["v"], case["tables"], case["positions"],
         case["rows"]], "256-token chunk over 4 rows", _bound(case, h, hd),
        "src/repro_torch/csrc/paged_span_attention.cu",
        "src/repro/kernels/span_attention.py:611", card,
        sdpa=lambda: sdpa(q4, k4, v4, attn_mask=m4, enable_gqa=True)))
    out.append(_g5_entry(
        "paged_span_attention_quant", ksa.paged_span_attention_quant,
        ksa.paged_span_attention_quant_plain, _quant(case) + [case["rows"]],
        "256-token chunk over 4 rows, p-tile=512",
        _bound(case, h, hd, quant=True),
        "src/repro_torch/csrc/paged_span_attention_quant.cu",
        "src/repro/kernels/span_attention.py:656", card,
        kw={"kv_block": 512}))
    dec = _paged_case(gen, gen.integers(100, 1001, 8) - 1, np.arange(8), 8,
                      h, kv, hd, 16, dev)
    q4, k4, v4, m4 = _sdpa_args(dec, h, hd, True)
    out.append(_g5_entry(
        "paged_decode_attention", kda.paged_decode_attention,
        kda.paged_decode_attention_plain,
        [dec["q"], dec["k"], dec["v"], dec["tables"], dec["positions"]],
        "B=8 contexts 100-1000", _bound(dec, h, hd),
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:72", card,
        sdpa=lambda: sdpa(q4, k4, v4, attn_mask=m4, enable_gqa=True)))
    out.append(_g5_entry(
        "paged_decode_attention_quant", kda.paged_decode_attention_quant,
        kda.paged_decode_attention_quant_plain, _quant(dec),
        "B=8 contexts 100-1000", _bound(dec, h, hd, quant=True),
        "src/repro_torch/csrc/decode_attention_quant.cu",
        "src/repro/models/attention.py:553 (jnp decode_attention_quant; "
        "no Pallas kernel)", card, quant_decode=True))
    b, s = 4, 397
    q, k, v = (torch.tensor(gen.standard_normal((b, s, n, hd), np.float32),
                            device=dev).to(torch.bfloat16)
               for n in (h, kv, kv))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out.append(_g5_entry(
        "flash_attention", kfa.flash_attention, kfa.flash_attention_plain,
        [q, k, v, torch.arange(s, dtype=torch.int32, device=dev)],
        f"B={b} S={s}", _flash_bound(b, s, s, h, kv, hd, s * (s + 1) // 2),
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:80", card,
        sdpa=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    return out


def _g5_span_kernels(dev, card, layout):
    """The span kernels at g 5 on their phase's main steps: ``paged``, rows
    6 and 8 (the rolling phase's 256-token step over 4 rows at W = 4096,
    16-slot pages); ``rows``, rows 9 and 10 (the kernels phase's chunk over
    rows of S = 640) and 11 and 12 (the rolling step over rows of W).  Each
    rolling row also holds at W = 64 with bucket padding (every row
    wrapped)."""
    import torch.nn.functional as F
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import quantize_kv
    gen = np.random.default_rng(SEED + (16 if layout == "paged" else 17))
    h, kv, hd = G5
    sdpa = F.scaled_dot_product_attention
    quant = lambda c: [*quantize_kv(c["k"]), *quantize_kv(c["v"])]
    row_perm = gen.permutation(ROWS)
    out = []
    if layout == "rows":
        seq = np.concatenate([np.full(n, r)
                              for r, (_, n) in enumerate(G5_SPANS)])
        pos = np.concatenate([o + np.arange(n) for o, n in G5_SPANS])
        case = _row_case(gen, pos, seq, [5, 2, 7, 0], 640, h, kv, hd, dev)
        q4, k4, v4, m4 = _sdpa_args(case, h, hd, False,
                                    views=_row_views(case))
        index = [case["positions"], case["rows"]]
        out.append(_g5_entry(
            "span_attention", ksa.span_attention, ksa.span_attention_plain,
            [case["q"], case["k"], case["v"], *index],
            "256-token chunk over 4 rows of S=640", _bound(case, h, hd),
            "src/repro_torch/csrc/span_attention.cu",
            "src/repro/kernels/span_attention.py:132", card,
            sdpa=lambda: sdpa(q4, k4, v4, attn_mask=m4, enable_gqa=True)))
        out.append(_g5_entry(
            "span_attention_quant", ksa.span_attention_quant,
            ksa.span_attention_quant_plain, [case["q"], *quant(case), *index],
            "256-token chunk over 4 rows of S=640, p-tile=512",
            _bound(case, h, hd, quant=True),
            "src/repro_torch/csrc/span_attention_quant.cu",
            "src/repro/kernels/span_attention.py:239", card))
    specs = ((("paged_span_attention_rolling",
               ksa.paged_span_attention_rolling,
               ksa.paged_span_attention_rolling_plain, False,
               "src/repro_torch/csrc/paged_span_attention_rolling.cu",
               "src/repro/kernels/span_attention.py:703"),
              ("paged_span_attention_rolling_quant",
               ksa.paged_span_attention_rolling_quant,
               ksa.paged_span_attention_rolling_quant_plain, True,
               "src/repro_torch/csrc/paged_span_attention_rolling_quant.cu",
               "src/repro/kernels/span_attention.py:761"))
             if layout == "paged" else
             (("span_attention_rolling", ksa.span_attention_rolling,
               ksa.span_attention_rolling_plain, False,
               "src/repro_torch/csrc/span_attention_rolling.cu",
               "src/repro/kernels/span_attention.py:519"),
              ("span_attention_rolling_quant",
               ksa.span_attention_rolling_quant,
               ksa.span_attention_rolling_quant_plain, True,
               "src/repro_torch/csrc/span_attention_rolling_quant.cu",
               "src/repro/kernels/span_attention.py:456")))
    for name, kernel, plain, q8, src, replaces in specs:
        for window, spans, pad in ((64, G5_ROLLING[:3] + [(9000, 60)], 4),
                                   (4096, G5_ROLLING, 0)):
            if layout == "paged":
                case = _rolling_case(gen, spans, window, h, kv, hd, 16, dev,
                                     pad)
                index = [case["tables"], case["positions"], case["rows"]]
                views = None
            else:
                case = _row_rolling_case(gen, spans, window, row_perm, h, kv,
                                         hd, dev, pad)
                index = [case["positions"], case["rows"]]
                views = _row_views(case)
            cache = quant(case) if q8 else [case["k"], case["v"]]
            args = [case["q"], *cache, case["k_span"], case["v_span"],
                    *index, case["offsets"], case["n_valid"]]
            label = (f"W={window} T={case['q'].shape[0]} "
                     f"n_valid={case['n_valid']}")
            if window == 64:
                _held(name, kernel, plain, args,
                      f"g 5 (H={h} Kv={kv} hd={hd}) {label}", window=64)
                continue
            q4 = None if q8 else _rolling_sdpa_args(case, h, hd, views=views)
            out.append(_g5_entry(
                name, kernel, plain, args, label,
                _rolling_bound(case, h, hd, q8), src, replaces, card,
                sdpa=None if q8 else (lambda: sdpa(*q4[:3], attn_mask=q4[3],
                                                   enable_gqa=True)),
                kw={"window": window}))
    return out


def phase_kernels(dev, gen, card):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import kv_tile

    # main-path shapes: a 256-token chunk over 4 ragged rows; a decode
    # batch of 8 with contexts of 100-1000 tokens
    spans = [(0, 96), (200, 64), (448, 64), (120, 32)]
    span_rows = np.concatenate([np.full(n, r) for r, (_, n) in enumerate(spans)])
    span_pos = np.concatenate([s + np.arange(n) for s, n in spans])
    dec_pos = gen.integers(100, 1001, 8) - 1
    # GQA decode case: contexts of 1, 2, 16, 17 slots and a page boundary
    dec_pos_gqa = np.array([0, 1, 15, 16, 63, 64, 500, 999])
    h, hd, bs = 32, 64, 16
    results = []
    specs = [
        ("paged_span_attention", ksa.paged_span_attention,
         ksa.paged_span_attention_plain, span_pos, span_pos, span_rows,
         len(spans), False, "src/repro_torch/csrc/paged_span_attention.cu",
         "src/repro/kernels/span_attention.py:611"),
        ("paged_decode_attention", kda.paged_decode_attention,
         kda.paged_decode_attention_plain, dec_pos, dec_pos_gqa,
         np.arange(8), 8, True,
         "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:72"),
    ]
    for (name, kernel, plain, pos, pos_gqa, rows, n_rows, decode, src,
         replaces) in specs:
        entry = None
        for kv, p in ((32, pos), (8, pos_gqa)):  # main shape, then g = 4
            case = _paged_case(gen, p, rows, n_rows, h, kv, hd, bs, dev)
            args = [case["q"], case["k"], case["v"], case["tables"],
                    case["positions"]]
            if not decode:
                args.append(case["rows"])
            err = _held(name, kernel, plain, args, f"H={h} Kv={kv} hd={hd}")
            if kv != h:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
            q4, k4, v4, m4 = _sdpa_args(case, h, hd, decode)
            sdpa = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, enable_gqa=True)
            # rows 1 and 2: device times (tensor-core bodies)
            ms, call_ms, lib_ms = _tiled_times(kernel, lambda: kernel(*args),
                                               sdpa)
            entry = _entry(name, src, replaces, err, ms, plain_ms,
                           _bound(case, h, hd), lib_ms, card, call_ms)
        results.append((kernel, entry))

    # the kernels of monolithic prefill and of the int8 cache draw their
    # inputs from a generator of their own, so the engine phase's prompts
    # stay those of the runs before them
    gen2 = np.random.default_rng(SEED + 1)

    # flash: the prefill of 4 right-padded prompts, S = 397 (no power of
    # two, no tile multiple), then GQA g = 4
    b, s = 4, 397
    flash_src = "src/repro_torch/csrc/flash_attention.cu"
    entry = None
    for kv in (32, 8):
        q, k, v = (torch.tensor(gen2.standard_normal((b, s, n, hd), np.float32),
                                device=dev).to(torch.bfloat16)
                   for n in (h, kv, kv))
        qpos = torch.arange(s, dtype=torch.int32, device=dev)
        args = [q, k, v, qpos]
        err = _held("flash_attention", kfa.flash_attention,
                    kfa.flash_attention_plain, args,
                    f"B={b} S={s} H={h} Kv={kv} hd={hd}")
        if kv != h:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            continue
        plain_ms = _time_ms(lambda: kfa.flash_attention_plain(*args), reps=3,
                            warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, call_ms, lib_ms = _tiled_times(
            kfa.flash_attention, lambda: kfa.flash_attention(*args),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        entry = _entry("flash_attention", flash_src,
                       "src/repro/kernels/flash_attention.py:80", err, ms,
                       plain_ms, _flash_bound(b, s, s, h, kv, hd,
                                              s * (s + 1) // 2), lib_ms, card,
                       call_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], _flash_cases(dev))
    results.append((kfa.flash_attention, entry))

    # the int8 kernels: no single PyTorch call computes them (library_ms
    # null).  Span: the chunk above, at the engine's p tile (kv_block 512
    # over the 32-page table: 512 slots) and at one page (16)
    quant_specs = [
        ("paged_span_attention_quant", ksa.paged_span_attention_quant,
         ksa.paged_span_attention_quant_plain, span_pos, span_pos, span_rows,
         len(spans), False, "src/repro_torch/csrc/paged_span_attention_quant.cu",
         "src/repro/kernels/span_attention.py:656"),
        ("paged_decode_attention_quant", kda.paged_decode_attention_quant,
         kda.paged_decode_attention_quant_plain, gen2.integers(100, 1001, 8) - 1,
         dec_pos_gqa, np.arange(8), 8, True,
         "src/repro_torch/csrc/decode_attention_quant.cu",
         "src/repro/models/attention.py:553 (jnp decode_attention_quant; "
         "no Pallas kernel)"),
    ]
    for (name, kernel, plain, pos, pos_gqa, rows, n_rows, decode, src,
         replaces) in quant_specs:
        entry = None
        for kv, p in ((32, pos), (8, pos_gqa)):
            case = _paged_case(gen2, p, rows, n_rows, h, kv, hd, bs, dev)
            args = _quant(case)
            tiles = [None]
            if not decode:
                args.append(case["rows"])
                width = case["tables"].shape[1] * bs
                tiles = [512, bs] if kv == h else [512]
            for tile in tiles:
                kw = {} if tile is None else {"kv_block": tile}
                label = f"H={h} Kv={kv} hd={hd}" + (
                    "" if tile is None else f" p-tile={kv_tile(tile, width)}")
                if decode:
                    err = _held_quant_decode(name, kernel, plain, args, label)
                else:
                    err = _held(name, kernel, plain, args, label, **kw)
                if entry is not None:
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if kv != h:
                    continue
                # rows 2b and 7: device times (a split and a tiled body)
                ms = _device_ms(kernel, lambda: kernel(*args, **kw))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args, **kw))
                if entry is not None:        # the one-page tile
                    entry["ms_page_tile"] = ms
                    print(f"kernel {name}: ms={ms:.4f} call_ms="
                          f"{call_ms:.4f} at the one-page p-tile on {card}",
                          flush=True)
                    continue
                plain_ms = _time_ms(lambda: plain(*args, **kw), reps=3,
                                    warmup=1)
                entry = _entry(name, src, replaces, err, ms, plain_ms,
                               _bound(case, h, hd, quant=True), None, card,
                               call_ms)
        results.append((kernel, entry))
    _quant_decode_draws(
        "paged_decode_attention_quant", kda.paged_decode_attention_quant,
        kda.paged_decode_attention_quant_plain,
        lambda g: _quant(_paged_case(g, g.integers(100, 1001, 8) - 1,
                                     np.arange(8), 8, h, h, hd, bs, dev)))
    return results + _g5_kernels(dev, card)


def _rolling_case(gen, spans, window, h, kv, hd, bs, dev, pad=0):
    """A packed span over rows r with ``spans[r] = (off, c)``: row r's
    rolling cache holds positions [0, off) and the span brings off..off+c-1
    (``pad`` bucket-padding tokens duplicate the last one, so n_valid < T).
    Each row's table has min(ceil((off + c) / bs), W / bs) shuffled blocks,
    padded with the trash block (last); every physical block, unused and
    trash blocks included, holds random values.  Decode rows are spans of
    one token (off = position)."""
    import torch
    need = [min(-(-(o + c) // bs), window // bs) for o, c in spans]
    nb = max(need)
    n_phys = sum(need) + 1
    perm = gen.permutation(n_phys - 1)
    tables = np.full((len(spans), nb), n_phys - 1, np.int32)
    used = 0
    for r, k in enumerate(need):
        tables[r, :k] = perm[used:used + k]
        used += k
    seq = np.concatenate([np.full(c, r) for r, (_, c) in enumerate(spans)])
    pos = np.concatenate([o + np.arange(c) for o, c in spans])
    offs = np.array([spans[r][0] for r in seq])
    n_valid = len(seq)
    seq, pos, offs = (np.concatenate([a, np.repeat(a[-1:], pad)])
                      for a in (seq, pos, offs))
    t = len(seq)

    def rand(*shape):
        return torch.tensor(gen.standard_normal(shape, np.float32),
                            device=dev).to(torch.bfloat16)

    k_span, v_span = rand(t, kv, hd), rand(t, kv, hd)
    if pad:
        k_span[n_valid:], v_span[n_valid:] = (x[n_valid - 1]
                                              for x in (k_span, v_span))
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return dict(q=rand(t, h, hd), k=rand(n_phys, bs, kv, hd),
                v=rand(n_phys, bs, kv, hd), k_span=k_span, v_span=v_span,
                tables=i32(tables), positions=i32(pos), rows=i32(seq),
                offsets=i32(offs), n_valid=n_valid, window=window,
                np=dict(pos=pos, seq=seq, offs=offs, w_slots=nb * bs))


def _rolling_visible(case):
    """[T, nb * bs] old-cache slots and [T, T] fresh span entries each
    token sees (the rolling kernels' masks, in numpy)."""
    c = case["np"]
    pos, seq, offs, w = c["pos"], c["seq"], c["offs"], case["window"]
    slot = np.arange(c["w_slots"])
    stored = offs[:, None] - 1 - (offs[:, None] - 1 - slot[None]) % c["w_slots"]
    old = (offs[:, None] >= 1) & (stored >= 0) & (stored > pos[:, None] - w)
    span = (seq[None] == seq[:, None]) & (pos[None] <= pos[:, None]) \
        & (pos[None] > pos[:, None] - w) \
        & (np.arange(len(pos))[None] < case["n_valid"])
    return old, span


# the tiled rolling kernels' (rows 6 and 11) extra held cases at
# mixtral's widths, W = 4096: a mixed step, 1-token decode rows beside
# chunks of 91 tokens (from off = 0) and 37 (runs that are not a multiple
# of the 16-token query tile), bucket padding; then the same step with the
# rows interleaved in seq_idx
MIXED_SPANS = [(0, 91), (4095, 1), (5000, 37), (9000, 1), (300, 1),
               (4060, 91)]
MIXED_PAD = 5


def _interleave(case):
    """``case`` with its valid tokens reordered round robin over the rows
    (the bucket padding stays last): each row's tokens lie apart."""
    import torch
    c, n = case["np"], case["n_valid"]
    seq = c["seq"][:n]
    rank = np.zeros(n, np.int64)
    for r in np.unique(seq):
        rank[seq == r] = np.arange(int((seq == r).sum()))
    idx = np.concatenate([np.lexsort((seq, rank)),
                          np.arange(n, len(c["seq"]))])
    out = dict(case)
    it = torch.tensor(idx, device=case["q"].device)
    for k in ("q", "k_span", "v_span", "positions", "rows", "offsets"):
        out[k] = case[k][it].contiguous()
    out["np"] = dict(c, pos=c["pos"][idx], seq=c["seq"][idx],
                     offs=c["offs"][idx])
    return out


def _tiled_cases(spans, spans64):
    """(window, spans, pad, kind) of a rolling span kernel's held cases:
    the main case first (timed), W = 64, then the mixed and interleaved
    steps."""
    return [(4096, spans, 0, "main"), (64, spans64, 4, "wrapped"),
            (4096, MIXED_SPANS, MIXED_PAD, "mixed"),
            (4096, MIXED_SPANS, MIXED_PAD, "interleaved")]


def _tiled_times(kernel, fn, sdpa_fn):
    """(device ms, ms back to back through the wrapper, SDPA device ms) of
    a tensor-core kernel: at ~0.1 ms a call's host work (0.02-0.05 ms)
    would be part of a back-to-back figure."""
    return (_device_ms(kernel, fn), _kernel_ms(kernel, fn),
            _device_ms(None, sdpa_fn))


def _roofline(n_bytes, bf16_ops, int8_ops=0):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the tensor-core rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = bf16_ops / BF16_FLOP_S + int8_ops / INT8_OP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _table_ints(case) -> int:
    """int32 entries of a case's block tables (none over contiguous rows,
    whose row index per token is one of the index vectors)."""
    return case["tables"].numel() if "tables" in case else 0


def _rolling_bound(case, h, hd, quant=False):
    """Least time of a rolling span step: the old-cache slots any token of
    a row sees, read once per row (int8 values and bf16 scales for the
    int8 cache), the valid fresh span K/V, q, the output and the index
    vectors (the block tables, where there are any) (bytes); 4*H*hd
    operations per visible (token, slot) pair, int8 for the int8 cache's
    old slots and bf16 otherwise."""
    old, span = _rolling_visible(case)
    seq = case["np"]["seq"]
    kv = case["k"].shape[2]
    t = len(seq)
    old_slots = sum(int(old[seq == r].any(0).sum()) for r in np.unique(seq))
    per_slot = (hd + 2) * 2 if quant else hd * 2 * 2
    n_bytes = (old_slots * kv * per_slot + case["n_valid"] * kv * hd * 2 * 2
               + 2 * t * h * hd * 2 + 4 * (_table_ints(case) + 3 * t))
    old_ops, span_ops = 4 * h * hd * int(old.sum()), 4 * h * hd * int(span.sum())
    if quant:
        return _roofline(n_bytes, span_ops, old_ops)
    return _roofline(n_bytes, old_ops + span_ops)


def _rolling_sdpa_args(case, h, hd, views=None):
    """The library yardstick of a rolling span step: per row, its padded
    queries [C] against its gathered view (or ``views``, each batch row's
    [B, S, Kv, hd] K and V) plus the whole span's fresh K/V, under a
    boolean mask of what each token sees."""
    import torch
    from repro_torch.models.attention import gather_paged_cache
    old, span = _rolling_visible(case)
    seq = case["np"]["seq"]
    n_rows = int(seq.max()) + 1
    if views is None:
        views = [gather_paged_cache(case[n], case["tables"]) for n in "kv"]
    kg, vg = views                                       # [B, S, Kv, hd]
    keys = torch.cat([kg, case["k_span"][None].expand(n_rows, -1, -1, -1)], 1)
    vals = torch.cat([vg, case["v_span"][None].expand(n_rows, -1, -1, -1)], 1)
    c = int(np.bincount(seq).max())
    dev = keys.device
    q = torch.zeros((n_rows, c, h, hd), dtype=keys.dtype, device=dev)
    mask = np.zeros((n_rows, c, keys.shape[1]), bool)
    slot = np.zeros(len(seq), np.int64)
    seen = np.zeros(n_rows, np.int64)
    for i, r in enumerate(seq):
        slot[i], seen[r] = seen[r], seen[r] + 1
    mask[seq, slot] = np.concatenate([old, span], 1)
    q[torch.tensor(seq, device=dev), torch.tensor(slot, device=dev)] = case["q"]
    return (q.transpose(1, 2), keys.transpose(1, 2).contiguous(),
            vals.transpose(1, 2).contiguous(),
            torch.tensor(mask, device=dev)[:, None])


def phase_rolling_kernels(dev, card):
    """The sliding-window kernels at mixtral-8x7b's widths (H 32, Kv 8,
    hd 128, 16-slot pages), at W = 4096 with rows on both sides of the
    window and at W = 64, where every row has wrapped many times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import (gather_paged_cache, kv_tile,
                                              quantize_kv)

    gen = np.random.default_rng(SEED + 2)
    # the tiled kernels' extra cases draw apart: the other cases keep their
    # inputs from run to run
    tgen = np.random.default_rng(SEED + 8)
    h, kv, hd, bs = 32, 8, 128, 16
    # a 256-token chunk over 4 rows: a short row, a span crossing W, two
    # wrapped rows; then the same widths at W = 64 with bucket padding
    spans = [(100, 64), (4050, 64), (4500, 64), (9000, 64)]
    spans64 = [(100, 64), (4050, 64), (4500, 64), (9000, 60)]
    dec = [(p, 1) for p in (99, 700, 2047, 4095, 4096, 4600, 7000, 8999)]
    results = []
    for name, kernel, plain, quant, src, replaces in (
            ("paged_span_attention_rolling", ksa.paged_span_attention_rolling,
             ksa.paged_span_attention_rolling_plain, False,
             "src/repro_torch/csrc/paged_span_attention_rolling.cu",
             "src/repro/kernels/span_attention.py:703"),
            ("paged_span_attention_rolling_quant",
             ksa.paged_span_attention_rolling_quant,
             ksa.paged_span_attention_rolling_quant_plain, True,
             "src/repro_torch/csrc/paged_span_attention_rolling_quant.cu",
             "src/repro/kernels/span_attention.py:761")):
        entry = None
        for window, sp, pad, kind in _tiled_cases(spans, spans64):
            case = _rolling_case(gen if kind in ("main", "wrapped") else tgen,
                                 sp, window, h, kv, hd, bs, dev, pad)
            if kind == "interleaved":
                case = _interleave(case)
            cache = [case["k"], case["v"]]
            if quant:
                (k8, ks), (v8, vs) = quantize_kv(case["k"]), quantize_kv(case["v"])
                cache = [k8, ks, v8, vs]
            args = [case["q"], *cache, case["k_span"], case["v_span"],
                    case["tables"], case["positions"], case["rows"],
                    case["offsets"], case["n_valid"]]
            kw = {"window": window}
            label = (f"{kind} W={window} H={h} Kv={kv} hd={hd} "
                     f"T={case['q'].shape[0]} n_valid={case['n_valid']}")
            if quant:
                width = case["tables"].shape[1] * bs
                label += f" p-tile={kv_tile(512, width)}"
            err = _held(name, kernel, plain, args, label, **kw)
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
            bound = _rolling_bound(case, h, hd, quant)
            if quant:                # row 8: device times (a tiled body)
                ms = _device_ms(kernel, lambda: kernel(*args, **kw))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args, **kw))
                entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                               None, card, call_ms)
                continue
            sdpa = _rolling_sdpa_args(case, h, hd)
            ms, call_ms, lib_ms = _tiled_times(
                kernel, lambda: kernel(*args, **kw),
                lambda: F.scaled_dot_product_attention(
                    *sdpa[:3], attn_mask=sdpa[3], enable_gqa=True))
            del sdpa
            entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                           lib_ms, card, call_ms)
        results.append((kernel, entry))

    for name, kernel, plain, quant, src, replaces in (
            ("paged_decode_attention_rolling",
             kda.paged_decode_attention_rolling,
             kda.paged_decode_attention_plain, False,
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:72 (rolling mode: the "
             "reference runs jnp decode_attention(rolling_window) on the "
             "gathered view, transformer.py:102-146)"),
            ("paged_decode_attention_quant_rolling",
             kda.paged_decode_attention_quant_rolling,
             kda.paged_decode_attention_quant_plain, True,
             "src/repro_torch/csrc/decode_attention_quant.cu",
             "src/repro/models/attention.py:553 (jnp decode_attention_quant"
             "(rolling_window); no Pallas kernel)")):
        entry = None
        for window in (4096, 64):
            case = _rolling_case(gen, dec, window, h, kv, hd, bs, dev)
            cache = [case["k"], case["v"]]
            if quant:
                (k8, ks), (v8, vs) = quantize_kv(case["k"]), quantize_kv(case["v"])
                cache = [k8, ks, v8, vs]
            args = [case["q"], *cache, case["tables"], case["positions"]]
            kw = {"window": window}
            pkw = {"rolling_window": window}
            pl = lambda *a, **_: plain(*a, **pkw)
            label = f"W={window} B=8 contexts 100-9000"
            if quant:
                err = _held_quant_decode(name, kernel, plain, args, label,
                                         window)
            else:
                err = _held(name, kernel, pl, args, label, **kw)
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: pl(*args), reps=3, warmup=1)
            vis = np.minimum(case["np"]["pos"] + 1, window)
            per_slot = (hd + 2) * 2 if quant else hd * 2 * 2
            n_bytes = (int(vis.sum()) * kv * per_slot + 2 * 8 * h * hd * 2
                       + 4 * (case["tables"].numel() + 8))
            ops = 4 * h * hd * int(vis.sum())
            bound = (_roofline(n_bytes, 0, ops) if quant
                     else _roofline(n_bytes, ops))
            lib_ms = call_ms = None
            if quant:               # row 2br: device times (a split body)
                ms = _device_ms(kernel, lambda: kernel(*args, **kw))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args, **kw))
            else:                   # row 2r: device times (a split body)
                kg = gather_paged_cache(case["k"], case["tables"]).transpose(1, 2)
                vg = gather_paged_cache(case["v"], case["tables"]).transpose(1, 2)
                idx = torch.arange(kg.shape[2], device=dev)
                mask = (idx[None] < torch.tensor(vis, device=dev)[:, None])
                q4 = case["q"][:, :, None]               # [B, H, 1, hd]
                m4 = mask[:, None, None]
                ms, call_ms, lib_ms = _tiled_times(
                    kernel, lambda: kernel(*args, **kw),
                    lambda: F.scaled_dot_product_attention(
                        q4, kg, vg, attn_mask=m4, enable_gqa=True))
                del kg, vg
            entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                           lib_ms, card, call_ms)
        results.append((kernel, entry))
    _quant_decode_draws(
        "paged_decode_attention_quant_rolling",
        kda.paged_decode_attention_quant_rolling,
        kda.paged_decode_attention_quant_plain,
        lambda g: _quant(_rolling_case(g, dec, 4096, h, kv, hd, bs, dev)),
        4096)

    # windowed flash: B = 2, S = 4500 at W = 4096 (the main shape), then
    # S = 397 at W = 64; the plain version is local_attention (fp32 here)
    entry = None
    for b, s, window in ((2, 4500, 4096), (2, 397, 64)):
        q, k, v = (torch.tensor(gen.standard_normal((b, s, n, hd), np.float32),
                                device=dev).to(torch.bfloat16)
                   for n in (h, kv, kv))
        qpos = torch.arange(s, dtype=torch.int32, device=dev)
        args = [q, k, v, qpos]
        kw = {"window": window, "kv_block": min(512, window)}
        err = _held("flash_attention_windowed", kfa.flash_attention,
                    kfa.flash_attention_plain, args,
                    f"B={b} S={s} W={window} H={h} Kv={kv} hd={hd}", **kw)
        if entry is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            continue
        plain_ms = _time_ms(lambda: kfa.flash_attention_plain(*args, **kw),
                            reps=3, warmup=1)
        i = torch.arange(s, device=dev)
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, call_ms, lib_ms = _tiled_times(
            kfa.flash_attention, lambda: kfa.flash_attention(*args, **kw),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True))
        pairs = int(np.minimum(np.arange(s) + 1, window).sum())
        n_bytes = 2 * b * s * (2 * h + 2 * kv) * hd + 4 * s
        entry = _entry("flash_attention_windowed",
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:80 (window band)",
                       err, ms, plain_ms,
                       _roofline(n_bytes, 4 * hd * h * b * pairs), lib_ms,
                       card, call_ms)
    results.append((kfa.flash_attention, entry))
    return results + _g5_span_kernels(dev, card, "paged")


ROWS = 8        # cache rows of the kernel checks' contiguous caches


def _row_case(gen, positions, batch_rows, cache_rows, n_slots, h, kv, hd,
              dev):
    """The contiguous layout's inputs: bf16 q [N, H, hd]; [ROWS, S, Kv,
    hd] caches whose every slot holds random values; token (or decode
    row) i of batch row batch_rows[i] reads cache row
    cache_rows[batch_rows[i]] (the rows are out of order)."""
    import torch
    ctx = np.zeros(len(cache_rows), np.int64)
    for r, p in zip(batch_rows, positions):
        ctx[r] = max(ctx[r], min(p + 1, n_slots))

    def rand(*shape):
        return torch.tensor(gen.standard_normal(shape, np.float32),
                            device=dev).to(torch.bfloat16)

    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    rows = np.asarray(cache_rows)[np.asarray(batch_rows)]
    return dict(q=rand(len(positions), h, hd), k=rand(ROWS, n_slots, kv, hd),
                v=rand(ROWS, n_slots, kv, hd), positions=t(positions),
                rows=t(rows), batch_rows=t(batch_rows), ctx=ctx,
                cache_rows=t(cache_rows))


def _row_views(case):
    """Each batch row's [B, S, Kv, hd] K and V (the library yardstick's
    inputs)."""
    r = case["cache_rows"].long()
    return case["k"][r], case["v"][r]


def _row_rolling_case(gen, spans, window, cache_rows, h, kv, hd, dev, pad=0):
    """A packed span over rolling rows [ROWS, W, Kv, hd]: batch row b (cache
    row cache_rows[b]) holds positions [0, off) with ``spans[b] = (off,
    c)`` and the span brings off..off+c-1; ``pad`` bucket-padding tokens
    repeat the last one (n_valid < T).  Decode rows are spans of one token
    (off = position).  Every slot holds random values."""
    import torch
    seq = np.concatenate([np.full(c, r) for r, (_, c) in enumerate(spans)])
    pos = np.concatenate([o + np.arange(c) for o, c in spans])
    offs = np.array([spans[r][0] for r in seq])
    n_valid = len(seq)
    seq, pos, offs = (np.concatenate([a, np.repeat(a[-1:], pad)])
                      for a in (seq, pos, offs))
    t = len(seq)

    def rand(*shape):
        return torch.tensor(gen.standard_normal(shape, np.float32),
                            device=dev).to(torch.bfloat16)

    k_span, v_span = rand(t, kv, hd), rand(t, kv, hd)
    if pad:
        k_span[n_valid:], v_span[n_valid:] = (x[n_valid - 1]
                                              for x in (k_span, v_span))
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return dict(q=rand(t, h, hd), k=rand(ROWS, window, kv, hd),
                v=rand(ROWS, window, kv, hd), k_span=k_span, v_span=v_span,
                positions=i32(pos), rows=i32(np.asarray(cache_rows)[seq]),
                offsets=i32(offs), n_valid=n_valid, window=window,
                cache_rows=i32(np.asarray(cache_rows)[:len(spans)]),
                np=dict(pos=pos, seq=seq, offs=offs, w_slots=window))


def phase_contiguous_kernels(dev, card):
    """The contiguous layout's kernels (rows 9-12 of PERF.md's table and
    the contiguous modes of both decode kernels), over [R, S, Kv, hd] rows
    read out of order: rows 9, 10 and the full decode modes at stablelm's
    shapes (H = Kv = 32, hd 64, S = 640 rows: the engine phase's
    max_seq_len) and at g = 4; rows 11, 12 and the rolling decode modes at
    mixtral's (H 32, Kv 8, hd 128) over rows of W = 4096 (wrapped and
    not), then W = 64 (every row wrapped, the span padded).  Checked and
    timed as the paged kernels."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import kv_tile, quantize_kv

    gen = np.random.default_rng(SEED + 4)
    tgen = np.random.default_rng(SEED + 9)     # as in the rolling phase
    quant = lambda c: [*quantize_kv(c["k"]), *quantize_kv(c["v"])]
    results = []

    # stablelm: the engine phase's 256-token chunk over 4 ragged rows, and
    # a decode batch of 8 with contexts up to S = 640
    h, hd, s_rows = 32, 64, 640
    spans = [(0, 96), (200, 64), (448, 64), (120, 32)]
    span_b = np.concatenate([np.full(n, r) for r, (_, n) in enumerate(spans)])
    span_pos = np.concatenate([st + np.arange(n) for st, n in spans])
    span_rows = [5, 2, 7, 0]                   # of ROWS = 8, out of order
    dec_pos = gen.integers(100, s_rows + 1, 8) - 1
    dec_pos_gqa = np.array([0, 1, 15, 16, 63, 64, 500, 639])
    dec_rows = gen.permutation(8)
    for name, kernel, plain, q8, decode, src, replaces in (
            ("span_attention", ksa.span_attention, ksa.span_attention_plain,
             False, False, "src/repro_torch/csrc/span_attention.cu",
             "src/repro/kernels/span_attention.py:132"),
            ("span_attention_quant", ksa.span_attention_quant,
             ksa.span_attention_quant_plain, True, False,
             "src/repro_torch/csrc/span_attention_quant.cu",
             "src/repro/kernels/span_attention.py:239"),
            ("contiguous_decode_attention", kda.contiguous_decode_attention,
             kda.contiguous_decode_attention_plain, False, True,
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:72 (its own contiguous "
             "layout, lengths = positions + 1)"),
            ("contiguous_decode_attention_quant",
             kda.contiguous_decode_attention_quant,
             kda.contiguous_decode_attention_quant_plain, True, True,
             "src/repro_torch/csrc/decode_attention_quant.cu",
             "src/repro/models/attention.py:553 (jnp decode_attention_quant "
             "on cache rows; no Pallas kernel)")):
        entry = None
        for kv in (32, 8):                          # main shape, then g = 4
            if decode:
                pos = dec_pos if kv == h else dec_pos_gqa
                case = _row_case(gen, pos, np.arange(8), dec_rows, s_rows,
                                 h, kv, hd, dev)
                index = [case["rows"], case["positions"]]
            else:
                case = _row_case(gen, span_pos, span_b, span_rows, s_rows, h,
                                 kv, hd, dev)
                index = [case["positions"], case["rows"]]
            cache = quant(case) if q8 else [case["k"], case["v"]]
            args = [case["q"], *cache, *index]
            label = f"R={ROWS} S={s_rows} H={h} Kv={kv} hd={hd}"
            if q8 and not decode:
                label += f" p-tile={kv_tile(512, s_rows)}"
            if q8 and decode:
                err = _held_quant_decode(name, kernel, plain, args, label)
            else:
                err = _held(name, kernel, plain, args, label)
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
            lib_ms = call_ms = None
            if q8:            # rows 2bc, 10: device times (split, tiled body)
                ms = _device_ms(kernel, lambda: kernel(*args))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args))
            else:
                q4, k4, v4, m4 = _sdpa_args(case, h, hd, decode,
                                            views=_row_views(case))
                sdpa = lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=m4, enable_gqa=True)
                # rows 9 and 2c: device times (tensor-core bodies)
                ms, call_ms, lib_ms = _tiled_times(
                    kernel, lambda: kernel(*args), sdpa)
                del q4, k4, v4, m4
            entry = _entry(name, src, replaces, err, ms, plain_ms,
                           _bound(case, h, hd, quant=q8), lib_ms, card,
                           call_ms)
        results.append((kernel, entry))
    _quant_decode_draws(
        "contiguous_decode_attention_quant",
        kda.contiguous_decode_attention_quant,
        kda.contiguous_decode_attention_quant_plain,
        lambda g: _row_quant(_row_case(g, g.integers(100, s_rows + 1, 8) - 1,
                                       np.arange(8), g.permutation(8), s_rows,
                                       h, h, hd, dev)))

    # mixtral: the rolling phase's spans and decode contexts over rows of
    # W slots, 8 rows out of order
    h, kv, hd = 32, 8, 128
    spans = [(100, 64), (4050, 64), (4500, 64), (9000, 64)]
    spans64 = [(100, 64), (4050, 64), (4500, 64), (9000, 60)]
    dec = [(p, 1) for p in (99, 700, 2047, 4095, 4096, 4600, 7000, 8999)]
    row_perm = gen.permutation(8)
    for name, kernel, plain, q8, src, replaces in (
            ("span_attention_rolling", ksa.span_attention_rolling,
             ksa.span_attention_rolling_plain, False,
             "src/repro_torch/csrc/span_attention_rolling.cu",
             "src/repro/kernels/span_attention.py:519"),
            ("span_attention_rolling_quant", ksa.span_attention_rolling_quant,
             ksa.span_attention_rolling_quant_plain, True,
             "src/repro_torch/csrc/span_attention_rolling_quant.cu",
             "src/repro/kernels/span_attention.py:456")):
        entry = None
        for window, sp, pad, kind in _tiled_cases(spans, spans64):
            case = _row_rolling_case(
                gen if kind in ("main", "wrapped") else tgen, sp, window,
                row_perm, h, kv, hd, dev, pad)
            if kind == "interleaved":
                case = _interleave(case)
            cache = quant(case) if q8 else [case["k"], case["v"]]
            args = [case["q"], *cache, case["k_span"], case["v_span"],
                    case["positions"], case["rows"], case["offsets"],
                    case["n_valid"]]
            kw = {"window": window}
            label = (f"{kind} W={window} H={h} Kv={kv} hd={hd} "
                     f"T={case['q'].shape[0]} n_valid={case['n_valid']}")
            if q8:
                label += f" p-tile={kv_tile(512, window)}"
            err = _held(name, kernel, plain, args, label, **kw)
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
            bound = _rolling_bound(case, h, hd, q8)
            if q8:                   # row 12: device times (a tiled body)
                ms = _device_ms(kernel, lambda: kernel(*args, **kw))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args, **kw))
                entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                               None, card, call_ms)
                continue
            sdpa = _rolling_sdpa_args(case, h, hd, views=_row_views(case))
            ms, call_ms, lib_ms = _tiled_times(
                kernel, lambda: kernel(*args, **kw),
                lambda: F.scaled_dot_product_attention(
                    *sdpa[:3], attn_mask=sdpa[3], enable_gqa=True))
            del sdpa
            entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                           lib_ms, card, call_ms)
        results.append((kernel, entry))
    _rows_equal_pages(tgen, h, kv, hd, spans, dev)
    _full_span_cases(dev)

    for name, kernel, plain, q8, src, replaces in (
            ("contiguous_decode_attention_rolling",
             kda.contiguous_decode_attention_rolling,
             kda.contiguous_decode_attention_plain, False,
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:72 (contiguous rolling "
             "mode: the reference runs jnp decode_attention(rolling_window) "
             "on its rows, transformer.py:145-167)"),
            ("contiguous_decode_attention_quant_rolling",
             kda.contiguous_decode_attention_quant_rolling,
             kda.contiguous_decode_attention_quant_plain, True,
             "src/repro_torch/csrc/decode_attention_quant.cu",
             "src/repro/models/attention.py:553 (jnp decode_attention_quant"
             "(rolling_window) on cache rows; no Pallas kernel)")):
        entry = None
        for window in (4096, 64):
            case = _row_rolling_case(gen, dec, window, row_perm, h, kv, hd,
                                     dev)
            cache = quant(case) if q8 else [case["k"], case["v"]]
            args = [case["q"], *cache, case["rows"], case["positions"]]
            kw = {"window": window}
            pl = lambda *a, **_: plain(*a, rolling_window=window)
            label = f"W={window} B=8 contexts 100-9000"
            if q8:
                err = _held_quant_decode(name, kernel, plain, args, label,
                                         window)
            else:
                err = _held(name, kernel, pl, args, label, **kw)
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: pl(*args), reps=3, warmup=1)
            vis = np.minimum(case["np"]["pos"] + 1, window)
            per_slot = (hd + 2) * 2 if q8 else hd * 2 * 2
            n_bytes = (int(vis.sum()) * kv * per_slot + 2 * 8 * h * hd * 2
                       + 4 * 2 * 8)
            ops = 4 * h * hd * int(vis.sum())
            bound = (_roofline(n_bytes, 0, ops) if q8
                     else _roofline(n_bytes, ops))
            lib_ms = call_ms = None
            if q8:                 # row 2bcr: device times (a split body)
                ms = _device_ms(kernel, lambda: kernel(*args, **kw))
                call_ms = _kernel_ms(kernel, lambda: kernel(*args, **kw))
            else:                  # row 2cr: device times (a split body)
                kg, vg = (x.transpose(1, 2) for x in _row_views(case))
                idx = torch.arange(window, device=dev)
                m4 = (idx[None] < torch.tensor(vis, device=dev)[:, None])
                q4 = case["q"][:, :, None]               # [B, H, 1, hd]
                ms, call_ms, lib_ms = _tiled_times(
                    kernel, lambda: kernel(*args, **kw),
                    lambda: F.scaled_dot_product_attention(
                        q4, kg, vg, attn_mask=m4[:, None, None],
                        enable_gqa=True))
                del kg, vg
            entry = _entry(name, src, replaces, err, ms, plain_ms, bound,
                           lib_ms, card, call_ms)
        results.append((kernel, entry))
    _quant_decode_draws(
        "contiguous_decode_attention_quant_rolling",
        kda.contiguous_decode_attention_quant_rolling,
        kda.contiguous_decode_attention_quant_plain,
        lambda g: _row_quant(_row_rolling_case(g, dec, 4096, row_perm, h, kv,
                                               hd, dev)),
        4096)
    _split_decode_cases(dev)
    _quant_split_cases(dev)
    return results + _g5_span_kernels(dev, card, "rows")


def _split_decode_cases(dev):
    """Rows 2, 2c, 2r and 2cr (the split decode body,
    ``csrc/decode_attention_split.cuh``) on extra held cases drawn from a
    generator of their own: glm4-9b's widths (H 32, Kv 2, hd 128: g 16, the
    whole query tile) over contexts up to 640; contexts of 1 slot, of one
    split (DECODE_SPLIT = 256 slots), one more, two splits and one more, at
    stablelm's widths (full cache) and at mixtral's (rolling, W 4096, rows
    of exactly W slots and wrapped rows).  Each case is one logical cache,
    paged and as rows (table width nb * bs = row width S): over rows the
    kernel must give the paged kernel's bits (one fold order).  These
    launches do not count."""
    from repro_torch.kernels._paged import DECODE_SPLIT as L
    gen = np.random.default_rng(SEED + 11)
    edges = [0, L - 1, L, 2 * L - 1, 2 * L]
    _split_pairs(gen, dev, [
        ("glm4-9b widths", 32, 2, 128, 0,
         [0, L - 1, L, 639, *(gen.integers(100, 640, 4) - 1)]),
        ("stablelm widths, split edges", 32, 32, 64, 0, edges + [63, 64, 639]),
        ("mixtral widths, split edges", 32, 8, 128, 4096,
         edges + [4095, 4096, 8999]),
    ])


def _split_pairs(gen, dev, cases):
    """Each case (label, H, Kv, hd, W or 0, decode positions) as one
    logical cache, paged and as rows: the bf16 split decode kernels held
    against their plain versions, and over rows the paged kernel's bits.
    These launches do not count."""
    import torch
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.models.attention import gather_paged_cache
    wrappers = (kda.paged_decode_attention, kda.contiguous_decode_attention,
                kda.paged_decode_attention_rolling,
                kda.contiguous_decode_attention_rolling)
    launches = [w.launches for w in wrappers]
    for label, h, kv, hd, window, pos in cases:
        pos = np.asarray(pos, np.int64)
        b = len(pos)
        if window:
            case = _rolling_case(gen, [(int(p), 1) for p in pos], window, h,
                                 kv, hd, 16, dev)
            paged, rows = wrappers[2:]
        else:
            case = _paged_case(gen, pos, np.arange(b), b, h, kv, hd, 16, dev)
            paged, rows = wrappers[:2]
        views = [gather_paged_cache(case[n], case["tables"]).contiguous()
                 for n in "kv"]
        idx = torch.arange(b, dtype=torch.int32, device=dev)
        paged_args = [case["q"], case["k"], case["v"], case["tables"],
                      case["positions"]]
        row_args = [case["q"], *views, idx, case["positions"]]
        kw = {"window": window} if window else {}
        width = case["tables"].shape[1] * 16
        text = (f"{label}: H={h} Kv={kv} hd={hd} B={b} contexts "
                f"{sorted(np.minimum(pos + 1, window or width).tolist())}"
                + (f" W={window}" if window else ""))
        _held(paged.__name__, paged,
              lambda *a, **_: kda.paged_decode_attention_plain(
                  *a, rolling_window=window), paged_args, text, **kw)
        _held(rows.__name__, rows,
              lambda *a, **_: kda.contiguous_decode_attention_plain(
                  *a, rolling_window=window), row_args, text, **kw)
        _rows_match_pages(label, paged, rows, paged_args, row_args, kw)
    for w, n in zip(wrappers, launches):
        w.launches = n


def _rows_match_pages(label, paged, rows, paged_args, row_args, kw):
    """The kernel over rows must give the paged kernel's bits on one
    logical cache (table width nb * bs = row width S): one fold order."""
    import torch
    over_pages = paged(*paged_args, **kw)
    over_rows = rows(*row_args, **kw)
    torch.cuda.synchronize()
    equal = torch.equal(over_pages, over_rows)
    print(f"kernel {rows.__name__} over rows == {paged.__name__} over "
          f"pages ({label}, S = nb * bs = {row_args[1].shape[1]}): {equal}",
          flush=True)
    if not equal:
        raise AssertionError(f"{rows.__name__} and {paged.__name__} "
                             f"differ on one logical cache")


def _quant_split_cases(dev):
    """Rows 2b, 2bc, 2br and 2bcr (the int8 split body,
    ``csrc/decode_attention_quant_split.cuh``) on extra held cases drawn
    from a generator of their own: glm4-9b's widths (H 32, Kv 2, hd 128: g
    16, the whole query tile) over contexts up to 640; contexts of 1 slot,
    of one split (DECODE_SPLIT = 512 slots), one more, two splits and one
    more at stablelm's widths (full cache), and of 1, 512 and 513 slots at
    mixtral's (rolling, W 4096, rows of exactly W slots and wrapped rows)
    and at hd 32 (H 8, Kv 4), the one head width no model here runs.
    Each case is one logical cache, paged and as rows (table width nb * bs
    = row width S), held to the int8 decode limit (the flip term
    included); over rows the kernel must give the paged kernel's bits (one
    fold order).  These launches do not count."""
    import torch
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels._paged import DECODE_SPLIT as L
    from repro_torch.models.attention import gather_paged_cache
    gen = np.random.default_rng(SEED + 14)
    wrappers = (kda.paged_decode_attention_quant,
                kda.contiguous_decode_attention_quant,
                kda.paged_decode_attention_quant_rolling,
                kda.contiguous_decode_attention_quant_rolling)
    launches = [w.launches for w in wrappers]
    edges = [0, L - 1, L]
    cases = [
        ("glm4-9b widths", 32, 2, 128, 0,
         [0, L - 1, L, 639, *(gen.integers(100, 640, 4) - 1)]),
        ("stablelm widths, split edges", 32, 32, 64, 0,
         edges + [2 * L - 1, 2 * L, 63, 64, 639]),
        ("mixtral widths, split edges", 32, 8, 128, 4096,
         edges + [4095, 4096, 8999]),
        ("hd 32, g 2", 8, 4, 32, 0, edges + [100, 777]),
    ]
    for label, h, kv, hd, window, pos in cases:
        pos = np.asarray(pos, np.int64)
        b = len(pos)
        if window:
            case = _rolling_case(gen, [(int(p), 1) for p in pos], window, h,
                                 kv, hd, 16, dev)
            paged, rows = wrappers[2:]
        else:
            case = _paged_case(gen, pos, np.arange(b), b, h, kv, hd, 16, dev)
            paged, rows = wrappers[:2]
        paged_args = _quant(case)
        views = [gather_paged_cache(c, case["tables"]).contiguous()
                 for c in paged_args[1:5]]
        idx = torch.arange(b, dtype=torch.int32, device=dev)
        row_args = [case["q"], *views, idx, case["positions"]]
        kw = {"window": window} if window else {}
        width = case["tables"].shape[1] * 16
        text = (f"{label}: H={h} Kv={kv} hd={hd} B={b} contexts "
                f"{sorted(np.minimum(pos + 1, window or width).tolist())}"
                + (f" W={window}" if window else ""))
        _held_quant_decode(paged.__name__, paged,
                           kda.paged_decode_attention_quant_plain, paged_args,
                           text, window)
        _held_quant_decode(rows.__name__, rows,
                           kda.contiguous_decode_attention_quant_plain,
                           row_args, text, window)
        _rows_match_pages(label, paged, rows, paged_args, row_args, kw)
    for w, n in zip(wrappers, launches):
        w.launches = n


def _full_span_cases(dev):
    """Rows 1 and 9 (the full-cache mode of ``csrc/span_attention_tiled.
    cuh``) and rows 7 and 10 (that of ``csrc/span_attention_quant_tiled.
    cuh``, at p-tiles of 16 and 512 slots) on extra held cases drawn from a
    generator of their own: stablelm's chunk (H = Kv = 32, hd 64; 256
    tokens over 4 rows) with its rows interleaved round robin in seq_idx,
    and glm4-9b's widths (H 32, Kv 2, hd 128: g 16, 4 tokens x 16 heads a
    query tile) over runs of 37, 64 and 29 tokens.  Each case is one
    logical cache, paged and as rows (table width nb * bs = row width S):
    each kernel is held against its plain version, and over rows the
    kernel must give the paged kernel's bits (one fold order).  These
    launches do not count."""
    import torch
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import (gather_paged_cache, kv_tile,
                                              quantize_kv)
    gen = np.random.default_rng(SEED + 13)
    paged, rows = ksa.paged_span_attention, ksa.span_attention
    qpaged, qrows = ksa.paged_span_attention_quant, ksa.span_attention_quant
    launches = [w.launches for w in (paged, rows, qpaged, qrows)]
    for label, h, kv, hd, spans, interleave in (
            ("interleaved rows", 32, 32, 64,
             [(0, 96), (200, 64), (448, 64), (120, 32)], True),
            ("glm4-9b widths", 32, 2, 128, [(0, 37), (300, 64), (575, 29)],
             False)):
        seq = np.concatenate([np.full(c, r) for r, (_, c) in enumerate(spans)])
        pos = np.concatenate([o + np.arange(c) for o, c in spans])
        if interleave:                  # round robin over the rows
            rank = np.concatenate([np.arange(c) for _, c in spans])
            idx = np.lexsort((seq, rank))
            seq, pos = seq[idx], pos[idx]
        case = _paged_case(gen, pos, seq, len(spans), h, kv, hd, 16, dev)
        views = [gather_paged_cache(case[n], case["tables"]).contiguous()
                 for n in "kv"]
        paged_args = [case["q"], case["k"], case["v"], case["tables"],
                      case["positions"], case["rows"]]
        row_args = [case["q"], *views, case["positions"], case["rows"]]
        text = (f"{label}: H={h} Kv={kv} hd={hd} T={len(pos)} runs "
                f"{[c for _, c in spans]}")
        _held(paged.__name__, paged, ksa.paged_span_attention_plain,
              paged_args, text)
        _held(rows.__name__, rows, ksa.span_attention_plain, row_args, text)
        over_pages = paged(*paged_args)
        over_rows = rows(*row_args)
        torch.cuda.synchronize()
        equal = torch.equal(over_pages, over_rows)
        print(f"kernel span_attention over rows == paged_span_attention over "
              f"pages ({label}, S = nb * bs = {views[0].shape[1]}): {equal}",
              flush=True)
        if not equal:
            raise AssertionError("rows 9 and 1 differ on one logical cache")
        # rows 7 and 10 over the same cache, quantized as the engine
        # stores it
        (k8, ks), (v8, vs) = quantize_kv(case["k"]), quantize_kv(case["v"])
        qviews = [gather_paged_cache(c, case["tables"]).contiguous()
                  for c in (k8, ks, v8, vs)]
        qpaged_args = [case["q"], k8, ks, v8, vs, case["tables"],
                       case["positions"], case["rows"]]
        qrow_args = [case["q"], *qviews, case["positions"], case["rows"]]
        for kv_block in (16, 512):
            kw = {"kv_block": kv_block}
            tag = f"{text} p-tile={kv_tile(kv_block, views[0].shape[1])}"
            _held(qpaged.__name__, qpaged, ksa.paged_span_attention_quant_plain,
                  qpaged_args, tag, **kw)
            _held(qrows.__name__, qrows, ksa.span_attention_quant_plain,
                  qrow_args, tag, **kw)
            over_pages = qpaged(*qpaged_args, **kw)
            over_rows = qrows(*qrow_args, **kw)
            torch.cuda.synchronize()
            equal = torch.equal(over_pages, over_rows)
            print(f"kernel span_attention_quant over rows == "
                  f"paged_span_attention_quant over pages ({tag}): {equal}",
                  flush=True)
            if not equal:
                raise AssertionError("rows 10 and 7 differ on one logical "
                                     "cache")
    for w, n in zip((paged, rows, qpaged, qrows), launches):
        w.launches = n


def _rows_equal_pages(gen, h, kv, hd, spans, dev):
    """Rows 11 and 12 over rows must give rows 6's and 8's bits over pages
    on one logical cache whose table width nb * bs is the row width S = W
    (each pair shares a tiled body and its tile order): the main and the
    mixed steps."""
    import torch
    from repro_torch.kernels import span_attention as ksa
    from repro_torch.models.attention import gather_paged_cache, quantize_kv
    window, bs = 4096, 16
    wrappers = (ksa.paged_span_attention_rolling, ksa.span_attention_rolling,
                ksa.paged_span_attention_rolling_quant,
                ksa.span_attention_rolling_quant)
    launches = [w.launches for w in wrappers]
    for kind, sp, pad in (("main", spans, 0),
                          ("mixed", MIXED_SPANS, MIXED_PAD)):
        case = _rolling_case(gen, sp, window, h, kv, hd, bs, dev, pad)
        assert case["tables"].shape[1] * bs == window
        rows = [gather_paged_cache(case[n], case["tables"]).contiguous()
                for n in "kv"]
        span = (case["k_span"], case["v_span"])
        idx = (case["positions"], case["rows"], case["offsets"],
               case["n_valid"])
        paged = ksa.paged_span_attention_rolling(
            case["q"], case["k"], case["v"], *span, case["tables"], *idx,
            window=window)
        contiguous = ksa.span_attention_rolling(case["q"], *rows, *span,
                                                *idx, window=window)
        torch.cuda.synchronize()
        equal = torch.equal(paged, contiguous)
        print(f"kernel span_attention_rolling over rows == "
              f"paged_span_attention_rolling over pages ({kind}, S = nb * bs "
              f"= {window}): {equal}", flush=True)
        if not equal:
            raise AssertionError("rows 11 and 6 differ on one logical cache")
        q8 = [*quantize_kv(case["k"]), *quantize_kv(case["v"])]
        rows8 = [gather_paged_cache(c, case["tables"]).contiguous()
                 for c in q8]
        paged = ksa.paged_span_attention_rolling_quant(
            case["q"], *q8, *span, case["tables"], *idx, window=window)
        contiguous = ksa.span_attention_rolling_quant(case["q"], *rows8,
                                                      *span, *idx,
                                                      window=window)
        torch.cuda.synchronize()
        equal = torch.equal(paged, contiguous)
        print(f"kernel span_attention_rolling_quant over rows == "
              f"paged_span_attention_rolling_quant over pages ({kind}, S = "
              f"nb * bs = {window}): {equal}", flush=True)
        if not equal:
            raise AssertionError("rows 12 and 8 differ on one logical cache")
    for w, n in zip(wrappers, launches):
        w.launches = n


def _engine(engine_cls, params, model, chunk, max_seq_len=640, max_batch=4,
            kv_layout="auto", cuda_graphs=None):
    """pp = 2, paged KV unless ``kv_layout`` says otherwise; ``chunk``
    tokens per iteration under the chunked policy, or None: the default
    policy, monolithic prefill.  Decode steps run as CUDA graphs (the
    default) unless ``cuda_graphs`` is False."""
    from repro_torch.core.engine import EngineConfig
    ecfg = EngineConfig(pp_degree=2, max_batch=max_batch,
                        max_seq_len=max_seq_len,
                        prefill_chunk_tokens=chunk,
                        scheduling_policy="chunked" if chunk else "auto",
                        kv_layout=kv_layout, seed=SEED,
                        cuda_graphs=cuda_graphs)
    return engine_cls(model, params, ecfg)


def _serve(engine_cls, model, params, prompts, sp, chunk, kernels,
           max_seq_len=640, max_batch=4, trace=None, kv_layout="auto",
           logits=None, cuda_graphs=None):
    """Serve ``prompts`` to the end, every launch counter set to 0 just
    before and read just after.  Returns the streams (by request), the
    engine's metrics, the wall seconds, the launches and the peak
    device memory.  ``trace``, a list, receives each iteration's members
    and spans; ``logits``, a list, each sampling step's members and
    logits (host copies).  With graphs (the default), every stage must
    hold one graph per decode shape (batch, table width) the run
    scheduled, and must have replayed; without, none; the metrics gain
    ``decode_shapes``, those shapes."""
    import torch
    gc.collect()        # the previous run's engine (its threads hold cycles)
    # a stage's graphs allocate from their own pool, which cannot take the
    # blocks the caching allocator keeps from earlier eager work
    torch.cuda.empty_cache()
    eng = _engine(engine_cls, params, model, chunk, max_seq_len, max_batch,
                  kv_layout, cuda_graphs)
    if logits is not None:
        pool = eng._pool_sample

        def record_logits(iteration, slot, seq_ids, x, sp_list):
            logits.append((list(seq_ids), np.array(x, np.float32)))
            return pool(iteration, slot, seq_ids, x, sp_list)
        eng._pool_sample = record_logits
    schedule, shapes = eng.scheduler.schedule, set()

    def record(it):
        s = schedule(it)
        if s is not None:
            if trace is not None:
                trace.append((list(s.seq_ids), s.spans))
            if not s.is_prefill and s.packed_width == 1:
                shapes.add((len(s.seq_ids), None if s.block_tables is None
                            else s.block_tables.shape[1]))
        return s
    eng.scheduler.schedule = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k, _ in kernels:
        k.launches = 0
    for p in prompts:
        eng.add_request(p, sp)
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches = {e["name"]: k.launches for k, e in kernels}
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics()
    m["decode_shapes"] = sorted(shapes, key=str)
    graphs = [x["graphs"] for x in m["stages"]]
    replays = [x["graph_replays"] for x in m["stages"]]
    if eng.cfg.cuda_graphs:
        if graphs != [len(shapes)] * len(graphs) or min(replays) <= 0:
            raise AssertionError(
                f"decode graphs per stage {graphs}, replays {replays}: "
                f"want one graph per decode shape scheduled {m['decode_shapes']}"
                " and replays on every stage")
    elif m["jit_executables"]:
        raise AssertionError(f"an eager run captured graphs: {graphs}")
    streams = [list(s.output_ids)
               for s in sorted(done, key=lambda s: s.seq_id)]
    del eng
    return streams, m, wall, launches, peak


def _report(label, prompts, run, card, n_new, must_launch,
            must_not_launch=()):
    """Print a path's metrics; fail unless every request finished with
    ``n_new`` tokens, each kernel in ``must_launch`` launched, and none in
    ``must_not_launch`` did."""
    streams, m, wall, launches, peak = run
    n_tok = [len(x) for x in streams]
    print(f"engine {label}: {len(streams)} requests, prompts "
          f"{sorted(len(p) for p in prompts)}, new tokens {n_tok}, "
          f"wall {wall:.3f}s, policy {m['policy']}, launches {launches}",
          flush=True)
    print(f"engine {label}: throughput {m['throughput_tok_s']:.2f} tok/s, "
          f"TTFT mean {m['ttft_mean_s'] * 1e3:.2f} ms p99 "
          f"{m['ttft_p99_s'] * 1e3:.2f} ms, TPOT mean "
          f"{m['tpot_mean_s'] * 1e3:.2f} ms p99 {m['tpot_p99_s'] * 1e3:.2f} "
          f"ms, peak memory {peak / 2**30:.2f} GiB, stages busy "
          f"{[round(x['busy_s'], 3) for x in m['stages']]} s on {card}",
          flush=True)
    print(f"engine {label}: {_graph_line(m)}", flush=True)
    if len(streams) != len(prompts) or any(n != n_new for n in n_tok):
        raise AssertionError(f"{label}: not every request finished with "
                             f"{n_new} tokens: {n_tok}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {label} path")
    for name in must_not_launch:
        if launches[name]:
            raise AssertionError(f"{name} launched on the {label} path")
    return launches


def _graph_line(m):
    """A run's decode graphs: per stage, the shapes scheduled, replays and
    capture ms."""
    shapes = m["decode_shapes"]
    return (f"decode graphs per stage {[x['graphs'] for x in m['stages']]} "
            f"(jit_executables {m['jit_executables']}; decode shapes "
            f"scheduled {len(shapes)}: batch sizes "
            f"{sorted({b for b, _ in shapes})} x table widths "
            f"{sorted({w for _, w in shapes}, key=str)}), replays "
            f"{[x['graph_replays'] for x in m['stages']]}, capture ms "
            f"{[round(x['graph_capture_s'] * 1e3, 1) for x in m['stages']]}")


def _twin(label, graph, eager, graph_logits, eager_logits):
    """A graph run against its eager twin (``cuda_graphs=False``) on the
    same greedy requests: the token streams, the kernel launches and the
    logits must be identical (a replay runs the eager step's kernels on
    the same values, so every replay repeats the eager step bit for bit);
    prints the graphs, the capture ms and both runs' peak memory, TTFT
    and TPOT."""
    gs, gm, gwall, gl, gpeak = graph
    es, em, ewall, el, epeak = eager
    gap, n = _logit_gap(graph_logits, eager_logits)
    print(f"engine {label} eager twin: streams identical: {gs == es}; "
          f"launches identical: {gl == el}; max |logits graph - eager| "
          f"{gap:.3e} over {n} of {len(eager_logits)} sampling steps; "
          f"{_graph_line(gm)}; peak GiB graph {gpeak / 2**30:.2f} / eager "
          f"{epeak / 2**30:.2f}; wall s {gwall:.3f} / {ewall:.3f}; TTFT "
          f"mean ms {gm['ttft_mean_s'] * 1e3:.2f} / "
          f"{em['ttft_mean_s'] * 1e3:.2f}; TPOT mean ms "
          f"{gm['tpot_mean_s'] * 1e3:.2f} / {em['tpot_mean_s'] * 1e3:.2f}",
          flush=True)
    if gs != es:
        raise AssertionError(f"{label}: graph streams differ from eager: "
                             f"{gs} {es}")
    if gl != el:
        raise AssertionError(f"{label}: graph launches differ from eager: "
                             f"{gl} {el}")
    if gap or n != len(eager_logits) or len(graph_logits) != n:
        raise AssertionError(f"{label}: graph logits differ from eager by "
                             f"{gap} (over {n} of {len(eager_logits)} steps)")


def _serving_params():
    """The serving CLI's sampling (temperature, top-k, top-p, penalties),
    32 new tokens."""
    from repro_torch.core.sampling_params import SamplingParams
    return SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          frequency_penalty=0.2, presence_penalty=0.1,
                          max_new_tokens=32)


def phase_engine(dev, gen, kernels, card):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NaivePPEngine, SiPipeEngine
    from repro_torch.core.sampling_params import SamplingParams
    from repro_torch.models.registry import ModelOptions, build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    print(f"engine: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.num_heads} Kv={cfg.num_kv_heads} hd={cfg.resolved_head_dim}"
          f" vocab={cfg.vocab_size}: init {time.monotonic() - t0:.1f}s",
          flush=True)
    prompts = [gen.integers(2, cfg.vocab_size, int(n)).tolist()
               for n in gen.integers(64, 513, 8)]
    entries = {e["name"]: e for _, e in kernels}
    paged = {}       # each path's streams, for the contiguous phase

    def serve(cls, mdl, sp, chunk, reqs=prompts, logits=None,
              cuda_graphs=None):
        return _serve(cls, mdl, params, reqs, sp, chunk, kernels,
                      logits=logits, cuda_graphs=cuda_graphs)

    def same(label, a, b):
        print(f"engine {label}: greedy SiPipe == Naive: {a == b} "
              f"({a[0][:8]}...)", flush=True)
        if a != b:
            raise AssertionError(f"{label}: greedy streams differ: {a} {b}")

    # chunked policy: greedy parity at equal composition on 2 requests,
    # then the 8-request sampled run
    greedy16 = SamplingParams(greedy=True, max_new_tokens=16)
    pair = [serve(cls, model, greedy16, 256, prompts[:2])[0]
            for cls in (SiPipeEngine, NaivePPEngine)]
    same("chunked 2-request", *pair)
    paged["chunked 2-request"] = pair[0]
    run = serve(SiPipeEngine, model, _serving_params(), 256)
    launches = _report("chunked", prompts, run, card, 32,
                       ("paged_span_attention", "paged_decode_attention"))
    paged["chunked"] = run[0]
    for name in ("paged_span_attention", "paged_decode_attention"):
        entries[name]["launches"] = launches[name]

    # (a) the default policy: monolithic prefill, no chunk budget
    greedy = SamplingParams(greedy=True, max_new_tokens=32)
    logits = ([], [])
    run = serve(SiPipeEngine, model, greedy, None, logits=logits[0])
    launches = _report("monolithic", prompts, run, card, 32,
                       ("flash_attention", "paged_decode_attention"))
    paged["monolithic"] = run[0]
    _twin("monolithic", run, serve(SiPipeEngine, model, greedy, None,
                                   logits=logits[1], cuda_graphs=False),
          *logits)
    entries["flash_attention"]["launches"] = launches["flash_attention"]
    same("monolithic", run[0], serve(NaivePPEngine, model, greedy, None)[0])

    # (b) the int8 KV cache (same weights), chunked then monolithic
    model_q = build_model(cfg, ModelOptions(kv_quant=True))
    logits = []
    run = serve(SiPipeEngine, model_q, greedy, 256, logits=logits)
    paged["int8 chunked"] = (run[0], logits)
    launches = _report("int8 chunked", prompts, run, card, 32,
                       ("paged_span_attention_quant",
                        "paged_decode_attention_quant"))
    for name in ("paged_span_attention_quant", "paged_decode_attention_quant"):
        entries[name]["launches"] = launches[name]
    chunked_q = run[0]
    same("int8 chunked", chunked_q,
         serve(NaivePPEngine, model_q, greedy, 256)[0])
    logits = []
    run = serve(SiPipeEngine, model_q, greedy, None, logits=logits)
    paged["int8 monolithic"] = (run[0], logits)
    _report("int8 monolithic", prompts, run, card, 32,
            ("flash_attention", "paged_decode_attention_quant"))
    # monolithic prefill attends full-precision K/V, chunks the int8
    # cache: the streams may part where a near-tie flips (docstring)
    mono_q = run[0]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
             for x, y in zip(mono_q, chunked_q)]
    equal = sum(a == b for x, y in zip(mono_q, chunked_q)
                for a, b in zip(x, y))
    print(f"engine int8 monolithic vs int8 chunked: "
          f"{sum(x == y for x, y in zip(mono_q, chunked_q))}/{len(prompts)}"
          f" streams identical, {equal}/{32 * len(prompts)} tokens equal, "
          f"first difference at {first}", flush=True)
    return params, prompts, paged


SERVING_DEADLINE_S = 120.0   # the online replay fails, not hangs, past it
SERVING_ROWS = ("paged_span_attention", "paged_decode_attention",
                "flash_attention")   # PERF.md rows 1, 2, 3


def _latency(m, prefix=""):
    """TTFT, TPOT and queue delay, mean and p99, of engine metrics ``m``
    (``prefix`` "offline_" reads the offline tier's)."""
    keys = (("TTFT", "ttft"), ("TPOT", "tpot")) + (
        () if prefix else (("queue", "queue"),))
    return ", ".join(
        f"{label} mean {m[f'{prefix}{k}_mean_s'] * 1e3:.2f} ms p99 "
        f"{m[f'{prefix}{k}_p99_s'] * 1e3:.2f} ms" for label, k in keys)


def phase_serving(kernels, card, params, prompts):
    """The serving front end (``repro_torch.serving`` through the
    launcher's entry points) on full-width stablelm-1.6b, with the engine
    phase's weights and prompts: (a) the launcher's HTTP smoke
    (``serve.start_smoke_server`` and ``serve._http_smoke``) against two
    warmed SiPipeEngine replicas behind the router (monolithic prefill,
    one active slot, a queue of one); (b) a non-streamed greedy completion
    of one prompt, sent alone to that server, must equal
    ``SiPipeEngine.run()`` on that prompt alone (both at batch 1:
    bit-equal); (c) an online replay (``run_online``, one engine): 16
    Poisson arrivals at 8 requests/s of 32 sampled tokens, every 5th
    aborted after its first token, 4 offline requests, 256-token chunks
    over the paged cache, under a deadline. The launch counters are set to
    0 just before and read just after each of two windows: the HTTP
    server's traffic (a and b, until its replicas have drained), where
    rows 2 and 3 must launch, and the online replay, where rows 1 and 2
    must; the replicas' warm-ups and the engine run that (b) compares
    with lie outside both. Every stage of both replicas must replay a
    decode graph, and each replica must drain to an empty ``load()``."""
    import http.client
    import threading
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineConfig, SiPipeEngine
    from repro_torch.core.sampling_params import SamplingParams
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model

    cfg = get_config("stablelm-1.6b")
    prebuilt = (cfg, build_model(cfg), params)
    t_phase = time.monotonic()

    def zero():
        gc.collect()
        torch.cuda.synchronize()
        for k, _ in kernels:
            k.launches = 0

    def window(label, need):
        launches = {e["name"]: k.launches for k, e in kernels}
        shown = {n: launches[n] for n in SERVING_ROWS}
        print(f"serving {label}: launches {shown}", flush=True)
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched in the serving "
                                     f"phase's {label}")

    # the engine alone, for (b): outside every counted window
    prompt = prompts[0]
    eng = SiPipeEngine(prebuilt[1], params, EngineConfig(
        pp_degree=2, max_batch=4, max_seq_len=640, seed=SEED))
    eng.add_request(prompt, SamplingParams(greedy=True, max_new_tokens=32))
    alone = list(eng.run()[0].output_ids)
    del eng

    # (a) + (b): two replicas behind the router, warmed before the window
    server, gate = serve.start_smoke_server(
        cfg.name, replicas=2, max_seq_len=640, chunk_tokens=0, seed=SEED,
        prebuilt=prebuilt)
    zero()
    host, port = server.address
    t0 = time.monotonic()
    serve._http_smoke(host, port, gate)
    smoke_s = time.monotonic() - t0
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": prompt, "max_tokens": 32, "temperature": 0.0}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"greedy completion: HTTP {resp.status} {body}")
    over_http = body["choices"][0]["token_ids"]
    rejected = server.admission.snapshot()["admission_rejected_total"]
    replicas = server.router.replicas
    routed = dict(server.router.routed)
    server.close()                  # drains every replica, then stops it
    print(f"serving: HTTP smoke OK on {len(replicas)} warmed replicas in "
          f"{smoke_s:.3f}s (SSE chunks and [DONE], a /v1/batches job under "
          f"the held slot, 429 with Retry-After, /metrics); 429s "
          f"{rejected}; routed {routed}", flush=True)
    window("HTTP server (smoke and greedy, warm-ups excluded)",
           ("paged_decode_attention", "flash_attention"))
    for rep in replicas:
        m, load = rep.engine.metrics(), rep.engine.load()
        replays = [x["graph_replays"] for x in m["stages"]]
        print(f"serving replica {rep.name}: {m['requests_finished']} "
              f"finished, {_latency(m)}; offline "
              f"{m['offline_requests_seen']} seen, {_latency(m, 'offline_')}"
              f", slack tokens sold {m['slack_tokens_sold']}; decode graphs "
              f"per stage {[x['graphs'] for x in m['stages']]}, replays "
              f"{replays}; load after the drain {load}", flush=True)
        if rep.error is not None:
            raise AssertionError(f"replica {rep.name} failed: {rep.error!r}")
        if min(replays) <= 0:
            raise AssertionError(f"replica {rep.name}: a stage replayed no "
                                 f"decode graph: {replays}")
        if load["active_requests"] or \
                load["kv_blocks_free"] != load["kv_blocks_total"]:
            raise AssertionError(f"replica {rep.name} did not drain: {load}")
    del replicas, server
    print(f"serving: greedy over HTTP == SiPipeEngine alone: "
          f"{over_http == alone} ({len(over_http)} tokens after a "
          f"{len(prompt)}-token prompt: {over_http[:8]}...)", flush=True)
    if over_http != alone:
        raise AssertionError(f"greedy over HTTP {over_http} differs from "
                             f"the engine's {alone}")

    # (c) the online replay, on its own thread so that a stall fails the
    # phase at the deadline instead of hanging the script
    result = {}

    def replay():
        try:
            result["m"] = serve.run_online(
                cfg.name, requests=16, max_new_tokens=32, max_seq_len=640,
                chunk_tokens=256, policy="chunked", kv_layout="paged",
                arrival_rate=8.0, abort_every=5, offline_requests=4,
                seed=SEED, verbose=False, prebuilt=prebuilt)
        except BaseException as e:          # noqa: BLE001 — re-raised below
            result["error"] = e

    zero()
    t0 = time.monotonic()
    worker = threading.Thread(target=replay, name="online-replay",
                              daemon=True)
    worker.start()
    worker.join(SERVING_DEADLINE_S)
    if worker.is_alive():
        raise AssertionError(f"the online replay did not finish within "
                             f"{SERVING_DEADLINE_S:.0f}s")
    if "error" in result:
        raise result["error"]
    m = result["m"]
    print(f"serving online: {m['finished'] + m['aborted']} requests at "
          f"{m['arrival_rate_rps']} rps in "
          f"{time.monotonic() - t0:.3f}s: {m['finished']} finished, "
          f"{m['aborted']} aborted, offline {m['offline_finished']}/"
          f"{m['offline_submitted']} finished "
          f"({m['offline_streamed_tokens']} tokens), "
          f"{m['streamed_tokens']} online tokens; {_latency(m)}; offline "
          f"{_latency(m, 'offline_')}, slack tokens sold "
          f"{m['slack_tokens_sold']} of {m['slack_seats_seen']} seats, "
          f"offline preemptions {m['offline_preemptions']}; throughput "
          f"{m['throughput_tok_s']:.2f} tok/s; decode graphs per stage "
          f"{[x['graphs'] for x in m['stages']]}, replays "
          f"{[x['graph_replays'] for x in m['stages']]}", flush=True)
    window("online replay", ("paged_span_attention",
                             "paged_decode_attention"))
    print(f"serving: phase {time.monotonic() - t_phase:.1f}s on {card}",
          flush=True)


def phase_mixtral(dev, kernels, card):
    """mixtral-8x7b at its published widths (8 experts top-2, W = 4096),
    cut to the depth one card holds, through SiPipeEngine (pp = 2, paged rolling
    KV): 8 requests, two of them longer than the window, under the
    chunked policy and monolithic prefill, in bf16 and with the int8
    cache."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.mixtral_8x7b import ONE_CARD_LAYERS
    from repro_torch.models.registry import ModelOptions, build_model

    gen = np.random.default_rng(SEED + 3)
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=ONE_CARD_LAYERS)
    model = build_model(cfg)
    gc.collect()        # the stablelm phase's engines and weights
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    print(f"engine: {cfg.name} L={cfg.num_layers} of {full.num_layers} "
          f"(one 80 GB card: {full.num_layers} layers are ~93 GB of bf16 "
          f"weights) d={cfg.d_model} H={cfg.num_heads} Kv={cfg.num_kv_heads}"
          f" hd={cfg.resolved_head_dim} experts={cfg.moe.num_experts} "
          f"top-{cfg.moe.top_k} d_ff={cfg.moe.expert_d_ff} W={cfg.window} "
          f"vocab={cfg.vocab_size}: init {time.monotonic() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    lens = np.concatenate([gen.integers(64, 513, 6),
                           gen.integers(4200, 4801, 2)])
    lens = lens[gen.permutation(8)]
    prompts = [gen.integers(2, cfg.vocab_size, int(n)).tolist() for n in lens]
    pair = [prompts[int(np.argmin(lens))], prompts[int(np.argmax(lens))]]
    paged = {}       # each path's streams, for the contiguous phase
    for label, opts, chunk, names in (
            ("mixtral chunked", ModelOptions(), 256,
             ("paged_span_attention_rolling",
              "paged_decode_attention_rolling")),
            ("mixtral monolithic", ModelOptions(), None,
             ("flash_attention_windowed", "paged_decode_attention_rolling")),
            ("mixtral int8 chunked", ModelOptions(kv_quant=True), 256,
             ("paged_span_attention_rolling_quant",
              "paged_decode_attention_quant_rolling")),
            ("mixtral int8 monolithic", ModelOptions(kv_quant=True), None,
             ("flash_attention_windowed",
              "paged_decode_attention_quant_rolling"))):
        paged[label] = _model_path(label, build_model(cfg, opts), params,
                                   prompts, pair, chunk, names, kernels, card,
                                   max_seq_len=5120,
                                   twin=label == "mixtral int8 monolithic")
    return cfg, params, prompts, pair, paged


def _model_path(label, model, params, prompts, pair, chunk, names, kernels,
                card, max_seq_len=640, kv_layout="auto", must_not_launch=(),
                twin=False, entry_suffix=""):
    """One engine path of a model: 8 greedy requests through SiPipeEngine
    (every one must finish with 32 tokens, ``names`` must launch and
    ``must_not_launch`` must not, every stage must replay its decode
    graphs, and a paged cache must end with every block free), then
    ``pair`` with one request per microbatch, so that each step's
    composition (which an MoE's capacity and the bucket padding see)
    cannot depend on the overlapped engine's timing: SiPipe's schedule and
    greedy streams must equal NaivePPEngine's; with ``twin``, SiPipe's
    pair run is checked against its eager twin too.  The 8-request run's
    launches fill in the kernels-line entries ``name + entry_suffix`` that
    no earlier path filled.  Returns the 8 streams, the pair's streams,
    the Naive pair run's logits and the 8-request run's metrics."""
    from repro_torch.core.engine import NaivePPEngine, SiPipeEngine
    from repro_torch.core.sampling_params import SamplingParams
    entries = {e["name"]: e for _, e in kernels}
    greedy = SamplingParams(greedy=True, max_new_tokens=32)
    greedy16 = SamplingParams(greedy=True, max_new_tokens=16)
    run = _serve(SiPipeEngine, model, params, prompts, greedy, chunk,
                 kernels, max_seq_len=max_seq_len, kv_layout=kv_layout)
    launches = _report(label, prompts, run, card, 32, names, must_not_launch)
    m = run[1]
    if m.get("kv_blocks_free", 0) != m.get("kv_blocks_total", 0):  # paged
        raise AssertionError(f"{label}: {m['kv_blocks_free']} of "
                             f"{m['kv_blocks_total']} KV blocks free at "
                             f"the end")
    for name in names:           # each entry: the first path that runs it
        if not entries[name + entry_suffix]["launches"]:
            entries[name + entry_suffix]["launches"] = launches[name]
    traces, logits, sipipe_logits = ([], []), [], []

    def pair_run(cls, trace=None, lg=None, cuda_graphs=None):
        return _serve(cls, model, params, pair, greedy16, chunk, kernels,
                      max_seq_len=max_seq_len, max_batch=1, trace=trace,
                      kv_layout=kv_layout, logits=lg, cuda_graphs=cuda_graphs)
    runs = [pair_run(cls, tr, lg) for cls, tr, lg in zip(
        (SiPipeEngine, NaivePPEngine), traces, (sipipe_logits, logits))]
    a, b = runs[0][0], runs[1][0]
    print(f"engine {label} 2-request (prompts {len(pair[0])}, "
          f"{len(pair[1])}, one per microbatch): schedules equal: "
          f"{traces[0] == traces[1]}; greedy SiPipe == Naive: {a == b} "
          f"({a[1][:8]}...)", flush=True)
    if traces[0] != traces[1]:
        raise AssertionError(f"{label}: schedules differ: {traces}")
    if a != b:
        raise AssertionError(f"{label}: greedy streams differ: {a} {b}")
    if twin:
        eager_logits = []
        _twin(f"{label} 2-request", runs[0],
              pair_run(SiPipeEngine, lg=eager_logits, cuda_graphs=False),
              sipipe_logits, eager_logits)
    return dict(streams=run[0], pair=a, logits=logits, metrics=m)


# The configs phase: each architecture and its paths (label, int8 cache,
# chunk tokens or None for monolithic prefill, the rows that must launch)
_PATHS = (("chunked", False, 256,
           ("paged_span_attention", "paged_decode_attention")),
          ("monolithic", False, None,
           ("flash_attention", "paged_decode_attention")),
          ("int8 chunked", True, 256,
           ("paged_span_attention_quant", "paged_decode_attention_quant")),
          ("int8 monolithic", True, None,
           ("flash_attention", "paged_decode_attention_quant")))
CONFIG_PATHS = (("llama4-maverick-400b-a17b", _PATHS), ("glm4-9b", _PATHS),
                ("codeqwen1.5-7b", _PATHS[:1]), ("minicpm-2b", _PATHS[1:2]))


def phase_configs(dev, kernels, card):
    """The architectures the engine serves beside stablelm and mixtral,
    each built on the card from SEED one at a time and freed before the
    next: llama4-maverick-400b-a17b first, the largest (~65 GiB), at its
    published widths (128 experts top-1 and a shared expert; H 40 over Kv
    8: g 5) cut to ``ONE_CARD_LAYERS`` of its 48 layers, then glm4-9b (Kv
    2: g 16), codeqwen1.5-7b and minicpm-2b at full depth.  Each path as
    :func:`_model_path` (8 greedy requests of 64-512 prompt tokens, then
    SiPipe == Naive on a 2-request pair); llama4's launches fill in the g 5
    entries.  llama4 also serves monolithic prefill in bf16 with its shared
    expert fused into the MoE sum (``fuse_shared_expert``): the same
    operations as the separate branch (tests/test_torch_configs.py holds
    the two bit-equal in bf16), so its pair streams must equal that
    path's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.llama4_maverick_400b_a17b import ONE_CARD_LAYERS
    from repro_torch.models.registry import ModelOptions, build_model
    gen = np.random.default_rng(SEED + 5)
    for arch, paths in CONFIG_PATHS:
        t_arch = time.monotonic()
        gc.collect()             # the previous model's engines and weights
        # PyTorch keeps a cuBLAS workspace for every stream that ran a
        # product, and each engine's stages run on streams of their own
        getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
        torch.cuda.empty_cache()
        full = get_config(arch)
        llama4 = arch.startswith("llama4")
        cfg = (dataclasses.replace(full, num_layers=ONE_CARD_LAYERS)
               if llama4 else full)
        print(f"configs: {arch}: {torch.cuda.memory_allocated() / 2**30:.2f}"
              f" GiB allocated before the build", flush=True)
        model = build_model(cfg)
        t0 = time.monotonic()
        params = model.init(SEED, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()         # the init's fp32 draws
        g = cfg.num_heads // cfg.num_kv_heads
        moe = ("" if cfg.moe is None else
               f" experts={cfg.moe.num_experts} top-{cfg.moe.top_k} "
               f"shared={cfg.moe.shared} every={cfg.moe.every} "
               f"expert_d_ff={cfg.moe.expert_d_ff}")
        print(f"engine: {cfg.name} L={cfg.num_layers} of {full.num_layers} "
              f"d={cfg.d_model} H={cfg.num_heads} Kv={cfg.num_kv_heads} "
              f"(g {g}) hd={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size}{moe}: init "
              f"{time.monotonic() - t0:.1f}s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"on {card}", flush=True)
        prompts = [gen.integers(2, cfg.vocab_size, int(n)).tolist()
                   for n in gen.integers(64, 513, 8)]
        pair = prompts[:2]
        suffix = "_g5" if g == 5 else ""
        runs = [(label, ModelOptions(kv_quant=quant), chunk, names)
                for label, quant, chunk, names in paths]
        if llama4:
            runs.append(("monolithic fused shared expert",
                         ModelOptions(fuse_shared_expert=True), None,
                         _PATHS[1][3]))
        pairs = {}
        for label, opts, chunk, names in runs:
            t0 = time.monotonic()
            pairs[label] = _model_path(
                f"{arch} {label}", build_model(cfg, opts), params, prompts,
                pair, chunk, names, kernels, card,
                entry_suffix=suffix)["pair"]
            print(f"configs: {arch} {label}: {time.monotonic() - t0:.1f}s",
                  flush=True)
        if llama4:
            same = (pairs["monolithic fused shared expert"]
                    == pairs["monolithic"])
            print(f"configs: {arch}: fused shared expert pair streams == the "
                  f"separate branch's: {same}", flush=True)
            if not same:
                raise AssertionError(f"{arch}: the fused shared expert's "
                                     f"streams differ from the separate "
                                     f"branch's")
        del params, model
        print(f"configs: {arch}: {time.monotonic() - t_arch:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def _logit_gap(a, b):
    """(max |logits a - logits b|, steps compared) over the sampling steps
    two runs share, in order (same members), up to and including the
    first step whose greedy tokens differ."""
    worst, n = 0.0, 0
    for (ia, xa), (ib, xb) in zip(a, b):
        if ia != ib or xa.shape != xb.shape:
            break
        worst, n = max(worst, float(np.abs(xa - xb).max())), n + 1
        if (xa.argmax(-1) != xb.argmax(-1)).any():
            break
    return worst, n


def _layouts(label, contiguous, paged, exact, logits=None):
    """Print how a contiguous path's greedy streams compare with the paged
    path's from this run (and, given both runs' logits, their largest
    difference); with ``exact``, fail unless they are equal."""
    equal = sum(x == y for x, y in zip(contiguous, paged))
    line = (f"engine {label}: contiguous == paged: {contiguous == paged} "
            f"({equal}/{len(paged)} streams identical)")
    if logits is not None:
        gap, n = _logit_gap(*logits)
        line += f"; max |logits contiguous - paged| {gap:.3e} over {n} steps"
    print(line, flush=True)
    if exact and contiguous != paged:
        raise AssertionError(f"{label}: contiguous streams differ from the "
                             f"paged ones: {contiguous} {paged}")


def phase_contiguous_dense(kernels, card, params, prompts, paged):
    """stablelm-1.6b (the engine phase's weights and prompts) over
    contiguous rows (8 rows of 640 slots) on the engine phase's four
    paths: SiPipe's greedy schedules and streams must equal Naive's, every
    request must finish, the contiguous kernels must launch and the paged
    ones must not; the bf16 greedy streams must equal the paged paths'
    (the kernels share their bodies), the int8 ones are compared."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NaivePPEngine, SiPipeEngine
    from repro_torch.core.sampling_params import SamplingParams
    from repro_torch.models.registry import ModelOptions, build_model

    cfg = get_config("stablelm-1.6b")
    entries = {e["name"]: e for _, e in kernels}
    not_paged = [n for n in entries if n.startswith("paged_")]
    greedy = SamplingParams(greedy=True, max_new_tokens=32)

    def serve(cls, mdl, sp, chunk, reqs=prompts, **kw):
        return _serve(cls, mdl, params, reqs, sp, chunk, kernels,
                      kv_layout="contiguous", **kw)

    twin = "contiguous int8 monolithic"     # checked against eager steps

    def parity(label, mdl, sp, chunk, reqs, names=None):
        """SiPipe then Naive, greedy: equal schedules and streams; SiPipe's
        run is reported (``names`` must launch); returns it and its
        logits."""
        traces, logits = ([], []), []
        runs = [serve(cls, mdl, sp, chunk, reqs, trace=tr, logits=lg)
                for cls, tr, lg in zip((SiPipeEngine, NaivePPEngine), traces,
                                       (logits, None))]
        if names is not None:
            launches = _report(label, reqs, runs[0], card, sp.max_new_tokens,
                               names, not_paged)
            for name in names:
                if not entries[name]["launches"]:
                    entries[name]["launches"] = launches[name]
        a, b = runs[0][0], runs[1][0]
        print(f"engine {label}: schedules equal: {traces[0] == traces[1]}; "
              f"greedy SiPipe == Naive: {a == b} ({a[0][:8]}...)", flush=True)
        if traces[0] != traces[1]:
            raise AssertionError(f"{label}: schedules differ: {traces}")
        if a != b:
            raise AssertionError(f"{label}: greedy streams differ: {a} {b}")
        if label == twin:
            eager_logits = []
            _twin(label, runs[0], serve(SiPipeEngine, mdl, sp, chunk, reqs,
                                        logits=eager_logits,
                                        cuda_graphs=False),
                  logits, eager_logits)
        return runs[0], logits

    greedy16 = SamplingParams(greedy=True, max_new_tokens=16)
    run, _ = parity("contiguous chunked 2-request", build_model(cfg),
                    greedy16, 256, prompts[:2])
    _layouts("contiguous chunked 2-request", run[0],
             paged["chunked 2-request"], exact=True)
    model = build_model(cfg)
    run = serve(SiPipeEngine, model, _serving_params(), 256)
    names = ("span_attention", "contiguous_decode_attention")
    launches = _report("contiguous chunked", prompts, run, card, 32, names,
                       not_paged)
    for name in names:
        entries[name]["launches"] = launches[name]
    # sampled: the same draws wherever the logits are the same
    _layouts("contiguous chunked (sampled)", run[0], paged["chunked"],
             exact=False)
    run, _ = parity("contiguous monolithic", model, greedy, None, prompts,
                    ("flash_attention", "contiguous_decode_attention"))
    _layouts("contiguous monolithic", run[0], paged["monolithic"],
             exact=True)
    # int8: the span's p-tile is 640 rows' (kv_block 512 halved to 128)
    # here and the table width's there, so the two layouts' chunk steps
    # are different functions wherever the tiles differ
    model_q = build_model(cfg, ModelOptions(kv_quant=True))
    for label, chunk, names in (
            ("contiguous int8 chunked", 256,
             ("span_attention_quant", "contiguous_decode_attention_quant")),
            ("contiguous int8 monolithic", None,
             ("flash_attention", "contiguous_decode_attention_quant"))):
        run, logits = parity(label, model_q, greedy, chunk, prompts, names)
        streams, paged_logits = paged[label.replace("contiguous ", "")]
        _layouts(label, run[0], streams, exact=False,
                 logits=(logits, paged_logits))


def phase_contiguous_mixtral(kernels, card, cfg, params, prompts, pair, paged):
    """mixtral-8x7b (the mixtral phase's weights, prompts and pair) over
    contiguous rolling rows, each exactly W = 4096 slots wide, 8 rows:
    chunked and monolithic in bf16, chunked in int8, each as the mixtral
    phase's paths; the bf16 pair's greedy streams must equal the paged
    pair's, the int8 ones are compared."""
    from repro_torch.models.registry import ModelOptions, build_model
    not_paged = [e["name"] for _, e in kernels
                 if e["name"].startswith("paged_")]
    for label, opts, chunk, names in (
            ("mixtral chunked", ModelOptions(), 256,
             ("span_attention_rolling",
              "contiguous_decode_attention_rolling")),
            ("mixtral monolithic", ModelOptions(), None,
             ("flash_attention_windowed",
              "contiguous_decode_attention_rolling")),
            ("mixtral int8 chunked", ModelOptions(kv_quant=True), 256,
             ("span_attention_rolling_quant",
              "contiguous_decode_attention_quant_rolling"))):
        got = _model_path(f"contiguous {label}", build_model(cfg, opts),
                          params, prompts, pair, chunk, names, kernels, card,
                          max_seq_len=5120, kv_layout="contiguous",
                          must_not_launch=not_paged,
                          twin=label == "mixtral monolithic")
        quant = opts.kv_quant
        _layouts(f"contiguous {label} 2-request", got["pair"],
                 paged[label]["pair"], exact=not quant,
                 logits=(got["logits"], paged[label]["logits"]))
        # 8 requests share microbatches: MoE capacity sees a composition
        # the overlapped engine's timing may change, so compared only
        _layouts(f"contiguous {label}", got["streams"],
                 paged[label]["streams"], exact=False)


def _smoke_logits(model, params, d, first, toks, padded):
    """A smoke model's steps on device ``d``: a chunk step (a windowed
    model: two, the second wrapping its W = 32 rolling cache) or a prefill
    step written into the paged cache, then a decode step; returns every
    step's logits."""
    import torch
    from repro_torch.core.engine import split_for_pp, write_prefill
    from repro_torch.models.stacked import tree_map
    cfg = model.cfg
    stage = split_for_pp(model, tree_map(lambda x: x.to(d), params), 1)[0]
    cache = model.paged_cache(cfg.num_layers, 9, 16, device=d)
    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=d)
    tables = t([[0, 1], [2, 3]] if cfg.window else [[0, 1, 2, 8], [3, 4, 8, 8]])
    outs = []
    if first == "prefill":
        out, fresh = stage.prefill_fn(stage.params, t(padded), 0, t([39, 22]))
        write_prefill(cache, fresh, tables, 8)
        outs.append(out)
        lens = [40, 23]
    else:
        # (row 0, row 1) span lengths per chunk step; a window keeps each
        # row's span within W
        steps = [(30, 20), (16, 10)] if cfg.window else [(40, 20)]
        done = [0, 0]
        for n0, n1 in steps:
            pos = np.concatenate([done[0] + np.arange(n0),
                                  done[1] + np.arange(n1)])
            seq = np.repeat([0, 1], [n0, n1])
            outs.append(stage.chunk_fn(
                stage.params, cache, t(toks[:n0 + n1]), t(pos), t(seq),
                t([n0 - 1, n0 + n1 - 1]), tables, span_starts=t(done),
                n_valid=n0 + n1))
            done = [done[0] + n0, done[1] + n1]
        lens = done
    outs.append(stage.decode_fn(stage.params, cache, t([5, 7]), t(lens),
                                tables))
    return torch.cat(outs).float().cpu()


def phase_reference(dev):
    """Smoke-size models, same weights on the card (CUDA kernels) and on
    the CPU (plain versions): a chunk step then a decode step over a bf16
    cache, and a prefill step (written into the paged cache) then a
    decode step over a bf16 and over an int8 cache; stablelm-1.6b-smoke
    over a full cache and mixtral-8x7b-smoke (MoE) over a rolling one."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import ModelOptions, build_model
    import torch

    for arch in ("stablelm-1.6b-smoke", "mixtral-8x7b-smoke"):
        cfg = get_config(arch)
        params = build_model(cfg).init(SEED, device="cpu")
        toks = np.random.default_rng(SEED).integers(2, cfg.vocab_size, 60)
        padded = np.zeros((2, 40), np.int64)      # right-padded prompts
        padded[0], padded[1, :23] = toks[:40], toks[37:]
        for label, quant, first in (("chunk+decode bf16", False, "chunk"),
                                    ("prefill+decode bf16", False, "prefill"),
                                    ("prefill+decode int8", True, "prefill"),
                                    ("chunk+decode int8", True, "chunk")):
            model = build_model(cfg, ModelOptions(kv_quant=quant))
            a, b = (_smoke_logits(model, params, d, first, toks, padded)
                    for d in ("cpu", dev))
            err = float((a - b).abs().max())
            print(f"reference {arch} {label}: logits card vs CPU "
                  f"max_abs_err={err:.3e} (tol {LOGIT_TOL}), shape "
                  f"{tuple(b.shape)}", flush=True)
            if not bool(torch.isfinite(b).all()) or not err <= LOGIT_TOL:
                raise AssertionError(f"{arch} {label}: logits on the card "
                                     f"disagree with the CPU")


def _whisper_kernel(dev, card):
    """The non-causal flash kernel at whisper-small's shapes (H = Kv = 12,
    hd 64): the encoder (B 4, Sq = Skv = 1500) and the cross prefill (B 4,
    Sq 4, Skv 1500), then GQA g = 4 at hd 128 over Skv = 1000 (no tile
    multiple), each held against its plain version in fp32; timed on the
    device at the encoder's shape beside SDPA without a mask (a
    yardstick)."""
    import functools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    gen = np.random.default_rng(SEED + 2)
    plain = functools.partial(kfa.flash_attention_plain, causal=False)
    kernel = kfa.flash_attention_noncausal
    entry = None
    for b, sq, skv, h, kv, hd in ((4, 1500, 1500, 12, 12, 64),
                                  (4, 4, 1500, 12, 12, 64),
                                  (2, 100, 1000, 8, 2, 128)):
        q, k, v = (torch.tensor(gen.standard_normal((b, n, m, hd),
                                                    np.float32),
                                device=dev).to(torch.bfloat16)
                   for n, m in ((sq, h), (skv, kv), (skv, kv)))
        args = [q, k, v]
        err = _held("flash_attention_noncausal", kernel, plain, args,
                    f"B={b} Sq={sq} Skv={skv} H={h} Kv={kv} hd={hd}")
        if entry is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            continue
        plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, call_ms, lib_ms = _tiled_times(
            kernel, lambda: kernel(*args),
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        entry = _entry("flash_attention_noncausal",
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:80 "
                       "(causal=False)", err, ms, plain_ms,
                       _flash_bound(b, sq, skv, h, kv, hd, sq * skv,
                                    causal=False), lib_ms, card, call_ms)
    return kernel, entry


def _whisper_setup(cfg, dev, gen, b=4, n_prompt=4):
    """A whisper model with seeded weights and its cross-attention gates
    set to 1.0 (tanh ~ 0.76; the init's zeros would hide the encoder:
    with a zero gate the logits do not depend on the frames), frames of
    the stub frontend (scale 0.02) and prompt tokens."""
    import torch
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    params["stacks"]["decoder"]["cross"]["gate"].fill_(1.0)
    frames = torch.tensor(gen.standard_normal((b, model.enc_len,
                                               cfg.d_model), np.float32)
                          * 0.02, device=dev).to(torch.bfloat16)
    prompt = torch.tensor(gen.integers(2, cfg.vocab_size, (b, n_prompt)),
                          device=dev)
    return model, params, frames, prompt


def _whisper_greedy(model, params, frames, prompt, n_steps, tokens=None):
    """Prefill, then ``n_steps`` greedy decode steps over a cache of prompt
    + n_steps slots (``tokens``, [B, n_steps], feeds fixed tokens instead).
    Returns every step's logits, the decode steps' tokens [B, n_steps],
    and the prefill and decode seconds."""
    import torch
    b, s = prompt.shape
    dev = frames.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.monotonic()
    logits, fresh = model.prefill(params, {"frames": frames,
                                           "tokens": prompt})
    cache = model.init_cache(b, s + n_steps, device=dev, dtype=frames.dtype,
                             fill=fresh)
    del fresh
    sync()
    t1 = time.monotonic()
    steps, out = [logits], []
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(n_steps):
        if tokens is not None:
            tok = tokens[:, i]
        lg, cache = model.decode(params, cache, {
            "token": tok, "positions": torch.full((b,), s + i,
                                                  dtype=torch.int32,
                                                  device=dev)})
        steps.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
    sync()
    t2 = time.monotonic()
    return (torch.stack(steps).float().cpu(),
            torch.stack(out, 1).cpu().tolist(), t1 - t0, t2 - t1)


def phase_whisper(dev, kernels, card):
    """whisper-small (audio encoder-decoder) through the port's model API:
    the non-causal flash kernel's check; then at full width, B = 4 rows
    of 1500 frames and a 4-token prompt, prefill and 32 greedy decode
    steps, every launch counter set to 0 just before and read just after:
    every logit finite, 32 tokens a row, the causal and non-causal flash
    kernels and the contiguous decode kernel launched, a second run the
    same tokens and logits, other frames other prefill logits; then
    whisper-small-smoke (enc_len 1500, hd 16) on the card against the
    CPU, prefill and 4 decode steps on fixed tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.stacked import tree_map

    kernel, entry = _whisper_kernel(dev, card)
    kernels.append((kernel, entry))
    cfg = get_config("whisper-small")
    gen = np.random.default_rng(SEED + 3)
    t0 = time.monotonic()
    model, params, frames, prompt = _whisper_setup(cfg, dev, gen)
    torch.cuda.synchronize()
    print(f"whisper: {cfg.name} enc L={cfg.encoder_layers} dec "
          f"L={cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
          f"Kv={cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
          f"vocab={cfg.vocab_size} enc_len={model.enc_len}: init "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    n_steps = 32
    path = (kfa.flash_attention, kfa.flash_attention_noncausal,
            kda.contiguous_decode_attention)
    counters = {k for k, _ in kernels} | set(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    logits, stream, pre_s, dec_s = _whisper_greedy(model, params, frames,
                                                   prompt, n_steps)
    launches = {k.__name__: k.launches for k in path}
    entry["launches"] = launches["flash_attention_noncausal"]
    peak = torch.cuda.max_memory_allocated()
    b = len(stream)
    print(f"whisper greedy: {b} rows, new tokens {[len(x) for x in stream]}"
          f", launches {launches}, first row {stream[0][:8]}...", flush=True)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("whisper: a logit is not finite")
    if any(len(x) != n_steps for x in stream):
        raise AssertionError(f"whisper: not every row has {n_steps} tokens")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the whisper path")
    again = _whisper_greedy(model, params, frames, prompt, n_steps)
    print(f"whisper greedy: a second run gives the same tokens: "
          f"{again[1] == stream}, the same logits: "
          f"{torch.equal(again[0], logits)}", flush=True)
    if again[1] != stream or not torch.equal(again[0], logits):
        raise AssertionError("whisper: two identical runs differ")
    other = torch.tensor(gen.standard_normal(tuple(frames.shape), np.float32)
                         * 0.02, device=dev).to(torch.bfloat16)
    moved = float((model.prefill(params, {"frames": other,
                                          "tokens": prompt})[0].float().cpu()
                   - logits[0]).abs().max())
    # the frames (scale 0.02) ride on sinusoids of scale 1, so they move
    # the logits little; the same frames repeat them bit for bit (above)
    print(f"whisper: other frames move the prefill logits by up to "
          f"{moved:.4f}", flush=True)
    if not moved > 0:
        raise AssertionError("whisper: the frames do not reach the logits")
    enc_ms = _time_ms(lambda: model.encode(params, frames), reps=5)
    for label, p_s, d_s in (("first run", pre_s, dec_s),
                            ("second run", *again[2:])):
        print(f"whisper {label}: encoder {enc_ms:.3f} ms, prefill "
              f"{p_s * 1e3:.3f} ms, decode step {d_s / n_steps * 1e3:.3f} "
              f"ms, {b * n_steps / (p_s + d_s):.2f} tok/s (B = {b}, "
              f"{n_steps} steps), peak memory {peak / 2**30:.2f} GiB on "
              f"{card}", flush=True)
    del model, params, frames, other, again
    gc.collect()
    torch.cuda.empty_cache()

    # the smoke config on the card against the CPU, on fixed tokens
    cfg = get_config("whisper-small-smoke")
    gen = np.random.default_rng(SEED + 4)
    model, params, frames, prompt = _whisper_setup(cfg, "cpu", gen, b=2)
    tokens = torch.tensor(gen.integers(2, cfg.vocab_size, (2, 4)),
                          dtype=torch.int32)
    a, _, _, _ = _whisper_greedy(model, params, frames, prompt, 4, tokens)
    to_dev = lambda x: x.to(dev)
    c, _, _, _ = _whisper_greedy(model, tree_map(to_dev, params),
                                 to_dev(frames), to_dev(prompt), 4,
                                 to_dev(tokens))
    err = float((a - c).abs().max())
    print(f"whisper {cfg.name} prefill+4 decode steps: logits card vs CPU "
          f"max_abs_err={err:.3e} (tol {LOGIT_TOL}), shape "
          f"{tuple(c.shape)}", flush=True)
    if not bool(torch.isfinite(c).all()) or not err <= LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: logits on the card disagree with "
                             f"the CPU")


# recurrentgemma-9b's attention widths: H 16 over Kv 1 (g 16), hd 256, and
# its local-attention window
RG = (16, 1, 256)
RG_WINDOW = 2048


def _families_kernels(dev, card):
    """Rows 3w and 2cr at recurrentgemma-9b's widths (H 16, Kv 1, hd 256,
    W 2048; both bodies keep Q in shared memory at hd 256): the flash
    kernel's window band over one 2300-token prompt (the families phase's
    longest), then at S 65 and at W 64 over 397 positions, and the
    non-causal form at hd 256; the contiguous rolling decode kernel over
    the phase's 4 rows (contexts 64-2300) and at W 64; each held against
    its plain version in fp32 and timed on the device beside its bound and
    SDPA with ``enable_gqa`` (a yardstick): the kernels line's
    ``flash_attention_windowed_hd256`` and
    ``contiguous_decode_attention_rolling_hd256``.  Then the four bf16
    decode modes at hd 256 on the split edges, paged and as rows (rows ==
    pages bit for bit), and the ptxas lines of the hd-256 kernels.  These
    launches do not count."""
    import functools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels._paged import DECODE_SPLIT as L
    from repro_torch.launch.kernel_report import ptxas_lines
    h, kv, hd = RG
    gen = np.random.default_rng(SEED + 15)
    results = []

    entry = None
    for b, s, window in ((1, 2300, RG_WINDOW), (2, 65, RG_WINDOW),
                         (2, 397, 64)):
        q, k, v = (torch.tensor(gen.standard_normal((b, s, n, hd), np.float32),
                                device=dev).to(torch.bfloat16)
                   for n in (h, kv, kv))
        args = [q, k, v, torch.arange(s, dtype=torch.int32, device=dev)]
        kw = {"window": window, "kv_block": min(512, window)}
        err = _held("flash_attention_windowed_hd256", kfa.flash_attention,
                    kfa.flash_attention_plain, args,
                    f"B={b} S={s} W={window} H={h} Kv={kv} hd={hd}", **kw)
        if entry is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            continue
        plain_ms = _time_ms(lambda: kfa.flash_attention_plain(*args, **kw),
                            reps=3, warmup=1)
        i = torch.arange(s, device=dev)
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, call_ms, lib_ms = _tiled_times(
            kfa.flash_attention, lambda: kfa.flash_attention(*args, **kw),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True))
        pairs = int(np.minimum(np.arange(s) + 1, window).sum())
        n_bytes = 2 * b * s * (2 * h + 2 * kv) * hd + 4 * s
        entry = _entry("flash_attention_windowed_hd256",
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:80 (window band;"
                       " the reference's local_attention, "
                       "transformer.py:302-303)",
                       err, ms, plain_ms,
                       _roofline(n_bytes, 4 * hd * h * b * pairs), lib_ms,
                       card, call_ms)
    results.append((kfa.flash_attention, entry))
    q, k, v = (torch.tensor(gen.standard_normal((2, n, m, hd), np.float32),
                            device=dev).to(torch.bfloat16)
               for n, m in ((100, h), (300, kv), (300, kv)))
    _held("flash_attention_noncausal", kfa.flash_attention_noncausal,
          functools.partial(kfa.flash_attention_plain, causal=False),
          [q, k, v], f"B=2 Sq=100 Skv=300 H={h} Kv={kv} hd={hd}")

    name = "contiguous_decode_attention_rolling"
    kernel, plain = (kda.contiguous_decode_attention_rolling,
                     kda.contiguous_decode_attention_plain)
    row_perm = gen.permutation(ROWS)
    dec = [(p, 1) for p in (2299, 1023, 299, 63)]
    entry = None
    for window in (RG_WINDOW, 64):
        case = _row_rolling_case(gen, dec, window, row_perm, h, kv, hd, dev)
        args = [case["q"], case["k"], case["v"], case["rows"],
                case["positions"]]
        kw = {"window": window}
        pl = lambda *a, **_: plain(*a, rolling_window=window)
        err = _held(name, kernel, pl, args,
                    f"W={window} B=4 contexts 64-2300 H={h} Kv={kv} hd={hd}",
                    **kw)
        if entry is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            continue
        plain_ms = _time_ms(lambda: pl(*args), reps=3, warmup=1)
        vis = np.minimum(case["np"]["pos"] + 1, window)
        n_bytes = (int(vis.sum()) * kv * hd * 2 * 2 + 2 * len(dec) * h * hd * 2
                   + 4 * 2 * len(dec))
        kg, vg = (x.transpose(1, 2) for x in _row_views(case))
        idx = torch.arange(window, device=dev)
        m4 = (idx[None] < torch.tensor(vis, device=dev)[:, None])
        q4 = case["q"][:, :, None]                       # [B, H, 1, hd]
        ms, call_ms, lib_ms = _tiled_times(
            kernel, lambda: kernel(*args, **kw),
            lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=m4[:, None, None], enable_gqa=True))
        del kg, vg
        entry = _entry(f"{name}_hd256",
                       "src/repro_torch/csrc/decode_attention.cu",
                       "src/repro/kernels/decode_attention.py:72 (contiguous "
                       "rolling mode: the reference runs jnp decode_attention"
                       "(rolling_window), transformer.py:166)",
                       err, ms, plain_ms,
                       _roofline(n_bytes, 4 * h * hd * int(vis.sum())),
                       lib_ms, card, call_ms)
    results.append((kernel, entry))

    edges = [0, L - 1, L, 2 * L - 1, 2 * L]
    _split_pairs(gen, dev, [
        ("recurrentgemma widths, split edges", h, kv, hd, 0, edges + [2299]),
        ("recurrentgemma widths, rolling split edges", h, kv, hd, RG_WINDOW,
         edges + [RG_WINDOW - 1, RG_WINDOW, 2299])])
    for source in ("flash_attention", "decode_attention"):
        for fn, regs, stores, loads in ptxas_lines(_build.build_log(source)):
            if "ILi256E" in fn:            # the hd-256 template instances
                print(f"kernel hd 256 {source}: {fn}: {regs} registers, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads", flush=True)
    return results


# llama-3.2-vision-90b's attention widths: H 64 over Kv 8 (g 8), hd 128
VLM = (64, 8, 128)


def _vlm_kernels(dev, card):
    """Rows 3, 3n and 2c at llama-3.2-vision-90b's shapes (H 64, Kv 8:
    g 8; hd 128; 6400 patch keys), as its model-API path runs them: the
    causal flash kernel over one 1024-token prompt (the phase's longest;
    prompts are prefilled one by one) and over B 2, S 397; the non-causal
    form, a prompt's queries against the 6400 patches' keys, at Sq 1024
    and at B 2, Sq 65; the contiguous decode kernel over 4 cross rows of
    6400 slots, every row at position 6399 (12.5 split chunks), each held
    against its plain version in fp32 and timed on the device beside its
    bound and SDPA with ``enable_gqa`` (a yardstick): the kernels line's
    ``flash_attention_g8``, ``flash_attention_noncausal_g8`` and
    ``contiguous_decode_attention_g8``, whose launches the vlm's greedy
    run fills in (self and cross decode for the last).  Then the cross
    decode and the self decode (rows of 1056 slots: the longest prompt and
    32 steps) paged and as rows: both bf16 decode kernels held, rows ==
    pages bit for bit.  These launches do not count."""
    import functools
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.transformer import cfg_n_patches
    h, kv, hd = VLM
    n_patches = cfg_n_patches(get_config("llama-3.2-vision-90b"))
    gen = np.random.default_rng(SEED + 19)
    rand = lambda *shape: torch.tensor(gen.standard_normal(shape, np.float32),
                                       device=dev).to(torch.bfloat16)
    results = []

    src = "src/repro_torch/csrc/flash_attention.cu"
    for name, kernel, plain, causal, cases in (
            ("flash_attention", kfa.flash_attention, kfa.flash_attention_plain,
             True, ((1, 1024, 1024), (2, 397, 397))),
            ("flash_attention_noncausal", kfa.flash_attention_noncausal,
             functools.partial(kfa.flash_attention_plain, causal=False),
             False, ((1, 1024, n_patches), (2, 65, n_patches)))):
        entry = None
        for b, sq, skv in cases:
            q, k, v = rand(b, sq, h, hd), rand(b, skv, kv, hd), \
                rand(b, skv, kv, hd)
            args = [q, k, v]
            if causal:
                args.append(torch.arange(sq, dtype=torch.int32, device=dev))
            err = _held(name, kernel, plain, args,
                        f"vlm B={b} Sq={sq} Skv={skv} H={h} Kv={kv} hd={hd}")
            if entry is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms, call_ms, lib_ms = _tiled_times(
                kernel, lambda: kernel(*args),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            pairs = sq * (sq + 1) // 2 if causal else sq * skv
            entry = _entry(f"{name}_g8", src,
                           "src/repro/kernels/flash_attention.py:80"
                           + ("" if causal else " (causal=False: the vlm's "
                              "cross-attention prefill over the patches)"),
                           err, ms, plain_ms,
                           _flash_bound(b, sq, skv, h, kv, hd, pairs,
                                        causal=causal), lib_ms, card,
                           call_ms)
        results.append((kernel, entry))

    name = "contiguous_decode_attention"
    kernel, plain = (kda.contiguous_decode_attention,
                     kda.contiguous_decode_attention_plain)
    case = _row_case(gen, [n_patches - 1] * 4, np.arange(4),
                     gen.permutation(ROWS)[:4], n_patches, h, kv, hd, dev)
    args = [case["q"], case["k"], case["v"], case["rows"], case["positions"]]
    err = _held(name, kernel, plain, args,
                f"vlm cross decode: B=4 rows of S={n_patches}, every row at "
                f"{n_patches - 1}, H={h} Kv={kv} hd={hd}")
    plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
    q4, k4, v4, m4 = _sdpa_args(case, h, hd, True, views=_row_views(case))
    ms, call_ms, lib_ms = _tiled_times(
        kernel, lambda: kernel(*args),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                               enable_gqa=True))
    del q4, k4, v4, m4
    results.append((kernel, _entry(
        f"{name}_g8", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:72 (the vlm's cross decode: "
        "the reference's unmasked decode_attention over the patches)",
        err, ms, plain_ms, _bound(case, h, hd), lib_ms, card, call_ms)))
    del case, args

    _split_pairs(gen, dev, [
        ("llama-3.2-vision-90b cross decode", h, kv, hd, 0,
         [n_patches - 1] * 4),
        ("llama-3.2-vision-90b self decode", h, kv, hd, 0,
         [1055, 543, 231, 95])])
    return results


# the three families the engine does not serve, in the reference's order,
# with their prompt lengths (B 4): recurrentgemma's longest crosses W
# (2048), so the window bites at prefill and decode; two of xLSTM's leave
# a short last mLSTM chunk (CHUNK 128: 641 = 5 * 128 + 1, 255 = 128 + 127)
FAMILY_PROMPTS = (("recurrentgemma-9b", (2300, 1024, 300, 64)),
                  ("xlstm-1.3b", (1024, 641, 255, 64)),
                  ("llama-3.2-vision-90b", (1024, 512, 200, 64)))
FAMILY_STEPS = 32


def _family_model(arch, dev, depth=None):
    """The model of ``arch`` (its first ``depth`` layers, if given) with
    weights from SEED on ``dev``; a vlm's cross-attention gates set to 1.0
    (their init, zeros, would hide the patches: tanh(0) = 0)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    if cfg.family == "vlm":
        params["stacks"]["blocks"]["cross"]["attn"]["gate"].fill_(1.0)
    return model, params


def _family_greedy(model, params, prompts, patches, n_steps, tokens=None):
    """Each prompt prefilled alone (B 1; its patches [1, P, d] for a vlm),
    the caches gathered into one batch (``Model.init_cache(fill=[...])``),
    then ``n_steps`` greedy decode steps of the batch, row b at positions
    len(prompt b) + i (``tokens``, [B, n_steps], feeds fixed tokens
    instead).  Returns every step's logits [1 + n_steps, B, V], the decode
    tokens [B][n_steps], and the prefill and decode seconds."""
    import torch
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.monotonic()
    first, fills = [], []
    for i, p in enumerate(prompts):
        batch = {"tokens": p[None]}
        if patches is not None:
            batch["patches"] = patches[i:i + 1]
        lg, cache = model.prefill(params, batch)
        first.append(lg)
        fills.append(cache)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    cache = model.init_cache(len(prompts), int(lens.max()) + n_steps,
                             device=dev, dtype=params["embed"].dtype,
                             fill=fills)
    del fills
    sync()
    t1 = time.monotonic()
    steps, out = [torch.cat(first)], []
    tok = steps[0].argmax(-1).to(torch.int32)
    for i in range(n_steps):
        if tokens is not None:
            tok = tokens[:, i]
        lg, cache = model.decode(params, cache, {"token": tok,
                                                 "positions": lens + i})
        steps.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
    sync()
    t2 = time.monotonic()
    return (torch.stack(steps).float().cpu(),
            torch.stack(out, 1).cpu().tolist(), t1 - t0, t2 - t1)


def _family_inputs(cfg, lengths, gen, dev):
    """Prompt tokens of the given lengths and, for a vlm, patch embeddings
    [B, P, d] (bf16)."""
    import torch
    from repro_torch.models.transformer import cfg_n_patches
    prompts = [torch.tensor(gen.integers(2, cfg.vocab_size, n),
                            dtype=torch.int32, device=dev) for n in lengths]
    patches = None
    if cfg.family == "vlm":
        patches = torch.tensor(gen.standard_normal(
            (len(lengths), cfg_n_patches(cfg), cfg.d_model), np.float32),
            device=dev).to(torch.bfloat16)
    return prompts, patches


def phase_families(dev, kernels, card):
    """The hybrid, ssm and vlm families through the port's model API
    (``build_model(cfg).prefill`` / ``.decode``; the engine does not serve
    them): first rows 3w and 2cr at hd 256 (``_families_kernels``) and
    rows 3, 3n and 2c at the vlm's g 8 over its 6400 patches
    (``_vlm_kernels``); then
    recurrentgemma-9b (38 layers), xlstm-1.3b (48) and llama-3.2-vision-90b
    (``ONE_CARD_LAYERS`` of 100) at their published widths, each built from
    SEED on the card and freed before the next: B = 4 prompts prefilled
    apart and 32 greedy decode steps as one batch, every launch counter set
    to 0 just before and read just after; every logit finite, the path's
    kernels launched (recurrentgemma: the flash window band and the
    contiguous rolling decode kernel; the vlm: causal and non-causal flash
    and the contiguous decode kernel; xLSTM runs none), a second run the
    same tokens and logits, and for the vlm other patches other prefill
    logits.  Last, each ``-smoke`` twin on the card against the CPU,
    prefill and 4 decode steps on fixed tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_3_2_vision_90b import ONE_CARD_LAYERS
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.stacked import tree_map

    kernels.extend(_families_kernels(dev, card) + _vlm_kernels(dev, card))
    entries = {e["name"]: e for _, e in kernels}
    paths = {"recurrentgemma-9b": (kfa.flash_attention,
                                   kda.contiguous_decode_attention_rolling),
             "xlstm-1.3b": (),
             "llama-3.2-vision-90b": (kfa.flash_attention,
                                      kfa.flash_attention_noncausal,
                                      kda.contiguous_decode_attention)}
    gen = np.random.default_rng(SEED + 16)
    for arch, lengths in FAMILY_PROMPTS:
        depth = ONE_CARD_LAYERS if arch == "llama-3.2-vision-90b" else None
        t0 = time.monotonic()
        model, params = _family_model(arch, dev, depth)
        cfg = model.cfg
        torch.cuda.synchronize()
        print(f"families: {arch} ({cfg.family}) L={cfg.num_layers} "
              f"d={cfg.d_model} H={cfg.num_heads} Kv={cfg.num_kv_heads} "
              f"hd={cfg.resolved_head_dim} vocab={cfg.vocab_size}: init "
              f"{time.monotonic() - t0:.1f}s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        prompts, patches = _family_inputs(cfg, lengths, gen, dev)
        path = paths[arch]
        counters = ({k for k, _ in kernels}
                    | {kfa.flash_attention, kfa.flash_attention_noncausal,
                       kda.contiguous_decode_attention,
                       kda.contiguous_decode_attention_rolling})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        logits, stream, pre_s, dec_s = _family_greedy(
            model, params, prompts, patches, FAMILY_STEPS)
        launches = {k.__name__: k.launches for k in counters}
        peak = torch.cuda.max_memory_allocated()
        print(f"families {arch} greedy: prompts {list(lengths)}, new tokens "
              f"{[len(x) for x in stream]}, launches "
              f"{ {n: c for n, c in launches.items() if c} }, first row "
              f"{stream[0][:8]}...", flush=True)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: a logit is not finite")
        for k in path:
            if launches[k.__name__] <= 0:
                raise AssertionError(f"{k.__name__} never launched on the "
                                     f"{arch} path")
        if not path and any(launches.values()):
            raise AssertionError(f"{arch}: an attention kernel launched")
        if arch == "recurrentgemma-9b":
            entries["flash_attention_windowed_hd256"]["launches"] = \
                launches["flash_attention"]
            entries["contiguous_decode_attention_rolling_hd256"][
                "launches"] = launches["contiguous_decode_attention_rolling"]
        if arch == "llama-3.2-vision-90b":
            for k in path:
                entries[f"{k.__name__}_g8"]["launches"] = launches[k.__name__]
        again = _family_greedy(model, params, prompts, patches, FAMILY_STEPS)
        print(f"families {arch}: a second run gives the same tokens: "
              f"{again[1] == stream}, the same logits: "
              f"{torch.equal(again[0], logits)}", flush=True)
        if again[1] != stream or not torch.equal(again[0], logits):
            raise AssertionError(f"{arch}: two identical runs differ")
        if patches is not None:
            other = torch.randn(patches[:1].shape, generator=torch.Generator(
                device=dev).manual_seed(SEED + 17), device=dev).to(
                patches.dtype)
            moved = float((model.prefill(params, {
                "tokens": prompts[0][None], "patches": other})[0].float()
                .cpu() - logits[0, :1]).abs().max())
            print(f"families {arch}: other patches move the prefill logits "
                  f"by up to {moved:.4f}", flush=True)
            if not moved > 0:
                raise AssertionError(f"{arch}: the patches do not reach the "
                                     f"logits")
        b, n = len(prompts), FAMILY_STEPS
        for label, p_s, d_s in (("first run", pre_s, dec_s),
                                ("second run", *again[2:])):
            print(f"families {arch} {label}: prefill {p_s * 1e3:.3f} ms "
                  f"({sum(lengths)} tokens, rows apart), decode step "
                  f"{d_s / n * 1e3:.3f} ms, {b * n / (p_s + d_s):.2f} tok/s "
                  f"(B = {b}, {n} steps), peak memory {peak / 2**30:.2f} GiB "
                  f"on {card}", flush=True)
        del model, params, prompts, patches, logits, again
        gc.collect()
        torch.cuda.empty_cache()

    # the smoke configs on the card against the CPU, on fixed tokens
    for arch, _ in FAMILY_PROMPTS:
        gen = np.random.default_rng(SEED + 18)
        model, params = _family_model(arch + "-smoke", "cpu")
        prompts, patches = _family_inputs(model.cfg, (40, 23), gen, "cpu")
        tokens = torch.tensor(gen.integers(2, model.cfg.vocab_size, (2, 4)),
                              dtype=torch.int32)
        a = _family_greedy(model, params, prompts, patches, 4, tokens)[0]
        to_dev = lambda x: None if x is None else x.to(dev)
        c = _family_greedy(model, tree_map(to_dev, params),
                           [to_dev(p) for p in prompts], to_dev(patches), 4,
                           to_dev(tokens))[0]
        err = float((a - c).abs().max())
        print(f"families {arch}-smoke prefill+4 decode steps: logits card "
              f"vs CPU max_abs_err={err:.3e} (tol {LOGIT_TOL}), shape "
              f"{tuple(c.shape)}", flush=True)
        if not bool(torch.isfinite(c).all()) or not err <= LOGIT_TOL:
            raise AssertionError(f"{arch}-smoke: logits on the card disagree "
                                 f"with the CPU")


# the fused-product kernels' checks, (T, d, ff or F, where the shape comes
# from); the first of each list is the kernel's entry in the kernels line
# the wgmma body's edges follow: token tiles of 8, 16, 32 (T 17), 64 and
# three of 128 (T 257), and split-K slices whose last is short, over a k
# and a column tail (kernels/_gemm.py plan)
SWIGLU_CASES = ((256, 2048, 5632, "stablelm-1.6b MLP, a 256-token chunk"),
                (4, 2048, 5632, "stablelm-1.6b MLP at decode"),
                (80, 4096, 14336, "one mixtral-8x7b expert, C 80"),
                (37, 96, 160, "ragged rows, k and column tails"),
                (5, 96, 160, "few rows, k and column tails"),
                (1, 2048, 5632, "stablelm-1.6b MLP, one token"),
                (16, 2048, 5632, "stablelm-1.6b MLP, 16 tokens"),
                (17, 2048, 5632, "stablelm-1.6b MLP, 17 tokens"),
                (64, 2048, 5632, "stablelm-1.6b MLP, 64 tokens"),
                (257, 2048, 5632, "stablelm-1.6b MLP, 257 tokens"),
                (3, 2080, 1440, "ragged widths, short last split slices"))
RMSNORM_MM_CASES = ((4, 2048, 100352, "stablelm-1.6b LM head at decode"),
                    (256, 2048, 5632, "stablelm-1.6b MLP entry (norm, w1)"),
                    (4, 4096, 32000, "mixtral-8x7b LM head at decode"),
                    (37, 96, 160, "ragged rows, k and column tails"),
                    (5, 96, 160, "few rows, k and column tails"),
                    (1, 2048, 100352, "stablelm-1.6b LM head, one token"),
                    (16, 2048, 5632, "stablelm-1.6b MLP entry, 16 tokens"),
                    (17, 2048, 5632, "stablelm-1.6b MLP entry, 17 tokens"),
                    (64, 2048, 5632, "stablelm-1.6b MLP entry, 64 tokens"),
                    (257, 2048, 5632, "stablelm-1.6b MLP entry, 257 tokens"),
                    (3, 2080, 1440, "ragged widths, short last split slices"))


def _held_gemm(name, kernel, plain, args, lhs, rhs, label, **kw):
    """One launch of a fused-product kernel (not counted) held against its
    plain version on the same bf16 values, with the plain version's own
    casts, within ``_gemm.gemm_limit`` (lhs @ rhs the rounded product the
    output sums), and a second launch that must repeat it bit for bit;
    returns the max |error|."""
    import torch
    from repro_torch.kernels import _gemm
    launches = kernel.launches
    out = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    kernel.launches = launches
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {label}: two launches on the same "
                             f"inputs differ")
    ref = plain(*args, **kw)
    err, ratio = _gemm.gemm_excess(out, ref, lhs, rhs)
    finite = bool(torch.isfinite(out.float()).all())
    print(f"kernel {name} {label}: max_abs_err={err:.3e} max(|err| / "
          f"limit)={ratio:.4f} (limit {_gemm.GEMM_REL:.2e}*|plain| + "
          f"{_gemm.GEMM_SUM:.2e}*(|lhs|@|rhs|) + {_gemm.GEMM_ABS:.0e}) "
          f"finite={finite}", flush=True)
    if not finite or not ratio <= 1:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _fused_kernels(dev, card):
    """Both fused-product kernels at every shape of SWIGLU_CASES and
    RMSNORM_MM_CASES, held as in ``_held_gemm`` and timed on the device
    (``_device_ms``) beside their plain versions, their bounds and a
    cuBLAS composition (a yardstick the port never calls; no one PyTorch
    call computes either function)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm_matmul as krm
    from repro_torch.kernels import swiglu as ksw
    from repro_torch.models.common import rmsnorm
    gen = np.random.default_rng(SEED + 5)

    def rand(*shape, scale=1.0):
        return (torch.tensor(gen.standard_normal(shape, np.float32),
                             device=dev) * scale).to(torch.bfloat16)

    def case(kernel, plain, compose, args, lhs, rhs, label, n_bytes, flops):
        err = _held_gemm(kernel.__name__, kernel, plain, args, lhs, rhs,
                         label)
        ms = _device_ms(kernel, lambda: kernel(*args))
        call_ms = _kernel_ms(kernel, lambda: kernel(*args))
        plain_ms = _device_ms(None, lambda: plain(*args), reps=5)
        comp_ms = _device_ms(None, compose)
        bound_ms, bound_by = _roofline(n_bytes, flops)
        print(f"kernel {kernel.__name__} {label}: ms={ms:.4f} (device; "
              f"{call_ms:.4f} a call back to back through the wrapper) "
              f"plain_ms={plain_ms:.4f} composition_ms={comp_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}, {n_bytes / 1e6:.1f} MB,"
              f" {flops / 1e9:.2f} GFLOP) on {card}", flush=True)
        return dict(shape=label, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    composition_ms=comp_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err)

    def entry(name, replaces, shapes):
        """The kernels-line entry: the first shape's numbers, the largest
        error over all shapes, and every shape's numbers."""
        main = shapes[0]
        e = _entry(name, f"src/repro_torch/csrc/{name}.cu", replaces,
                   max(x["max_abs_err"] for x in shapes), main["ms"],
                   main["plain_ms"], (main["bound_ms"], main["bound_by"]),
                   None, card)
        e.update(composition_ms=main["composition_ms"], shapes=shapes)
        return e

    shapes = []
    for t, d, ff, what in SWIGLU_CASES:
        x = rand(t, d)
        w1, w3 = rand(d, ff, scale=d ** -0.5), rand(d, ff, scale=d ** -0.5)
        w2 = rand(ff, d, scale=ff ** -0.5)
        shapes.append(case(ksw.swiglu, ksw.swiglu_plain,
                           lambda: (F.silu(x @ w1) * (x @ w3)) @ w2,
                           [x, w1, w3, w2], ksw.swiglu_hidden(x, w1, w3), w2,
                           f"T={t} d={d} ff={ff} ({what})",
                           2 * (2 * t * d + 3 * d * ff), 6 * t * d * ff))
        del x, w1, w3, w2
    results = [(ksw.swiglu, entry("swiglu", "src/repro/kernels/swiglu.py:40",
                                  shapes))]
    shapes = []
    for t, d, f, what in RMSNORM_MM_CASES:
        x, wn = rand(t, d), 1.0 + rand(d, scale=0.1)
        wp = rand(d, f, scale=d ** -0.5)
        shapes.append(case(krm.rmsnorm_matmul, krm.rmsnorm_matmul_plain,
                           lambda: rmsnorm(x, wn) @ wp, [x, wn, wp],
                           rmsnorm(x, wn), wp, f"T={t} d={d} F={f} ({what})",
                           2 * (t * d + d + d * f + t * f), 2 * t * d * f))
        del x, wn, wp
    results.append((krm.rmsnorm_matmul,
                    entry("rmsnorm_matmul",
                          "src/repro/kernels/rmsnorm_matmul.py:31", shapes)))
    gc.collect()
    torch.cuda.empty_cache()
    return results


def phase_fused(dev, card):
    """The reference's fused-op entry point (``kernels/ops.py``) on the
    card: both kernels' checks (``_fused_kernels``), then the path:
    full-width stablelm-1.6b (random weights from SEED), layer 0's
    ``x + ops.swiglu_fused(rmsnorm(x, ln), w1, w3, w2)`` against the
    port's unfused ``mlp_block`` and ``ops.rmsnorm_matmul_fused(x, lnf,
    head)`` against ``lm_head``, at a decode batch [4, d] and a chunk
    [1, 256, d], every launch counter set to 0 just before and read just
    after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm_matmul as krm
    from repro_torch.kernels import swiglu as ksw
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import mlp_block

    results = _fused_kernels(dev, card)
    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    p = {k: v[0] for k, v in params["stacks"]["blocks"]["l0"]["ffn"].items()}
    gen = np.random.default_rng(SEED + 6)
    inputs = [torch.tensor(gen.standard_normal(s, np.float32),
                           device=dev).to(torch.bfloat16)
              for s in ((4, cfg.d_model), (1, 256, cfg.d_model))]
    path = (ksw.swiglu, krm.rmsnorm_matmul)
    torch.cuda.synchronize()
    for k in path:
        k.launches = 0
    outs = [(x + ops.swiglu_fused(rmsnorm(x, p["ln"], cfg.norm_eps),
                                  p["w1"], p["w3"], p["w2"]),
             ops.rmsnorm_matmul_fused(x, params["lnf"], params["head"],
                                      eps=cfg.norm_eps).float())
            for x in inputs]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in path}
    print(f"fused path: {cfg.name} d={cfg.d_model} ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}, launches {launches}", flush=True)
    for (_, entry), k in zip(results, path):
        entry["launches"] = launches[k.__name__]
        if entry["launches"] <= 0:
            raise AssertionError(f"{k.__name__} never launched on the "
                                 f"fused path")

    def close(label, got, want):
        # tests/test_kernels.py's oracle tolerance: the model's unfused
        # path rounds x @ w1 and x @ w3 to bf16, the kernel keeps them fp32
        got, want = got.float(), want.float()
        atol = 0.03 * max(float(want.abs().max()), 1.0)
        diff = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (diff <= 5e-2 * want.abs() + atol).all())
        print(f"fused path {label}: max_abs_diff={float(diff.max()):.4e} "
              f"(rtol 5e-2, atol {atol:.4f}) within={ok}", flush=True)
        if not ok:
            raise AssertionError(f"fused path {label}: outside tolerance")

    for x, (mlp, logits) in zip(inputs, outs):
        shape = tuple(x.shape)
        close(f"{shape} x + swiglu_fused vs mlp_block", mlp,
              mlp_block(p, x, cfg))
        want = model.lm_head(params, x)
        close(f"{shape} rmsnorm_matmul_fused vs lm_head", logits, want)
        agree = torch.equal(logits.argmax(-1), want.argmax(-1))
        print(f"fused path {shape}: max |delta logits| "
              f"{float((logits - want).abs().max()):.4e}, greedy argmax "
              f"agrees: {agree}", flush=True)
    del params, p, inputs, outs
    gc.collect()
    torch.cuda.empty_cache()
    return results


PHASES = ("kernels", "rolling", "engine", "serving", "mixtral", "configs",
          "contiguous", "reference", "whisper", "families", "fused")


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all; a "
                         "subset prints no result line)" % (PHASES,))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if "serving" in phases and not {"kernels", "engine"} <= set(phases):
        ap.error("the serving phase needs the kernels and engine phases")
    for phase in ("configs", "families"):
        if phase in phases and "kernels" not in phases:
            ap.error(f"the {phase} phase needs the kernels phase")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = np.random.default_rng(SEED)
    card = _smi()
    t0 = time.monotonic()
    secs = _build.build()
    print(f"build: {len(_build.sources())} kernel sources in {secs:.2f}s", flush=True)
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)
    def timed(name, fn, *a):
        t = time.monotonic()
        out = fn(*a)
        gc.collect()
        print(f"phase {name}: {time.monotonic() - t:.1f}s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
              f"allocated", flush=True)
        return out

    kernels = []
    if "kernels" in phases:
        kernels += timed("kernels", phase_kernels, dev, gen, card)
    if "rolling" in phases:
        kernels += timed("rolling", phase_rolling_kernels, dev, card)
    contiguous = "contiguous" in phases
    if contiguous:
        kernels += timed("contiguous kernels", phase_contiguous_kernels, dev,
                         card)
    # the contiguous paths reuse each model phase's weights and prompts
    # and compare with its paged streams, so they run right after it
    if "engine" in phases:
        held = timed("engine", phase_engine, dev, gen, kernels, card)
        if contiguous:
            timed("contiguous stablelm", phase_contiguous_dense, kernels,
                  card, *held)
        if "serving" in phases:
            timed("serving", phase_serving, kernels, card, *held[:2])
        del held
    if "mixtral" in phases:
        held = timed("mixtral", phase_mixtral, dev, kernels, card)
        if contiguous:
            timed("contiguous mixtral", phase_contiguous_mixtral, kernels,
                  card, *held)
        del held
        gc.collect()
        torch.cuda.empty_cache()
    if "configs" in phases:
        timed("configs", phase_configs, dev, kernels, card)
    if "reference" in phases:
        timed("reference", phase_reference, dev)
    if "whisper" in phases:
        timed("whisper", phase_whisper, dev, kernels, card)
    if "families" in phases:
        timed("families", phase_families, dev, kernels, card)
    if "fused" in phases:
        kernels += timed("fused", phase_fused, dev, card)
    print(f"chip_smoke: {time.monotonic() - t0:.1f}s total", flush=True)
    print(card)
    print(json.dumps({"kernels": [e for _, e in kernels]}))
    if phases != list(PHASES):
        print(f"chip_smoke: partial run ({args.phases}): no result",
              flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
