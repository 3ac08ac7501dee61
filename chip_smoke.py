#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports the port (``src/repro_torch``) and nothing of the JAX package.
Phases, each printing its own lines; any failure raises (exit code != 0):

1. build  — compiles every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the seconds.
2. kernels — runs each kernel at the main path's shapes (stablelm-1.6b:
   H = Kv = 32, hd = 64, 16-slot pages) and at one GQA shape (g = 4, with
   decode contexts as short as one slot), holds it against its plain
   PyTorch version run in fp32 on the same inputs (|error| <=
   KERNEL_REL * |plain| + KERNEL_ABS), and times kernel, plain version
   (bf16, as the port runs it) and one ``scaled_dot_product_attention``
   call on the gathered view (a yardstick the port never calls) beside
   the kernel's memory/compute bound.
3. engine — serves full-width stablelm-1.6b (random weights from SEED)
   through the port's SiPipeEngine (pp = 2, chunked policy, 256-token
   chunks, paged KV): greedy tokens of a 2-request run must equal
   NaivePPEngine's; then, with every launch counter set to 0, 8 requests
   of 64-512 prompt tokens and 32 new tokens each must all finish, and
   both kernels must have launched.  A smoke-size model's logits on the
   card must agree with the same model on the CPU.

Then it prints the card's name and power limit, one JSON line describing
each kernel, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# kernel (bf16 in, fp32 inside, bf16 out) vs the plain version in fp32 on
# the same values: |error| <= KERNEL_REL * |plain| + KERNEL_ABS, one bf16
# step of the output (2^-7 relative; rounding moves it by half that) plus
# fp32 summation-order noise.  Dropping one of n visible slots moves an
# output by ~|v|/n, ~1e-3 at n = 1000: several steps of a typical output.
KERNEL_REL = 2.0 ** -7
KERNEL_ABS = 1e-5
LOGIT_TOL = 0.1        # smoke model logits, card vs CPU (bf16 matmuls)
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
BF16_FLOP_S = 989e12   # H100 SXM dense bf16 tensor-core rate


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


def _bound(case, h, hd):
    """Least time for the function: each row's K/V prefix read once, q
    and the output once (bytes); 4*H*hd flops per visible slot."""
    kv, n = case["k"].shape[2], case["q"].shape[0]
    kv_bytes = int(case["ctx"].sum()) * kv * hd * 2 * 2
    io_bytes = 2 * n * h * hd * 2 + 4 * (case["tables"].numel() + 2 * n)
    flops = 4 * h * hd * int((case["positions"].long() + 1).sum())
    t_bytes, t_ops = (kv_bytes + io_bytes) / HBM_BYTES_S, flops / BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sdpa_args(case, h, hd, decode: bool):
    """Padded [B, H, C, hd] queries, the gathered [B, Kv, S, hd] view and
    a boolean mask, for the library yardstick."""
    import torch
    from repro_torch.models.attention import gather_paged_cache
    k = gather_paged_cache(case["k"], case["tables"]).transpose(1, 2)
    v = gather_paged_cache(case["v"], case["tables"]).transpose(1, 2)
    b, s = k.shape[0], k.shape[2]
    rows = case["rows"].long().cpu().numpy()
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


def phase_kernels(dev, gen, card):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import span_attention as ksa

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
            launches = kernel.launches
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*[a.float() if a.is_floating_point() else a
                          for a in args])
            diff = (out.float() - ref).abs()
            err = float(diff.max())
            excess = float((diff - KERNEL_REL * ref.abs()).max())
            finite = bool(torch.isfinite(out.float()).all())
            print(f"kernel {name} H={h} Kv={kv} hd={hd}: max_abs_err={err:.3e}"
                  f" max(|err| - {KERNEL_REL:.2e}*|plain|)={excess:.3e} "
                  f"(tol {KERNEL_ABS:.0e}) finite={finite}", flush=True)
            if not finite or not excess <= KERNEL_ABS:
                raise AssertionError(f"{name} disagrees with its plain version")
            if kv != h:
                kernel.launches = launches      # comparisons do not count
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                continue
            ms = _time_ms(lambda: kernel(*args), reps=50)
            plain_ms = _time_ms(lambda: plain(*args), reps=3, warmup=1)
            q4, k4, v4, m4 = _sdpa_args(case, h, hd, decode)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, enable_gqa=True), reps=20)
            kernel.launches = launches
            bound_ms, bound_by = _bound(case, h, hd)
            print(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"({bound_by}) on {card}", flush=True)
            entry = dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
        results.append((kernel, entry))
    return results


def _engine(engine_cls, params, model):
    from repro_torch.core.engine import EngineConfig
    ecfg = EngineConfig(pp_degree=2, max_batch=4, max_seq_len=640,
                        prefill_chunk_tokens=256,
                        scheduling_policy="chunked", seed=SEED)
    return engine_cls(model, params, ecfg)


def phase_engine(dev, gen, kernels, card):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NaivePPEngine, SiPipeEngine
    from repro_torch.core.sampling_params import SamplingParams
    from repro_torch.models.registry import build_model

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

    # greedy parity at equal composition: SiPipe vs the naive baseline
    greedy = SamplingParams(greedy=True, max_new_tokens=16)
    streams = []
    for cls in (SiPipeEngine, NaivePPEngine):
        eng = _engine(cls, params, model)
        for p in prompts[:2]:
            eng.add_request(p, greedy)
        done = sorted(eng.run(), key=lambda s: s.seq_id)
        streams.append([list(s.output_ids) for s in done])
        del eng
    print(f"engine: greedy 2-request streams SiPipe == Naive: "
          f"{streams[0] == streams[1]} ({streams[0][0][:8]}...)", flush=True)
    if streams[0] != streams[1] or len(streams[0]) != 2:
        raise AssertionError(f"greedy streams differ: {streams}")

    # the main path: 8 requests, launch counters from zero
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                        frequency_penalty=0.2, presence_penalty=0.1,
                        max_new_tokens=32)
    eng = _engine(SiPipeEngine, params, model)
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
    n_tok = [len(s.output_ids) for s in done]
    print(f"engine: {len(done)} requests, prompts "
          f"{sorted(len(p) for p in prompts)}, new tokens {n_tok}, "
          f"wall {wall:.3f}s, launches {launches}", flush=True)
    print(f"engine: throughput {m['throughput_tok_s']:.2f} tok/s, TTFT mean "
          f"{m['ttft_mean_s'] * 1e3:.2f} ms p99 {m['ttft_p99_s'] * 1e3:.2f} ms, "
          f"TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms p99 "
          f"{m['tpot_p99_s'] * 1e3:.2f} ms, peak memory {peak / 2**30:.2f} GiB,"
          f" stages busy {[round(s['busy_s'], 3) for s in m['stages']]} s "
          f"on {card}", flush=True)
    if len(done) != 8 or any(n != 32 for n in n_tok):
        raise AssertionError(f"not every request finished with 32 tokens: {n_tok}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for k, e in kernels:
        e["launches"] = k.launches
    del eng, params


def phase_reference(dev):
    """Smoke-size model: one chunk step and one decode step, on the card
    (CUDA kernels) and on the CPU (plain versions), same weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import split_for_pp
    from repro_torch.models.registry import build_model
    from repro_torch.models.stacked import tree_map

    cfg = get_config("stablelm-1.6b-smoke")
    model = build_model(cfg)
    params = model.init(SEED, device="cpu")
    logits = {}
    for d in ("cpu", dev):
        p = tree_map(lambda x: x.to(d), params)
        stage = split_for_pp(model, p, 1)[0]
        cache = model.paged_cache(cfg.num_layers, 9, 16, device=d)
        t = lambda a: torch.tensor(np.asarray(a, np.int32), device=d)
        tables = t([[0, 1, 2, 8], [3, 4, 8, 8]])
        toks = np.random.default_rng(SEED).integers(2, cfg.vocab_size, 60)
        pos = np.concatenate([np.arange(40), np.arange(20)])
        seq = np.repeat([0, 1], [40, 20])
        out1 = stage.chunk_fn(stage.params, cache, t(toks), t(pos), t(seq),
                              t([39, 59]), tables)
        out2 = stage.decode_fn(stage.params, cache, t([5, 7]), t([40, 20]),
                               tables)
        logits[str(d)] = torch.cat([out1, out2]).float().cpu()
    a, b = logits["cpu"], logits[str(dev)]
    err = float((a - b).abs().max())
    print(f"reference: smoke logits card vs CPU max_abs_err={err:.3e} "
          f"(tol {LOGIT_TOL}), shape {tuple(b.shape)}", flush=True)
    if not bool(torch.isfinite(b).all()) or not err <= LOGIT_TOL:
        raise AssertionError("smoke logits on the card disagree with the CPU")


def main() -> int:
    import torch
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
    kernels = phase_kernels(dev, gen, card)
    phase_engine(dev, gen, kernels, card)
    phase_reference(dev)
    print(f"chip_smoke: {time.monotonic() - t0:.1f}s total", flush=True)
    print(card)
    print(json.dumps({"kernels": [e for _, e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
