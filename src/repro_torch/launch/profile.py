"""Where the time of one engine iteration goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile [--arch stablelm-1.6b]
        [--parts dense,mixtral,whisper,families]

Splits a full-width model into two pipeline stages on one card (random
weights from ``--seed``) and times the pieces an iteration is made of,
at the shapes of ``chip_smoke.py``'s engine phase.  For the dense model:

* the first stage's decode step (B = 4 rows, contexts of 300-600 tokens),
  chunk step (T = 256 packed tokens over 4 rows) and monolithic prefill
  step (4 right-padded prompts, S = 397), the same decode and chunk steps
  over contiguous cache rows (8 rows of 640 slots, the batch's rows out of
  order), and its decode and chunk steps over the int8 KV cache: host
  time per step (wall clock around
  synchronised steps), device time (CUDA events), the device's busy
  share of the step and its kernels by device time (``torch.profiler``);
* the last stage's decode step including the logits' copy to the host;
* the CPU sampler on those logits, with the serving defaults' params
  (temperature, top-k, top-p, penalties) and greedy.

Then for mixtral-8x7b at its published widths, cut to the 16 of its 32
layers that one card holds, as in ``chip_smoke.py``: the first stage's decode
step (B = 4 rows, two of them past the W = 4096 window), rolling chunk
step (T = 256 over 4 rows, wrapped and not), the same decode and chunk
steps over the int8 rolling cache (a ``kv_quant`` model) and monolithic
prefill step
(one prompt of 4500 tokens, longer than W: the windowed flash kernel's
share of a prompt's prefill), and one MoE layer's FFN at T = 4 and T = 256
tokens.

Then for whisper-small at full width (12 + 12 layers, random weights),
at the shapes of ``chip_smoke.py``'s whisper phase (B = 4 rows of 1500
frames, a 4-token prompt, a 36-slot decode cache): one encoder layer,
the whole encoder, the whole prefill (encoder, then the decoder over the
prompt; the decoder's share is the difference) and one decode step.

Then the hybrid, ssm and vlm families at their published widths, at the
shapes of ``chip_smoke.py``'s families phase (each model built and freed
in turn): for recurrentgemma-9b (38 layers) a 2300-token prefill (B 1,
over W = 2048), one superblock of it (rglru, rglru, attn, each with its
MLP), one RG-LRU block, its doubling scan alone and one local-attention
block; for xlstm-1.3b (48) a 1024-token prefill, one sLSTM block (its
token loop) and one mLSTM block (8 chunks of 128); for
llama-3.2-vision-90b (25 of 100 layers) a 1024-token prefill over 6400
patches, one cross-attention block and one self-attention layer; and
for each a decode step of B 4 rows (contexts 64-2300).

Every decode step above (stablelm's paged, rows and int8; mixtral's
bf16 and int8) is timed a second time as a CUDA graph replay (" · graph"):
the step captured once, as the engine captures it
(``core/step_graphs.CudaGraphs``), on the same inputs, in the same call.

Prints one line per piece and, last, one JSON object with every number
beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import split_for_pp
from repro_torch.core.sampler import ColumnWiseSampler
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.core.step_graphs import CudaGraphs
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map

BS = 16


def _host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _device_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int, top: int = 6):
    """(device busy share of the wall time, [(kernel, device ms/step)])."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in kernels)
    kernels.sort(key=lambda kt: -kt[1])
    return busy / wall_us, [(k[:60], t / reps / 1e3) for k, t in kernels[:top]]


def _piece(name, fn, reps, results, profile=True, graph=False):
    """Time ``fn`` (host ms, device ms, busy share, top kernels); with
    ``graph``, then again as the replay of its capture."""
    for _ in range(3):
        fn()
    row = {"host_ms": _host_ms(fn, reps), "device_ms": _device_ms(fn, reps)}
    if profile:
        row["busy_share"], row["top_kernels_ms"] = _profile(fn, reps)
    results[name] = row
    print(f"{name}: {json.dumps(row)}", flush=True)
    if graph:
        backend = CudaGraphs(torch.cuda.current_device())
        with backend.active():
            fn()          # the stream's first cuBLAS call, outside capture
            g, _ = backend.capture(fn)
        torch.cuda.current_stream().wait_stream(backend.stream)
        _piece(f"{name} · graph", lambda: backend.replay(g), reps, results,
               profile)


def profile_mixtral(seed: int, reps: int, dev, results):
    """mixtral-8x7b (16 of 32 layers) over the paged rolling cache."""
    from repro_torch.configs.mixtral_8x7b import ONE_CARD_LAYERS
    from repro_torch.models.transformer import moe_block
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=ONE_CARD_LAYERS)
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    first = split_for_pp(model, params, 2)[0]
    nb = cfg.window // BS                         # a full rolling table
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    tables = i32(np.arange(4 * nb).reshape(4, nb))
    cache = model.paged_cache(first.n_groups, 4 * nb + 1, BS, device=dev)
    tok, pos = i32([1, 2, 3, 4]), i32([4700, 300, 4500, 100])
    _piece(f"mixtral first stage decode step (B=4, {first.n_groups} layers)",
           lambda: first.decode_fn(first.params, cache, tok, pos, tables),
           reps, results, graph=True)
    starts = np.array([4500, 100, 4050, 3000])
    span = i32(np.arange(256) % cfg.vocab_size)
    span_pos = i32(np.concatenate([s + np.arange(64) for s in starts]))
    span_seq = i32(np.repeat(np.arange(4), 64))
    last_idx = i32([63, 127, 191, 255])
    _piece(f"mixtral first stage rolling chunk step (T=256, "
           f"{first.n_groups} layers)",
           lambda: first.chunk_fn(first.params, cache, span, span_pos,
                                  span_seq, last_idx, tables,
                                  span_starts=i32(starts), n_valid=256),
           reps, results)
    # the same steps over the int8 rolling cache (the weights are the same)
    model_q = build_model(cfg, ModelOptions(kv_quant=True))
    first_q = split_for_pp(model_q, params, 2)[0]
    cache_q = model_q.paged_cache(first_q.n_groups, 4 * nb + 1, BS,
                                  device=dev)
    _piece(f"mixtral first stage decode step, int8 cache (B=4, "
           f"{first_q.n_groups} layers)",
           lambda: first_q.decode_fn(first_q.params, cache_q, tok, pos,
                                     tables),
           reps, results, graph=True)
    _piece(f"mixtral first stage rolling chunk step, int8 cache (T=256, "
           f"{first_q.n_groups} layers)",
           lambda: first_q.chunk_fn(first_q.params, cache_q, span, span_pos,
                                    span_seq, last_idx, tables,
                                    span_starts=i32(starts), n_valid=256),
           reps, results)
    del first_q, cache_q
    prompt = i32(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (1, 4500)))
    _piece(f"mixtral first stage monolithic prefill step (B=1, S=4500, "
           f"{first.n_groups} layers)",
           lambda: first.prefill_fn(first.params, prompt, 0, i32([4499])),
           max(1, reps // 4), results)
    ffn = tree_map(lambda w: w[0], first.params["blocks"]["l0"]["ffn"])
    for t in (4, 256):
        x = torch.randn(t, cfg.d_model, device=dev).to(torch.bfloat16)
        _piece(f"mixtral one MoE layer (T={t})",
               lambda: moe_block(ffn, x, cfg), reps, results)
    del params, first, cache
    gc.collect()
    torch.cuda.empty_cache()


def profile_whisper(seed: int, reps: int, dev, results):
    """whisper-small's encoder, prefill and decode step."""
    from repro_torch.models.stacked import Ctx
    cfg = get_config("whisper-small")
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    b, enc = 4, model.enc_len
    frames = (torch.randn(b, enc, cfg.d_model, device=dev) * 0.02).to(
        torch.bfloat16)
    tokens = torch.randint(2, cfg.vocab_size, (b, 4), device=dev)
    layer = tree_map(lambda w: w[0], params["stacks"]["encoder"])
    ctx = Ctx(mode="train", positions=torch.arange(
        enc, dtype=torch.int32, device=dev))
    _piece(f"whisper one encoder layer (B={b}, S={enc})",
           lambda: model.stacks["encoder"].apply(layer, frames, ctx, None),
           reps, results)
    _piece(f"whisper encoder ({cfg.encoder_layers} layers)",
           lambda: model.encode(params, frames), reps, results)
    batch = {"frames": frames, "tokens": tokens}
    _piece("whisper prefill (encoder + decoder, prompt 4)",
           lambda: model.prefill(params, batch), reps, results)
    cache = model.init_cache(b, 36, device=dev,
                             fill=model.prefill(params, batch)[1])
    step = {"token": tokens[:, 0],
            "positions": torch.full((b,), 20, dtype=torch.int32, device=dev)}
    _piece(f"whisper decode step (B={b}, {cfg.num_layers} layers)",
           lambda: model.decode(params, cache, step), reps, results)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()


def profile_families(seed: int, reps: int, dev, results):
    """The hybrid, ssm and vlm families' prefill, blocks and decode step
    (the module docstring's last list)."""
    from repro_torch.configs.llama_3_2_vision_90b import ONE_CARD_LAYERS
    from repro_torch.models import hybrid, transformer, xlstm

    def pos(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    for arch, s in (("recurrentgemma-9b", 2300), ("xlstm-1.3b", 1024),
                    ("llama-3.2-vision-90b", 1024)):
        cfg = get_config(arch)
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, num_layers=ONE_CARD_LAYERS)
        model = build_model(cfg)
        params = model.init(seed, device=dev)
        if cfg.family == "vlm":
            params["stacks"]["blocks"]["cross"]["attn"]["gate"].fill_(1.0)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = {"tokens": torch.randint(2, cfg.vocab_size, (1, s),
                                         generator=gen, device=dev)}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (1, transformer.cfg_n_patches(cfg), cfg.d_model),
                generator=gen, device=dev).to(torch.bfloat16)
        # the long prefills (the sLSTM token loop) take seconds: two reps
        _piece(f"{arch} prefill (B=1, S={s}, {cfg.num_layers} layers)",
               lambda: model.prefill(params, batch), 2, results,
               profile=False)
        x = torch.randn((1, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        group = tree_map(lambda w: w[0], params["stacks"]["blocks"])
        cache = tree_map(lambda c: c[0],
                         model.init_cache(1, s, device=dev)["blocks"])
        ctx = model.make_ctx("prefill", pos(s), patches=batch.get("patches"))
        if cfg.family == "hybrid":
            _piece(f"{arch} one superblock prefill (S={s})",
                   lambda: model.stacks["blocks"].apply(group, x, ctx, cache),
                   reps, results)
            _piece(f"{arch} one RG-LRU block prefill (S={s})",
                   lambda: hybrid.rglru_block(group["l0"]["mix"], x, ctx,
                                              cache["l0"], cfg),
                   reps, results)
            a = torch.rand((1, s, cfg.d_model), generator=gen, device=dev)
            _piece(f"{arch} RG-LRU doubling scan alone ([1, {s}, "
                   f"{cfg.d_model}] fp32)",
                   lambda: hybrid.linear_scan(a, a), reps, results)
            _piece(f"{arch} one local-attention block prefill (S={s}, "
                   f"W={cfg.window}, hd {cfg.resolved_head_dim})",
                   lambda: transformer.self_attn_block(
                       group["l2"]["mix"], x, ctx, cache["l2"], cfg),
                   reps, results)
        elif cfg.family == "ssm":
            _piece(f"{arch} one sLSTM block prefill (S={s}: a token loop)",
                   lambda: xlstm.slstm_block(group["slstm"], x, ctx,
                                             cache["slstm"], cfg),
                   2, results, profile=False)
            short = x[:, :128]
            _piece(f"{arch} one sLSTM block prefill (S=128)",
                   lambda: xlstm.slstm_block(group["slstm"], short, ctx,
                                             cache["slstm"], cfg),
                   reps, results)
            one = tree_map(lambda w: w[0], group["mlstm"])
            _piece(f"{arch} one mLSTM block prefill (S={s}, chunks of "
                   f"{xlstm.CHUNK})",
                   lambda: xlstm.mlstm_block(
                       one, x, ctx, tree_map(lambda c: c[0],
                                             cache["mlstm"]), cfg),
                   reps, results)
        else:
            _piece(f"{arch} one cross-attention block prefill (S={s}, "
                   f"{transformer.cfg_n_patches(cfg)} patches)",
                   lambda: transformer.cross_attn_block(
                       group["cross"]["attn"], x, ctx, cache["cross"], cfg),
                   reps, results)
            _piece(f"{arch} one self-attention layer prefill (S={s})",
                   lambda: transformer.mlp_block(
                       group["self0"]["ffn"], transformer.self_attn_block(
                           group["self0"]["attn"], x, ctx, cache["self0"],
                           cfg), cfg),
                   reps, results)
        del cache, group, x
        lens = torch.tensor([2300, 1024, 300, 64], dtype=torch.int32,
                            device=dev)
        dcache = model.init_cache(4, 2300 + 32, device=dev)
        step = {"token": torch.randint(2, cfg.vocab_size, (4,),
                                       generator=gen, device=dev,
                                       dtype=torch.int32),
                "positions": lens}
        _piece(f"{arch} decode step (B=4, contexts 64-2300)",
               lambda: model.decode(params, dcache, step), reps, results)
        del model, params, dcache, batch
        gc.collect()
        torch.cuda.empty_cache()


def profile_dense(args, dev, results):
    """The dense model's pieces (the module docstring's first list)."""
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    first, last = split_for_pp(model, params, 2)
    n_blocks = 4 * 40 + 1
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    tables = i32(np.arange(4 * 40).reshape(4, 40))
    caches = [model.paged_cache(s.n_groups, n_blocks, BS, device=dev)
              for s in (first, last)]

    tok, pos = i32([1, 2, 3, 4]), i32([500, 400, 300, 600])
    _piece("first stage decode step (B=4)",
           lambda: first.decode_fn(first.params, caches[0], tok, pos, tables),
           args.reps, results, graph=True)
    span = i32(np.arange(256))
    span_pos = i32(np.concatenate([np.arange(64) + 100 * i for i in range(4)]))
    span_seq = i32(np.repeat(np.arange(4), 64))
    last_idx = i32([63, 127, 191, 255])
    _piece("first stage chunk step (T=256)",
           lambda: first.chunk_fn(first.params, caches[0], span, span_pos,
                                  span_seq, last_idx, tables),
           args.reps, results)
    # the contiguous layout: the same steps over 8 rows of 640 slots
    rows = model.row_cache(first.n_groups, 8, 640, device=dev)
    batch_rows = i32([5, 2, 7, 0])
    _piece("first stage decode step, contiguous rows (B=4)",
           lambda: first.decode_fn(first.params, rows, tok, pos,
                                   rows=batch_rows), args.reps, results,
           graph=True)
    _piece("first stage chunk step, contiguous rows (T=256)",
           lambda: first.chunk_fn(first.params, rows, span, span_pos,
                                  span_seq, last_idx, rows=batch_rows),
           args.reps, results)
    del rows
    prompts = i32(np.random.default_rng(args.seed).integers(
        2, cfg.vocab_size, (4, 397)))
    lens = i32([397, 260, 141, 78])
    _piece("first stage prefill step (B=4, S=397)",
           lambda: first.prefill_fn(first.params, prompts, 0, lens - 1),
           args.reps, results)
    # the same stage over the int8 cache (the weights are the same)
    model_q = build_model(cfg, ModelOptions(kv_quant=True))
    first_q = split_for_pp(model_q, params, 2)[0]
    cache_q = model_q.paged_cache(first_q.n_groups, n_blocks, BS, device=dev)
    _piece("first stage decode step, int8 cache (B=4)",
           lambda: first_q.decode_fn(first_q.params, cache_q, tok, pos,
                                     tables), args.reps, results, graph=True)
    _piece("first stage chunk step, int8 cache (T=256)",
           lambda: first_q.chunk_fn(first_q.params, cache_q, span, span_pos,
                                    span_seq, last_idx, tables),
           args.reps, results)
    hidden = torch.randn(4, cfg.d_model, device=dev).to(torch.bfloat16)
    logits = []
    _piece("last stage decode step + logits to host",
           lambda: logits.append(last.decode_fn(
               last.params, caches[1], hidden, pos, tables).float().cpu().numpy()),
           args.reps, results, profile=False)

    sampler = ColumnWiseSampler(cfg.vocab_size, 4, pp_degree=2, max_len=640,
                                seed=args.seed)
    for name, sp in (("sampler (serving params)", SamplingParams(
            temperature=0.8, top_k=40, top_p=0.95, frequency_penalty=0.2,
            presence_penalty=0.1)), ("sampler (greedy)",
                                     SamplingParams(greedy=True))):
        t0 = time.perf_counter()
        for _ in range(args.reps):
            sampler.sample(logits[-1], [sp] * 4, slot=0, seq_ids=[0, 1, 2, 3])
        results[name] = {"host_ms": (time.perf_counter() - t0) / args.reps * 1e3}
        print(f"{name}: {json.dumps(results[name])}", flush=True)
    del params, first, last, caches, first_q, cache_q
    gc.collect()
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="dense,mixtral,whisper,families",
                    help="comma-separated subset of dense (the --arch "
                         "model), mixtral, whisper, families")
    args = ap.parse_args()
    parts = args.parts.split(",")
    dev = resolve_device(None)
    results = {}
    if "dense" in parts:
        profile_dense(args, dev, results)
    if "mixtral" in parts:
        profile_mixtral(args.seed, args.reps, dev, results)
    if "whisper" in parts:
        profile_whisper(args.seed, args.reps, dev, results)
    if "families" in parts:
        profile_families(args.seed, args.reps, dev, results)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"arch": args.arch, "card": smi, "pieces": results}))


if __name__ == "__main__":
    main()
