"""The port's SiPipe engine against the reference engine on the same
workload: stablelm-1.6b-smoke with the reference's weights (through
``params_from_jax``), the paged KV layout, under monolithic prefill and
the span policies, with a bf16/fp32 or an int8 KV cache, on the CPU.

Both engines must make the same scheduling decisions, iteration for
iteration: members, spans, sampling points and, under the synchronous
NaivePPEngine, block tables and CoW copies too.  (Under SiPipeEngine a
finished sequence's blocks return to the free list on the sampling
thread, concurrently with the next schedule, so physical block ids
depend on timing, in the reference as in the port; there the trace is
compared without them.)  In fp32 (parameters and KV cache, in both
engines) greedy streams must be equal token for token.  In bf16 the two
frameworks round differently (tests/test_torch_model.py), so a near-tie
between the top two logits can flip a greedy token; there the schedule,
which does not depend on token values, is compared, and the streams
only by length.  The int8 cache is compared in fp32 too: its
quantization is the same function in both packages (quantize_kv is
bit-exact, tests/test_torch_kernels.py), and its int8 dots are exact."""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro.models import ModelOptions as RefModelOptions
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import span_attention as ksa
from repro_torch.launch import serve
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map

ARCH = "stablelm-1.6b-smoke"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return (ref_model, ref_params), (build_model(get_config(ARCH)), params)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, 256, size=n))) for n in lens]


def _reference_in_fp32(eng):
    """The reference engine allocates its KV cache and takes hidden states
    between stages in bf16 whatever the parameters' dtype.  For an fp32
    parity run, give it an fp32 cache (before any request runs; an int8
    cache and its bf16 scales stay as they are) and fp32 copies of its
    inter-stage hand-offs: ``recv_hidden`` (engine.py:611) and the
    prefill pass's (engine.py:866), as the port has."""
    for w in eng.stages:
        w.cache = jax.tree.map(
            lambda c: c.astype(jnp.float32) if c.dtype == jnp.bfloat16
            and c.ndim == 5 else c, w.cache)

    def recv_hidden(stage, iteration):
        deadline = time.monotonic() + 60
        with eng._hcv:
            while (stage, iteration) not in eng._hidden:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"hidden for stage {stage}")
                eng._hcv.wait(1.0)
            ch = eng._hidden.pop((stage, iteration))
        return jnp.asarray(ch.recv()["hidden"], jnp.float32)

    eng.recv_hidden = recv_hidden
    held = {}
    for w in eng.stages:
        def run_prefill(seqs, x, pos0, rows, last_idx, tables,
                        run=w.run_prefill, first=w.stage.is_first):
            if not first:     # the previous stage's fp32 output, unrounded
                x = jnp.asarray(held["x"], jnp.float32)
            held["x"] = run(seqs, x, pos0, rows, last_idx, tables)
            return held["x"]
        w.run_prefill = run_prefill


def _run(pkg, engine_cls, sp_cls, model, params, prompts, *, n_new, policy,
         n=1, kv_blocks=None):
    chunk = None if policy == "monolithic" else 6
    cfg = pkg.EngineConfig(pp_degree=2, max_batch=2, max_seq_len=64,
                           n_samplers=2, prefill_chunk_tokens=chunk,
                           scheduling_policy=policy, kv_layout="paged",
                           kv_block_size=8, kv_blocks=kv_blocks)
    eng = getattr(pkg, engine_cls)(model, params, cfg)
    if pkg is ref_engine and params["embed"].dtype == jnp.float32:
        _reference_in_fp32(eng)
    trace = []
    schedule = eng.scheduler.schedule

    def record(it):
        s = schedule(it)
        if s is not None:
            trace.append((s.iteration, list(s.seq_ids), s.spans,
                          s.needs_sample, s.block_tables.tolist(),
                          None if s.block_copies is None
                          else s.block_copies.tolist()))
        return s

    eng.scheduler.schedule = record
    for p in prompts:
        eng.add_request(p, sp_cls(greedy=True, max_new_tokens=n_new, n=n))
    done = sorted(eng.run(), key=lambda s: s.seq_id)
    streams = [(s.seq_id, list(s.output_ids)) for s in done]
    return streams, trace, eng.metrics()


def _quant_models(models):
    """The fixture's models rebuilt with the int8 KV cache (the weights
    are the same: ``kv_quant`` changes only the cache)."""
    (_, ref_params), (_, params) = models
    ref_model = ref_build_model(ref_get_config(ARCH), ShardCtx.single(),
                                RefModelOptions(kv_quant=True))
    model = build_model(get_config(ARCH), ModelOptions(kv_quant=True))
    return (ref_model, ref_params), (model, params)


def _both(models, engine_cls, dtype, policy, lens, n_new, n, kv_blocks,
          kv_quant=False):
    if kv_quant:
        models = _quant_models(models)
    (ref_model, ref_params), (model, params) = models
    ref_params = jax.tree.map(lambda a: a.astype(dtype), ref_params)
    params = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    prompts = _prompts(lens)
    kw = dict(n_new=n_new, policy=policy, n=n, kv_blocks=kv_blocks)
    ref = _run(ref_engine, engine_cls, RefSamplingParams, ref_model,
               ref_params, prompts, **kw)
    port = _run(engine, engine_cls, SamplingParams, model, params, prompts,
                **kw)
    for streams, trace, m in (ref, port):
        assert len(trace) > len(prompts)
        assert len(streams) == len(prompts)  # run() returns the primaries
        assert all(len(s) == n_new for _, s in streams)
        assert m["tokens"] == len(prompts) * n * n_new
        assert m["kv_blocks_free"] == m["kv_blocks_total"]
    if dtype == "float32":
        assert port[0] == ref[0]
    return ref, port


def _naive_parity(models, dtype, policy, lens, n_new, n, kv_blocks,
                  kv_quant=False):
    (_, ref_trace, ref_m), (_, trace, m) = _both(
        models, "NaivePPEngine", dtype, policy, lens, n_new, n, kv_blocks,
        kv_quant)
    assert len(trace) == len(ref_trace)
    for got, want in zip(trace, ref_trace):
        assert got == want
    for key in ("tokens", "requests_finished", "kv_preemptions",
                "kv_cow_copies", "kv_prefix_hits", "kv_table_widths",
                "incremental_hits", "meta_rebuilds", "policy"):
        assert m[key] == ref_m[key], key
    if n > 1:
        assert any(t[5] for t in trace)      # CoW copies were applied


@pytest.mark.parametrize("dtype,policy,lens,n_new,n,kv_blocks", [
    ("float32", "chunked", [13, 5, 21, 9], 6, 1, None),
    ("bfloat16", "chunked", [13, 5, 21, 9], 6, 1, None),
    ("float32", "disaggregated", [11, 7, 17], 5, 1, None),
    # parallel sampling: forks share the prompt's blocks copy-on-write
    # under block pressure, so CoW copies and preemption both run
    ("float32", "chunked", [14, 10], 5, 2, 10),
])
def test_naive_engine_trace_and_streams_match_reference(
        models, dtype, policy, lens, n_new, n, kv_blocks):
    _naive_parity(models, dtype, policy, lens, n_new, n, kv_blocks)


@pytest.mark.parametrize("dtype,policy,lens,n_new,n,kv_blocks,kv_quant", [
    # monolithic prefill: whole prompts through prefill_fn, written into
    # the paged cache block by block
    ("float32", "monolithic", [13, 5, 21, 9], 6, 1, None, False),
    ("bfloat16", "monolithic", [13, 5, 21, 9], 6, 1, None, False),
    # monolithic admission with forks under block pressure: fork children
    # skip prefill, shared blocks are write-masked, CoW copies ride the
    # admitting schedule
    ("float32", "monolithic", [14, 10], 5, 2, 10, False),
    # the int8 KV cache under both prefill paths
    ("float32", "monolithic", [13, 5, 21, 9], 6, 1, None, True),
    ("float32", "chunked", [13, 5, 21, 9], 6, 1, None, True),
])
def test_naive_engine_monolithic_and_int8_match_reference(
        models, dtype, policy, lens, n_new, n, kv_blocks, kv_quant):
    _naive_parity(models, dtype, policy, lens, n_new, n, kv_blocks,
                  kv_quant)


def _sipipe_parity(models, policy, lens, n_new, kv_quant=False):
    (_, ref_trace, _), (_, trace, _) = _both(
        models, "SiPipeEngine", "float32", policy, lens, n_new, 1, None,
        kv_quant)
    assert [t[:4] for t in trace] == [t[:4] for t in ref_trace]


@pytest.mark.parametrize("policy,lens,n_new", [
    ("chunked", [13, 5, 21, 9], 6),
    ("disaggregated", [11, 7, 17], 5),
])
def test_sipipe_engine_streams_and_schedule_match_reference(
        models, policy, lens, n_new):
    _sipipe_parity(models, policy, lens, n_new)


@pytest.mark.parametrize("kv_quant,lens,n_new", [
    (False, [13, 5, 21, 9], 6),
    (True, [11, 7, 17], 5),
])
def test_sipipe_engine_monolithic_matches_reference(models, kv_quant, lens,
                                                    n_new):
    _sipipe_parity(models, "monolithic", lens, n_new, kv_quant)


def test_chunked_int8_kv_token_identical_to_monolithic():
    """The reference's pin (tests/test_chunked_prefill.py:228-243) on the
    port: with the int8 cache, monolithic prefill attends full-precision
    K/V and chunks attend the int8 cache, so prompt-final logits differ by
    design, but greedy tokens agree on the reference's seed and prompts
    (bf16 weights of ``init(key(4))``, as there)."""
    ref_params = ref_build_model(ref_get_config(ARCH)).init(jax.random.key(4))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    model = build_model(get_config(ARCH), ModelOptions(kv_quant=True))
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(2, 256, size=n))) for n in (11, 5)]

    def run(chunk):
        eng = engine.SiPipeEngine(model, params, engine.EngineConfig(
            pp_degree=2, max_batch=2, max_seq_len=64, n_samplers=2,
            prefill_chunk_tokens=chunk))
        for p in prompts:
            eng.add_request(p, SamplingParams(greedy=True, max_new_tokens=4))
        done = sorted(eng.run(), key=lambda s: s.seq_id)
        assert eng.metrics()["policy"] == ("chunked" if chunk else
                                           "monolithic")
        return [list(s.output_ids) for s in done]

    mono = run(None)
    assert len(mono) == 2 and all(len(s) == 4 for s in mono)
    assert run(6) == mono


def test_unported_configurations_raise(models):
    _, (model, params) = models
    # the contiguous layout is served (tests/test_torch_contiguous*.py):
    # asked for, under either policy, it keeps one row per sequence and
    # no block manager
    cfg = model.cfg
    for chunk in (8, None):
        eng = engine.SiPipeEngine(model, params, engine.EngineConfig(
            kv_layout="contiguous", prefill_chunk_tokens=chunk,
            max_seq_len=32))
        assert eng.cfg.kv_layout == "contiguous" and not eng.paged
        assert eng.kv_manager is None
        assert eng.stages[0].cache["l0"]["k"].shape == (
            eng.stages[0].stage.n_groups, 8, 32, cfg.num_kv_heads,
            cfg.resolved_head_dim)
        eng.shutdown()
    with pytest.raises(ValueError, match="kv_layout"):
        engine.SiPipeEngine(model, params, engine.EngineConfig(
            kv_layout="virtual", prefill_chunk_tokens=8))
    # windowed and MoE models run (tests/test_torch_moe.py); a window that
    # is not a block multiple takes contiguous rolling rows under the
    # default layout, as in the reference.  What still raises: the hybrid
    # family, which builds and runs through the model API
    # (tests/test_torch_families.py).  A shared expert, fused or not, is
    # served
    # (tests/test_torch_configs.py)
    windowed = build_model(dataclasses.replace(get_config(ARCH), window=20))
    eng = engine.SiPipeEngine(windowed, params, engine.EngineConfig())
    assert eng.cfg.kv_layout == "contiguous"
    assert eng.stages[0].cache["l0"]["v"].shape[1:3] == (8, 20)
    eng.shutdown()
    with pytest.raises(NotImplementedError, match="hybrid"):
        engine.SiPipeEngine(dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, family="hybrid")),
            params, engine.EngineConfig())
    hybrid = build_model(get_config("recurrentgemma-9b-smoke"))
    with pytest.raises(NotImplementedError, match="hybrid"):
        engine.SiPipeEngine(hybrid, hybrid.init(0, device="cpu"),
                            engine.EngineConfig())
    moe = get_config("mixtral-8x7b-smoke")
    shared = build_model(dataclasses.replace(
        moe, moe=dataclasses.replace(moe.moe, shared=True)),
        ModelOptions(fuse_shared_expert=True))
    assert "shared_w1" in shared.specs["stacks"]["blocks"]["l0"]["ffn"]
    eng = engine.SiPipeEngine(shared, shared.init(0, device="cpu"),
                              engine.EngineConfig())
    eng.shutdown()


def test_entry_points_default_to_cuda_and_refuse_the_cpu_silently(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(ARCH, chunk_tokens=8, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run_online(ARCH, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_http_server(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run_http(ARCH, smoke=True)
    assert resolve_device("cpu") == torch.device("cpu")


KERNELS = (ksa.paged_span_attention, kda.paged_decode_attention,
           kfa.flash_attention, ksa.paged_span_attention_quant,
           kda.paged_decode_attention_quant,
           ksa.paged_span_attention_rolling,
           ksa.paged_span_attention_rolling_quant,
           kda.paged_decode_attention_rolling,
           kda.paged_decode_attention_quant_rolling)


def test_serve_cpu_run_counts_no_kernel_launches():
    before = [k.launches for k in KERNELS]
    m = serve.run(ARCH, requests=3, max_new_tokens=4, chunk_tokens=8,
                  device="cpu", verbose=False)
    assert m["finished"] == 3 and m["device"] == "cpu"
    assert m["policy"] == "chunked" and m["kv_layout"] == "paged"
    assert [k.launches for k in KERNELS] == before


def test_serve_cpu_default_is_monolithic_and_counts_no_launches():
    """``--chunk-tokens 0`` (the CLI's default) serves monolithically;
    on the CPU the plain versions run and no kernel counts a launch."""
    before = [k.launches for k in KERNELS]
    m = serve.run(ARCH, requests=3, max_new_tokens=4, device="cpu",
                  verbose=False)
    assert m["finished"] == 3 and m["policy"] == "monolithic"
    assert m["kv_blocks_free"] == m["kv_blocks_total"]
    assert [k.launches for k in KERNELS] == before


def test_port_runs_without_jax_or_the_reference():
    """``import repro_torch`` and CPU engine runs (chunked, monolithic,
    and monolithic then chunked over the int8 cache; mixtral-8x7b-smoke,
    windowed MoE, chunked and monolithic), whisper-small-smoke's
    prefill and decode through the model API, both fused ops of
    ``repro_torch.kernels.ops``, the launcher's HTTP smoke (the serving
    front end over a real engine) and an online replay with aborts and an
    offline request, load neither ``jax`` nor any module of ``repro``."""
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core.engine import EngineConfig, SiPipeEngine\n"
        "from repro_torch.core.sampling_params import SamplingParams\n"
        "from repro_torch.models.registry import ModelOptions, build_model\n"
        "from repro_torch.launch import serve\n"
        f"m = serve.run('{ARCH}', requests=2, max_new_tokens=3,"
        " chunk_tokens=8, device='cpu', verbose=False)\n"
        "assert m['finished'] == 2, m['finished']\n"
        f"model = build_model(get_config('{ARCH}'), "
        "ModelOptions(kv_quant=True))\n"
        "params = model.init(0, device='cpu')\n"
        "for chunk in (None, 8):\n"
        "    eng = SiPipeEngine(model, params, EngineConfig(max_seq_len=64,"
        " prefill_chunk_tokens=chunk))\n"
        "    for n in (9, 4):\n"
        "        eng.add_request(list(range(2, 2 + n)), SamplingParams("
        "greedy=True, max_new_tokens=3))\n"
        "    assert len(eng.run()) == 2\n"
        f"m = serve.run('{ARCH}', requests=2, max_new_tokens=3,"
        " device='cpu', verbose=False)\n"
        "assert m['finished'] == 2 and m['policy'] == 'monolithic'\n"
        "for chunk in (8, 0):\n"
        "    m = serve.run('mixtral-8x7b-smoke', requests=3,"
        " max_new_tokens=3, max_seq_len=128, chunk_tokens=chunk,"
        " device='cpu', verbose=False)\n"
        "    assert m['finished'] == 3, m['finished']\n"
        "import torch\n"
        "whisper = build_model(get_config('whisper-small-smoke'), "
        "enc_len=70)\n"
        "wp = whisper.init(0, device='cpu')\n"
        "logits, c = whisper.prefill(wp, {'frames': torch.zeros(1, 70, 64,"
        " dtype=torch.bfloat16), 'tokens': torch.tensor([[3, 4]])})\n"
        "cache = whisper.init_cache(1, 4, device='cpu', fill=c)\n"
        "logits, cache = whisper.decode(wp, cache, {'token': torch.tensor("
        "[5]), 'positions': torch.tensor([2], dtype=torch.int32)})\n"
        "assert logits.shape == (1, 256) and bool(torch.isfinite(logits)"
        ".all())\n"
        "from repro_torch.kernels import ops\n"
        "x = torch.ones(2, 3, 32, dtype=torch.bfloat16)\n"
        "w = torch.full((32, 48), 0.01, dtype=torch.bfloat16)\n"
        "y = ops.swiglu_fused(x, w, w, w.T.contiguous())\n"
        "z = ops.rmsnorm_matmul_fused(x, x[0, 0], w)\n"
        "assert y.shape == (2, 3, 32) and z.shape == (2, 3, 48)\n"
        f"assert serve.run_http('{ARCH}', smoke=True, device='cpu',"
        " max_seq_len=64) == 0\n"
        f"m = serve.run_online('{ARCH}', requests=4, max_new_tokens=4,"
        " abort_every=2, offline_requests=1, arrival_rate=100.0,"
        " device='cpu', verbose=False)\n"
        "assert m['aborted'] >= 1 and m['offline_finished'] == 1, m\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
