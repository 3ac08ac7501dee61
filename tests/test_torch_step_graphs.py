"""The port's compiled stage step (``repro_torch.core.step_graphs``) on the
CPU, where CUDA graphs do not exist: a fake backend stands in for capture
and replay (a "graph" is the captured call, replayed into its static
output), so the keys, the static inputs, the launch counting and the
engine's graph path run here; the card runs the real graphs
(``chip_smoke.py``).

The decode keys must be the reference's compile keys: per stage, as many
graphs as the reference's jitted ``decode_fn`` holds executables
(``_cache_size()``) on the same workload, paged with a capped table
ladder, over contiguous rows, and under the disaggregated policy with
decode enlargement.  Graph runs must give the eager runs' streams, and
the cache tensors a graph binds must never be rebound."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.core.step_graphs import StepGraphs
from repro_torch.kernels import _paged
from repro_torch.models.registry import build_model

ARCH = "stablelm-1.6b-smoke"


class FakeGraphs:
    """:class:`~repro_torch.core.step_graphs.CudaGraphs` on the CPU.  A
    capture runs the call once more (a decode step rewrites the same
    slots with the same values) and keeps it with its output; a replay
    runs it again into that output.  ``fail`` makes captures (or, with
    ``"replay"``, replays) raise, as a refused capture does."""

    def __init__(self, fail=None):
        self.fail = fail
        self.captures = 0
        self.replays = 0

    @contextlib.contextmanager
    def active(self):
        yield

    def static(self, a):
        return torch.from_numpy(a.copy()), None

    def upload(self, static, a):
        static[0].copy_(torch.tensor(a))

    def download(self, out):
        return out.numpy().copy()

    def capture(self, fn):
        if self.fail == "capture":
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        self.captures += 1
        out = fn()
        return [fn, out], out

    def replay(self, graph):
        if self.fail == "replay":
            raise RuntimeError("graph replay failed")
        self.replays += 1
        with _paged.record_launches():    # a replay runs no Python wrapper
            graph[1].copy_(graph[0]())


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


def _with_graphs(eng, backend=FakeGraphs):
    for w in eng.stages:
        w.graphs = StepGraphs(backend())
    return eng


def _run(pkg, sp_cls, model, params, prompts, n_new, *, graphs=False,
         offline=(), **cfg):
    eng = pkg.NaivePPEngine(model, params, pkg.EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, n_samplers=2,
        kv_block_size=8, **cfg))
    if graphs:
        _with_graphs(eng)
    for p in prompts:
        eng.add_request(p, sp_cls(greedy=True, max_new_tokens=n_new))
    for p in offline:
        eng.add_request(p, sp_cls(greedy=True, max_new_tokens=n_new,
                                  tier="offline"))
    while eng.has_work:
        eng.step()
    eng.shutdown()
    streams = sorted((s.seq_id, list(s.output_ids))
                     for s in eng.scheduler.finished)
    return eng, streams


WORKLOADS = {
    # a capped ladder of two table widths over prompts of 5-33 tokens
    "paged chunked": dict(
        lens=[13, 5, 33, 9, 21], n_new=6, offline=(),
        cfg=dict(kv_layout="paged", max_table_buckets=2,
                 prefill_chunk_tokens=6, scheduling_policy="chunked")),
    "paged monolithic": dict(
        lens=[13, 5, 33, 9], n_new=6, offline=(),
        cfg=dict(kv_layout="paged", max_table_buckets=2)),
    "contiguous": dict(
        lens=[13, 5, 21, 9, 17], n_new=6, offline=(),
        cfg=dict(kv_layout="contiguous", prefill_chunk_tokens=6,
                 scheduling_policy="chunked")),
    # offline members enlarge the decode batch to the 2x rung (four or
    # more members a slot; tests/test_hybrid.py's offline-only workload)
    "disaggregated enlarged": dict(
        lens=[], n_new=5, offline=[6, 5, 7, 4, 6, 5, 4, 6, 5, 7, 4, 5],
        cfg=dict(kv_layout="paged", prefill_chunk_tokens=8,
                 scheduling_policy="disaggregated",
                 decode_enlarge_factor=2, kv_blocks=40)),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_decode_keys_match_reference_compiles(models, name):
    """Per stage, the port's decode graphs equal the reference's
    ``decode_fn`` executables on the same workload, and the graph run's
    greedy streams equal the eager run's."""
    w = WORKLOADS[name]
    (ref_model, ref_params), (model, params) = models
    prompts, offline = _prompts(w["lens"]), _prompts(w["offline"], seed=1)
    ref, _ = _run(ref_engine, RefSamplingParams, ref_model, ref_params,
                  prompts, w["n_new"], offline=offline, **w["cfg"])
    want = [s.stage.decode_fn._cache_size() for s in ref.stages]
    eng, streams = _run(engine, SamplingParams, model, params, prompts,
                        w["n_new"], graphs=True, offline=offline,
                        **w["cfg"])
    got = [len(s.graphs) for s in eng.stages]
    assert got == want
    assert min(got) >= 1
    if name == "paged chunked":
        assert len(eng.kv_manager.table_widths) == 2
    if name == "disaggregated enlarged":
        assert eng.scheduler.policy.enlarged_decode_iters > 0
    assert eng.compile_stats() == {"jit_executables": sum(got)}
    m = eng.metrics()
    assert m["jit_executables"] == sum(got)
    assert [s["graphs"] for s in m["stages"]] == got
    assert all(s["graph_replays"] > 0 for s in m["stages"])
    _, eager = _run(engine, SamplingParams, model, params, prompts,
                    w["n_new"], offline=offline, **w["cfg"])
    assert streams == eager


def test_first_sight_captures_later_sights_replay_and_count_launches():
    """The first call of a key runs the step eagerly (its launches count)
    and captures it (its launches are recorded, not counted); each later
    call replays, and adds the recorded launches."""
    def kernel():
        pass
    kernel.launches = 0
    calls = []

    def step(x, positions):
        calls.append(x.clone())
        _paged.count_launch(kernel)
        _paged.count_launch(kernel)
        return (x * 2 + positions).float()

    backend = FakeGraphs()
    graphs = StepGraphs(backend)
    ins = lambda v: {"x": np.full(3, v, np.int32),
                     "positions": np.arange(3, dtype=np.int32)}
    out = graphs.run((3,), ins(1), step)
    np.testing.assert_array_equal(out, [2, 3, 4])
    assert (backend.captures, backend.replays, len(graphs)) == (1, 0, 1)
    assert kernel.launches == 2          # the eager step; not the capture
    for v in (5, 7):
        out = graphs.run((3,), ins(v), step)
        np.testing.assert_array_equal(out, 2 * v + np.arange(3))
    assert (backend.captures, backend.replays, graphs.replays) == (1, 2, 2)
    assert kernel.launches == 2 + 2 * 2
    # the arrays handed out are not the static output a replay rewrites
    first = graphs.run((3,), ins(9), step)
    graphs.run((3,), ins(11), step)
    np.testing.assert_array_equal(first, 18 + np.arange(3))
    # a new key is a new graph; the recorded launches were not counted
    graphs.run((2,), {"x": np.ones(2, np.int32),
                      "positions": np.zeros(2, np.int32)}, step)
    assert (backend.captures, len(graphs)) == (2, 2)
    assert kernel.launches == 2 + 2 * 4 + 2
    assert graphs.capture_s >= 0.0


@pytest.mark.parametrize("fail", ["capture", "replay"])
def test_graph_failures_raise_and_never_fall_back(fail):
    """A failed capture or replay raises out of ``run``; the step does not
    run eagerly in its place."""
    backend = FakeGraphs(fail=fail)
    graphs = StepGraphs(backend)
    calls = []

    def step(x):
        calls.append(1)
        return x.float()

    ins = {"x": np.zeros(2, np.int32)}
    if fail == "capture":
        with pytest.raises(RuntimeError, match="capturing"):
            graphs.run((2,), ins, step)
        assert len(graphs) == 0 and len(calls) == 1   # the first sight only
        return
    graphs.run((2,), ins, step)
    n = len(calls)
    with pytest.raises(RuntimeError, match="replay"):
        graphs.run((2,), ins, step)
    assert len(calls) == n and graphs.replays == 0


def test_failing_capture_raises_out_of_the_engine(models):
    """In the engine a refused capture ends the run with its error; no
    decode step is served eagerly instead."""
    _, (model, params) = models
    eng = engine.NaivePPEngine(model, params, engine.EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, kv_block_size=8))
    _with_graphs(eng, lambda: FakeGraphs(fail="capture"))
    eng.add_request(_prompts([9])[0], SamplingParams(greedy=True,
                                                     max_new_tokens=4))
    with pytest.raises(RuntimeError, match="capturing"):
        while eng.has_work:
            eng.step()
    eng.shutdown()


def test_cuda_graphs_on_the_cpu_raise_and_default_off(models):
    _, (model, params) = models
    with pytest.raises(ValueError, match="cuda_graphs"):
        engine.SiPipeEngine(model, params, engine.EngineConfig(
            cuda_graphs=True))
    eng = engine.SiPipeEngine(model, params, engine.EngineConfig())
    assert eng.cfg.cuda_graphs is False
    assert all(w.graphs is None for w in eng.stages)
    eng.add_request(_prompts([7])[0], SamplingParams(greedy=True,
                                                     max_new_tokens=3))
    eng.run()
    m = eng.metrics()
    assert m["jit_executables"] == 0
    assert all(s["graphs"] == s["graph_replays"] == 0 for s in m["stages"])


def _leaf_ptrs(eng):
    return {(i, lk, kk): t.data_ptr()
            for i, w in enumerate(eng.stages)
            for lk, layer in w.cache.items() for kk, t in layer.items()}


@pytest.mark.parametrize("case", [
    "chunked", "monolithic", "prefix cow", "preemption chunked",
    "preemption monolithic", "rows chunked", "rows monolithic"])
def test_cache_tensors_are_never_rebound(models, case):
    """A graph holds the cache leaves' addresses: chunked and monolithic
    runs (the prefill writes), a prefix hit with copy-on-write forks (the
    block copies) and preemption must all write in place."""
    _, (model, params) = models
    prompts, n, n_new = _prompts([13, 5, 21, 9]), 1, 5
    cfg = dict(pp_degree=2, max_batch=2, max_seq_len=64, kv_block_size=8)
    if case.endswith("chunked"):
        cfg.update(prefill_chunk_tokens=6, scheduling_policy="chunked")
    if case.startswith("rows"):
        cfg.update(kv_layout="contiguous")
    if case == "prefix cow":
        # a shared 16-token prefix (two full blocks), two forks each; the
        # second request comes once the first has cached the prefix
        prefix = _prompts([16], seed=3)[0]
        prompts, n = [prefix + p for p in _prompts([5, 9], seed=4)], 2
    if case.startswith("preemption"):
        # four 50-token sequences over 10 blocks of 8 slots
        cfg.update(kv_blocks=10)
        prompts, n_new = _prompts([30, 30, 30, 30]), 20
    eng = _with_graphs(engine.NaivePPEngine(model, params,
                                            engine.EngineConfig(**cfg)))
    before = _leaf_ptrs(eng)
    for p in prompts:
        eng.add_request(p, SamplingParams(greedy=True, max_new_tokens=n_new,
                                          n=n))
        if case == "prefix cow":
            while eng.has_work:
                eng.step()
    while eng.has_work:
        eng.step()
    eng.shutdown()
    m = eng.metrics()
    assert m["requests_finished"] == len(prompts)
    if case == "prefix cow":
        assert m["kv_prefix_hits"] > 0 and m["kv_cow_copies"] > 0
    if case.startswith("preemption"):
        assert m["kv_preemptions"] > 0
    assert m["jit_executables"] > 0
    assert _leaf_ptrs(eng) == before
