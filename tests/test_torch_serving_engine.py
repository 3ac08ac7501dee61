"""Engine behaviours the serving front end relies on, the port against the
reference: the offline tier, priorities under block pressure, prefix-cache
hits, sampled streams with the serving parameters, an EOS stop, SiPipe
with overlapped sampling off and with in-stage sampling and
structure-unaware transmission, and ``load()``.

Each case serves one workload through both packages' engines on the same
weights: stablelm-1.6b-smoke in fp32 (parameters, KV cache and the
reference's inter-stage hand-offs, as tests/test_torch_engine.py does),
pp 2, two requests a microbatch, 8-slot pages, ``NaivePPEngine`` unless
named.  Requests arrive in waves: a wave is added once the engine has
drained the one before, so a later wave can hit the prefix cache an
earlier one filled.  Both engines must give the same token streams,
finish states and reasons, the same scheduling trace (members, spans,
sampling points, and under NaivePPEngine block tables and CoW copies),
the same counters and, where recorded, the same ``load()`` after every
step."""
import jax
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro_torch.core import engine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.stacked import tree_map
from test_torch_engine import _prompts, _reference_in_fp32, models  # noqa: F401

SERVING = dict(temperature=0.8, top_k=40, top_p=0.95, frequency_penalty=0.2,
               presence_penalty=0.1)
NAIVE_KEYS = ("tokens", "requests_finished", "requests_aborted",
              "kv_preemptions", "kv_cow_copies", "kv_prefix_hits",
              "kv_prefix_misses", "kv_prefix_tokens_served",
              "kv_blocks_cached", "kv_blocks_free", "kv_blocks_total",
              "kv_table_widths", "offline_requests_seen", "slack_seats_seen",
              "slack_tokens_sold", "slack_offers", "offline_preemptions",
              "incremental_hits", "meta_rebuilds", "policy")
SIPIPE_KEYS = ("tokens", "requests_finished", "kv_blocks_free",
               "kv_blocks_total", "policy")


@pytest.fixture(scope="module")
def fp32(models):  # noqa: F811
    (ref_model, ref_params), (model, params) = models
    return ((ref_model, jax.tree.map(lambda a: a.astype("float32"),
                                     ref_params)),
            (model, tree_map(lambda t: t.to(torch.float32), params)))


def _drive(pkg, engine_cls, model, params, waves, *, chunk=6,
           kv_blocks=None, record_load=False, **ecfg):
    """Serve ``waves`` (lists of (prompt, SamplingParams kwargs)) through
    one engine, stepping it by hand.  Returns the streams (by request:
    tokens, final state, finish reason), the scheduling trace, the
    metrics and, with ``record_load``, ``load()`` after every step."""
    cfg = pkg.EngineConfig(pp_degree=2, max_batch=2, max_seq_len=64,
                           n_samplers=2, prefill_chunk_tokens=chunk,
                           scheduling_policy="chunked" if chunk
                           else "monolithic", kv_layout="paged",
                           kv_block_size=8, kv_blocks=kv_blocks, **ecfg)
    eng = getattr(pkg, engine_cls)(model, params, cfg)
    sp_cls = SamplingParams
    if pkg is ref_engine:
        _reference_in_fp32(eng)
        sp_cls = RefSamplingParams
    trace, schedule = [], eng.scheduler.schedule

    def record(it):
        s = schedule(it)
        if s is not None:
            trace.append((s.iteration, list(s.seq_ids), s.spans,
                          s.needs_sample, s.block_tables.tolist(),
                          None if s.block_copies is None
                          else s.block_copies.tolist()))
        return s

    eng.scheduler.schedule = record
    rids, done, loads = [], {}, []
    for wave in waves:
        rids += [eng.add_request(p, sp_cls(**kw)) for p, kw in wave]
        while eng.has_work:
            for out in eng.step():
                if out.finished:
                    done[out.request_id] = (out.token_ids.to_list(),
                                            out.state.name, out.finish_reason)
            if record_load:
                loads.append(eng.load())
            assert len(trace) < 2000, "the engine did not drain"
    eng.shutdown()
    return [done[r] for r in rids], trace, eng.metrics(), loads


def _both(fp32, engine_cls, waves, **kw):
    (ref_model, ref_params), (model, params) = fp32
    ref = _drive(ref_engine, engine_cls, ref_model, ref_params, waves, **kw)
    port = _drive(engine, engine_cls, model, params, waves, **kw)
    (streams, trace, m, loads), (ref_streams, ref_trace, ref_m, ref_loads) \
        = port, ref
    assert streams == ref_streams
    if engine_cls == "NaivePPEngine":
        assert trace == ref_trace
    else:          # block ids depend on the sampling thread's timing there
        assert [t[:4] for t in trace] == [t[:4] for t in ref_trace]
    for key in NAIVE_KEYS if engine_cls == "NaivePPEngine" else SIPIPE_KEYS:
        assert m[key] == ref_m[key], key
    assert loads == ref_loads
    assert m["kv_blocks_free"] == m["kv_blocks_total"]
    return ref_streams, ref_m, ref_loads


def _greedy(n_new, **kw):
    return dict(greedy=True, max_new_tokens=n_new, **kw)


def test_offline_tier_under_chunked_policy_and_load_every_step(fp32):
    """Online requests beside an offline backlog over 12 blocks: the
    offline tier rides in slack, and ``load()`` (the router's poll)
    reads the same after every step."""
    online = [(p, _greedy(6)) for p in _prompts([13, 5, 21], seed=11)]
    offline = [(p, _greedy(5, tier="offline"))
               for p in _prompts([9, 11], seed=12)]
    streams, m, loads = _both(fp32, "NaivePPEngine", [online + offline],
                              kv_blocks=12, record_load=True)
    assert [s[1] for s in streams] == ["FINISHED"] * 5
    assert m["offline_requests_seen"] == 2 and m["slack_tokens_sold"] > 0
    assert max(x["offline_queue_depth"] for x in loads) > 0
    assert min(x["kv_blocks_free"] for x in loads) < 12
    assert loads[-1] == {"active_requests": 0, "queue_depth": 0,
                         "offline_queue_depth": 0, "kv_blocks_total": 12,
                         "kv_blocks_free": 12}


def test_priorities_under_block_pressure(fp32):
    """The two earliest, longest requests are low priority; under block
    pressure both packages preempt the same sequences at the same steps
    (the trace) and resume every stream to the same tokens."""
    reqs = [(p, _greedy(12, priority=pr)) for p, pr in
            zip(_prompts([20, 16, 12, 9], seed=7), (-1, -1, 2, 2))]
    streams, m, _ = _both(fp32, "NaivePPEngine", [reqs], kv_blocks=10)
    assert m["kv_preemptions"] > 0
    assert all(len(s[0]) == 12 for s in streams)


@pytest.mark.parametrize("chunk", [6, None], ids=["chunked", "monolithic"])
def test_prefix_cache_hits(fp32, chunk):
    """A second wave sharing a 24-token prefix (three full blocks) with
    the first maps the cached blocks instead of computing them."""
    base = _prompts([24], seed=5)[0]
    t1, t2 = _prompts([4, 4], seed=6)
    waves = [[(base + t1, _greedy(6))],
             [(base + t2, _greedy(6)), (base + t1, _greedy(6))]]
    _, m, _ = _both(fp32, "NaivePPEngine", waves, chunk=chunk)
    assert m["kv_prefix_hits"] >= 2 and m["kv_prefix_tokens_served"] >= 48
    assert m["kv_blocks_cached"] > 0


def test_sampled_streams_and_an_eos_stop(fp32):
    """Sampled streams with the serving parameters (the engine's seeded
    samplers) beside a greedy request that stops at its EOS token: the
    first token of its greedy stream, from the third on, that it has not
    produced before."""
    prompts = _prompts([13, 5, 21, 9], seed=3)
    model, params = fp32[1]
    alone = _drive(engine, "NaivePPEngine", model, params,
                   [[(prompts[0], _greedy(12))]])[0][0][0]
    stop = next(k for k in range(2, 12) if alone[k] not in alone[:k])
    reqs = [(prompts[0], _greedy(12, eos_token_id=alone[stop]))]
    reqs += [(p, dict(SERVING, max_new_tokens=8)) for p in prompts[1:]]
    streams, m, _ = _both(fp32, "NaivePPEngine", [reqs])
    assert streams[0] == (alone[:stop + 1], "FINISHED", "stop")
    assert [len(s[0]) for s in streams[1:]] == [8, 8, 8]
    assert len({tuple(s[0]) for s in streams[1:]}) == 3


@pytest.mark.parametrize("chunk,ecfg", [
    (6, {"overlap_sampling": False}),
    (None, {"cpu_sampling": False, "sat": False}),
], ids=["overlap_off", "in_stage_sampling_no_sat"])
def test_sipipe_ablations(fp32, chunk, ecfg):
    reqs = [(p, _greedy(6)) for p in _prompts([13, 5, 21, 9])]
    streams, m, _ = _both(fp32, "SiPipeEngine", [reqs], chunk=chunk, **ecfg)
    assert [len(s[0]) for s in streams] == [6] * 4
    assert m["policy"] == ("chunked" if chunk else "monolithic")
