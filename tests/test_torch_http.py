"""The port's HTTP front end over the port's real engine, on the CPU:
stablelm-1.6b-smoke with the reference's weights in fp32 (through
``params_from_jax``), SiPipeEngine replicas over 8-slot pages.

The endpoints end to end (streamed and aggregate completions, offline
batches, 429, 400 / 404, health, models, metrics); a client that leaves
mid-stream gets its request aborted and its blocks back, and an abort in
the fork-spawn window leaks nothing (tests/test_http.py's real-engine
cases); greedy tokens over HTTP equal the reference's SiPipeEngine on the
same weights; the launcher's HTTP smoke and online replay run, and the
smoke's 429 holds behind a slowed replica through its hold gate."""
import http.client
import json
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, SiPipeEngine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.launch import serve
from repro_torch.models.stacked import tree_map
from test_torch_engine import ARCH, _reference_in_fp32, models  # noqa: F401

PROMPTS = [[5, 9, 13, 17, 21], [7, 11, 2], list(range(30, 49))]


@pytest.fixture(scope="module")
def fp32(models):  # noqa: F811
    """(ref_model, ref_params), (cfg, model, params): both in fp32."""
    (ref_model, ref_params), (model, params) = models
    return ((ref_model, jax.tree.map(lambda a: a.astype("float32"),
                                     ref_params)),
            (get_config(ARCH), model,
             tree_map(lambda t: t.to(torch.float32), params)))


def _server(prebuilt, **kw):
    _, srv = serve.build_http_server(
        ARCH, pp=2, max_batch=2, max_seq_len=64, kv_layout="paged",
        block_size=8, prebuilt=prebuilt, **kw)
    return srv.start()


@pytest.fixture(scope="module")
def server(fp32):
    srv = _server(fp32[1], chunk_tokens=0)
    yield srv
    srv.close()


def _request(addr, body=None, method="POST", path="/v1/completions",
             timeout=120.0):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _read_sse(resp):
    events, done = [], False
    while True:
        line = resp.readline()
        if not line:
            break
        if line == b"\n":
            continue
        payload = line[len(b"data: "):].rstrip(b"\n")
        if payload == b"[DONE]":
            done = True
            break
        events.append(json.loads(payload))
    return events, done


def _stream(addr, prompt, n_new):
    conn, resp = _request(addr, {"prompt": prompt, "max_tokens": n_new,
                                 "temperature": 0.0, "stream": True})
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "text/event-stream"
    events, done = _read_sse(resp)
    conn.close()
    assert done
    reasons = [c["finish_reason"] for e in events for c in e["choices"]
               if c["finish_reason"]]
    assert reasons == ["length"]
    return [t for e in events for c in e["choices"] for t in c["token_ids"]]


def _streamed_and_aggregate_agree(srv):
    toks = _stream(srv.address, PROMPTS[0], 6)
    assert len(toks) == 6
    conn, resp = _request(srv.address, {"prompt": PROMPTS[0], "max_tokens": 6,
                                        "temperature": 0.0, "n": 2})
    assert resp.status == 200
    out = json.loads(resp.read())
    conn.close()
    assert out["object"] == "text_completion"
    # greedy forks of one prompt decode the same tokens
    assert [c["token_ids"] for c in out["choices"]] == [toks, toks]
    assert out["usage"] == {"prompt_tokens": 5, "completion_tokens": 12,
                            "total_tokens": 17}


def _offline_batch_completes(srv):
    conn, resp = _request(srv.address, {"requests": [
        {"prompt": PROMPTS[1], "max_tokens": 3, "temperature": 0.0},
        {"prompt": "a string prompt", "max_tokens": 4}]},
        path="/v1/batches")
    assert resp.status == 200
    batch = json.loads(resp.read())
    conn.close()
    assert batch["object"] == "batch"
    assert [len(r["choices"][0]["token_ids"]) for r in batch["results"]] == \
        [3, 4]
    assert batch["results"][0]["choices"][0]["token_ids"] == \
        _stream(srv.address, PROMPTS[1], 3)


def _bad_requests_are_400_and_404(srv):
    conn = http.client.HTTPConnection(*srv.address, timeout=10)
    conn.request("POST", "/v1/completions", b"{not json",
                 {"Content-Type": "application/json"})
    assert conn.getresponse().status == 400
    conn.close()
    for body, path, code in [({"prompt": [1]}, "/v1/nonesuch", 404),
                             ({"max_tokens": 2}, "/v1/completions", 400),
                             ({"prompt": [1, 999]}, "/v1/completions", 400),
                             ({"requests": []}, "/v1/batches", 400)]:
        conn, resp = _request(srv.address, body, path=path)
        assert resp.status == code
        assert json.loads(resp.read())["error"]["code"] == code
        conn.close()
    conn, resp = _request(srv.address, method="GET", path="/nonesuch")
    assert resp.status == 404
    conn.close()


def _health_models_metrics(srv):
    conn, resp = _request(srv.address, method="GET", path="/health")
    assert resp.status == 200
    h = json.loads(resp.read())
    conn.close()
    assert h["status"] == "ok" and h["replicas"]["r0"]["healthy"]
    assert h["replicas"]["r0"]["kv_blocks_total"] == 32
    conn, resp = _request(srv.address, method="GET", path="/v1/models")
    assert json.loads(resp.read())["data"][0]["id"] == ARCH
    conn.close()
    _stream(srv.address, PROMPTS[1], 2)
    conn, resp = _request(srv.address, method="GET", path="/metrics")
    assert resp.headers["Content-Type"].startswith("text/plain")
    text = resp.read().decode()
    conn.close()
    for line in ('repro_kv_blocks_total{replica="r0"} 32',
                 'repro_requests_active{replica="r0"} 0',
                 'repro_jit_executables{replica="r0"} 0',
                 "repro_admission_rejected_total 0",
                 "repro_http_disconnects_total 0"):
        assert line in text, line
    assert 'repro_requests_finished{replica="r0"}' in text


ENDPOINT_CASES = [_streamed_and_aggregate_agree, _offline_batch_completes,
                  _bad_requests_are_400_and_404, _health_models_metrics]


@pytest.mark.parametrize("case", ENDPOINT_CASES,
                         ids=[c.__name__.strip("_") for c in ENDPOINT_CASES])
def test_endpoints_over_the_port_engine(server, case):
    case(server)
    eng = server.router.replicas[0].engine
    snap = eng.load()
    assert snap["active_requests"] == 0
    assert snap["kv_blocks_free"] == snap["kv_blocks_total"]


def test_429_before_any_engine_work(fp32):
    srv = _server(fp32[1], max_queue=0)
    try:
        conn, resp = _request(srv.address, {"prompt": [3], "max_tokens": 2})
        assert resp.status == 429
        assert resp.headers["Retry-After"] == "1"
        assert json.loads(resp.read())["error"]["tier"] == "online"
        conn.close()
        assert srv.router.replicas[0].engine.metrics()[
            "requests_submitted"] == 0
    finally:
        srv.close()


def test_disconnect_mid_stream_aborts_and_frees_blocks(server):
    eng = server.router.replicas[0].engine
    aborted = eng.metrics()["requests_aborted"]
    conn, resp = _request(server.address, {
        "prompt": [5, 9, 13], "max_tokens": 50, "temperature": 0.0,
        "stream": True})
    assert resp.status == 200
    assert resp.readline().startswith(b"data: ")
    resp.close()                  # both handles hold the socket: close both
    conn.close()
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        snap = eng.load()
        if (snap["active_requests"] == 0
                and snap["kv_blocks_free"] == snap["kv_blocks_total"]):
            break
        time.sleep(0.05)
    snap = eng.load()
    assert snap["active_requests"] == 0
    assert snap["kv_blocks_free"] == snap["kv_blocks_total"]
    assert eng.metrics()["requests_aborted"] == aborted + 1
    assert server.n_disconnects >= 1


def test_abort_inside_fork_spawn_window_leaks_nothing(fp32):
    """An abort landing between the scheduler spawning fork children (at
    the first token) and the engine attaching them to the request must
    still reclaim every block: the children live only in scheduler state
    in that window."""
    _, model, params = fp32[1]
    eng = SiPipeEngine(model, params, EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, n_samplers=2,
        kv_layout="paged", kv_block_size=8))
    hold = {"on": True}
    real_attach = eng._attach_forks
    eng._attach_forks = lambda: None if hold["on"] else real_attach()
    rid = eng.add_request([5, 9, 13, 17],
                          SamplingParams(greedy=True, max_new_tokens=12, n=3))
    for _ in range(10_000):
        eng.step()
        if eng.scheduler.fork_children_of(rid):
            break
    assert eng.scheduler.fork_children_of(rid), "forks never spawned"
    assert eng.requests[rid].forks == []
    assert eng.abort(rid)
    hold["on"] = False
    for _ in range(10_000):
        if not eng.has_work:
            break
        eng.step()
    eng.shutdown()
    m = eng.metrics()
    assert not eng.has_work
    assert m["kv_blocks_free"] == m["kv_blocks_total"]
    assert eng.load() == {"active_requests": 0, "queue_depth": 0,
                          "offline_queue_depth": 0,
                          "kv_blocks_total": m["kv_blocks_total"],
                          "kv_blocks_free": m["kv_blocks_total"]}


@pytest.fixture(scope="module")
def reference_greedy(fp32):
    """The reference SiPipeEngine's greedy tokens for PROMPTS, fp32,
    monolithic prefill over 8-slot pages."""
    ref_model, ref_params = fp32[0]
    eng = ref_engine.SiPipeEngine(ref_model, ref_params, ref_engine.EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, n_samplers=2,
        kv_layout="paged", kv_block_size=8))
    _reference_in_fp32(eng)
    direct = {}
    for out in eng.generate(PROMPTS, RefSamplingParams(greedy=True,
                                                       max_new_tokens=8)):
        if out.finished:
            direct[out.request_id] = out.token_ids.to_list()
    eng.shutdown()
    return [direct[k] for k in sorted(direct)]


@pytest.mark.parametrize("chunk_tokens", [0, 16])
def test_greedy_over_http_equals_reference_engine(fp32, reference_greedy,
                                                  chunk_tokens):
    """The transport adds nothing: greedy tokens streamed over HTTP from
    the port (monolithic prefill, and the chunked policy with the
    launcher's default budget) equal the reference engine's on the same
    fp32 weights."""
    srv = _server(fp32[1], chunk_tokens=chunk_tokens)
    try:
        got = [_stream(srv.address, p, 8) for p in PROMPTS]
        policy = srv.router.replicas[0].engine.metrics()["policy"]
    finally:
        srv.close()
    assert policy == ("chunked" if chunk_tokens else "monolithic")
    assert all(len(g) == 8 for g in got)
    assert got == reference_greedy


def test_run_http_smoke_on_the_cpu(capsys):
    assert serve.run_http(ARCH, smoke=True, device="cpu", max_seq_len=64) \
        == 0
    assert "HTTP smoke OK" in capsys.readouterr().out


def test_http_smoke_holds_its_slot_behind_a_slow_replica():
    """The smoke's 429 does not hang on timing: with the replica that
    serves the /v1/batches job slowed to 0.2 s a step while it holds
    offline work, the held stream on the other replica would end (and
    free the one active slot) before the probe, but for the gate."""
    server, gate = serve.start_smoke_server(ARCH, replicas=2, device="cpu",
                                            max_seq_len=64)
    for rep in server.router.replicas:
        def slow(eng=rep.engine, step=rep.engine.step):
            if any(r.seq.params.tier == "offline"
                   for r in list(eng.requests.values())):
                time.sleep(0.2)
            return step()
        rep.engine.step = slow
    try:
        serve._http_smoke(*server.address, gate)
    finally:
        server.close()


def _gate_engine(lengths):
    """A stand-in engine for HoldGate: one live request per (max_new_tokens,
    tokens emitted) pair, and a step that records its calls."""
    calls = []
    reqs = {i: SimpleNamespace(seq=SimpleNamespace(
        params=SimpleNamespace(max_new_tokens=n), output_ids=[0] * k))
        for i, (n, k) in enumerate(lengths)}

    def step():
        calls.append(1)
        return ["out"]
    return SimpleNamespace(requests=reqs, step=step), calls


HOLD, MARGIN = serve.HOLD_TOKENS, serve.HOLD_MARGIN


@pytest.mark.parametrize("lengths, released, steps", [
    ([(HOLD, HOLD - MARGIN)], False, False),     # held alone at its margin
    ([(HOLD, HOLD - 1)], False, False),          # held alone, last token
    ([(HOLD, HOLD - MARGIN - 1)], False, True),  # held alone, before it
    ([(HOLD, HOLD - 1), (3, 0)], False, True),   # other work on the replica
    ([(4, 3)], False, True),                     # no held request
    ([], False, True),                           # nothing live
    ([(HOLD, HOLD - 1)], True, True),            # released
], ids=["margin", "last", "before", "other-work", "not-held", "idle",
        "released"])
def test_hold_gate_keeps_only_the_held_stream_back(lengths, released, steps):
    eng, calls = _gate_engine(lengths)
    gate = serve.HoldGate([eng])
    if released:
        gate.release()
    assert eng.step() == (["out"] if steps else [])
    assert calls == ([1] if steps else [])


def test_run_online_accounting_on_the_cpu():
    m = serve.run_online(ARCH, requests=7, max_new_tokens=8, abort_every=3,
                         offline_requests=2, arrival_rate=50.0,
                         device="cpu", verbose=False)
    assert m["device"] == "cpu" and m["policy"] == "chunked"
    assert m["finished"] + m["aborted"] == 7 and m["aborted"] >= 1
    assert m["offline_submitted"] == m["offline_finished"] == 2
    assert m["offline_streamed_tokens"] > 0 and m["streamed_tokens"] > 0
    assert m["kv_blocks_free"] == m["kv_blocks_total"]
    assert np.isfinite(m["ttft_mean_s"]) and m["ttft_mean_s"] > 0
