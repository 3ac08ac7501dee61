"""The port's serving front end (``repro_torch.serving``) and its online
workload (``ShareGPTLike.arrivals``) against the reference's originals.

The modules are copies (ROADMAP, "host code is copied"): each must differ
from its original only in its import lines, and on one fixed set of
inputs both packages' wire functions must give the same bytes, both
``AdmissionController``s the same tickets and hints, both routers the
same placement, and both workloads the same arrival traces.  Then the
reference's mock-engine cases (tests/test_admission.py,
tests/test_router.py, tests/test_http.py's wire and live-server cases)
run against the port's copies, over its ``MockEngine``: no model, no
compile, milliseconds each."""
import dataclasses
import http.client
import json
import os
import threading
import time
import types

import pytest

import repro.serving.admission as ref_adm
import repro.serving.mock as ref_mock
import repro.serving.protocol as ref_proto
import repro.serving.router as ref_router
import repro.core.sampling_params as ref_sp
import repro_torch.core.sampling_params as port_sp
import repro_torch.serving.admission as adm
import repro_torch.serving.mock as mock
import repro_torch.serving.protocol as proto
import repro_torch.serving.router as router
from repro.runtime.data import ShareGPTLike as RefShareGPTLike
from repro_torch.runtime.data import ShareGPTLike
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.serving.admission import AdmissionController, Closed, QueueFull
from repro_torch.serving.mock import MockEngine
from repro_torch.serving.protocol import ProtocolError
from repro_torch.serving.router import EngineReplica, ReplicaUnavailable, Router
from repro_torch.serving.server import CompletionServer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BOTH = (
    types.SimpleNamespace(adm=ref_adm, mock=ref_mock, proto=ref_proto,
                          router=ref_router, sp=ref_sp),
    types.SimpleNamespace(adm=adm, mock=mock, proto=proto, router=router,
                          sp=port_sp),
)


# ---------------------------------------------------------------------------
# The copy rule: only the import lines differ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["__init__", "protocol", "admission",
                                    "mock", "router", "server"])
def test_serving_modules_differ_from_the_reference_only_in_imports(module):
    def read(pkg):
        with open(os.path.join(SRC, pkg, "serving", f"{module}.py")) as f:
            return f.read().splitlines()

    ref, port = read("repro"), read("repro_torch")
    assert len(port) == len(ref)
    assert not [b for b in port if "from repro." in b or "import repro" in b]
    for a, b in zip(ref, port):
        if a == b:
            continue
        assert b.startswith("from repro_torch."), b
        assert b.replace("from repro_torch.", "from repro.", 1) == a


# ---------------------------------------------------------------------------
# Both packages on the same inputs
# ---------------------------------------------------------------------------

PARSE_BODIES = [
    ({"prompt": [3, 5, 7]}, {}),
    ({"prompt": "hi there é"}, {}),
    ({"prompt": [1], "temperature": 0.0, "priority": 3, "max_tokens": 5},
     {}),
    ({"prompt": [1, 2], "temperature": 0.7, "top_p": 0.9, "top_k": 40,
      "n": 3, "stream": True, "tier": "offline", "user": "u1",
      "model": "m"}, {}),
    ({"prompt": [1], "user": "body-user", "max_tokens": 100},
     {"tenant": "key-9", "max_tokens_cap": 8}),
    ({"prompt": [1], "temperature": 1}, {}),
    # each ProtocolError case of tests/test_http.py
    ({}, {}),
    ({"prompt": []}, {}),
    ({"prompt": [999]}, {}),
    ({"prompt": [1], "max_tokens": 0}, {}),
    ({"prompt": [1], "max_tokens": "4"}, {}),
    ({"prompt": [1], "n": 0}, {}),
    ({"prompt": [1], "n": True}, {}),
    ({"prompt": [1], "temperature": -1.0}, {}),
    ({"prompt": [1], "top_p": 0.0}, {}),
    ({"prompt": [1], "stream": 1}, {}),
    ({"prompt": [1], "tier": "batch"}, {}),
    ([1, 2], {}),
]


def _parsed(ns, body, kw) -> bytes:
    try:
        r = ns.proto.parse_completion_request(body, 64, **kw)
    except ns.proto.ProtocolError as e:
        return f"ProtocolError: {e}".encode()
    return json.dumps([dataclasses.asdict(r),
                       dataclasses.asdict(r.sampling_params()), r.greedy],
                      sort_keys=True).encode()


@pytest.mark.parametrize("body,kw", PARSE_BODIES)
def test_parse_completion_request_matches_reference(body, kw):
    ref, port = (_parsed(ns, body, kw) for ns in BOTH)
    assert port == ref


def _wire(ns) -> list:
    p = ns.proto
    out = [p.sse_event(p.completion_chunk(7, 1234, "m", 0, [3, 4])),
           p.sse_event(p.completion_chunk(7, 1234, "m", 1, [], "length")),
           p.sse_event({"error": {"message": "x", "code": 500}}),
           p.SSE_DONE,
           json.dumps(p.completion_response(
               9, 1234, "m",
               [{"token_ids": [5, 6, 7], "finish_reason": "length"},
                {"token_ids": [8], "finish_reason": "stop"}],
               prompt_tokens=4), sort_keys=True).encode(),
           p.render_prometheus(
               {"r1": {"a": 1, "flag": True, "nested": {"x": 1}, "f": 2.5,
                       "kv-blocks.free": 7},
                "r0": {"tokens": 12345678, "rate": 1e-7, "s": "text"}},
               {"c": 3, "admission_pending": 0, "b": False}).encode(),
           p.render_prometheus({}).encode(),
           p.decode_text([1, 22, 333]).encode()]
    for prompt in ([3, 5, 7], "hi", "éè ok", [0, 63]):
        out.append(json.dumps(p.encode_prompt(prompt, 64)).encode())
    for bad in ("", [], [64], [True], "x".encode()):
        try:
            p.encode_prompt(bad, 64)
            out.append(b"accepted")
        except p.ProtocolError as e:
            out.append(str(e).encode())
    return out


def test_wire_functions_give_the_reference_bytes():
    ref, port = (_wire(ns) for ns in BOTH)
    assert port == ref


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _admission_script(ns) -> list:
    """One scripted sequence of submit / release / close over both tiers;
    the log of every ticket's fields, every rejection and snapshot."""
    clk = _Clock()
    ac = ns.adm.AdmissionController(max_queue=2, max_active=2,
                                    max_queue_offline=2, retry_after_s=3,
                                    clock=clk)
    log, tickets = [], []

    def ticket(t):
        return (t.seq, t.priority, t.tenant, t.tier, t.dispatched.is_set(),
                t.cancelled, t.released)

    def submit(**kw):
        try:
            tickets.append(ac.submit(**kw))
            log.append(("ticket", ticket(tickets[-1])))
        except ns.adm.QueueFull as e:
            log.append(("full", e.retry_after, e.tier, str(e)))
        except ns.adm.Closed:
            log.append(("closed",))

    def release(i, dt=0.0):
        clk.t += dt
        ac.release(tickets[i])
        log.append(("state", [ticket(t) for t in tickets], ac.snapshot()))

    for kw in ({"tenant": "A"}, {"tenant": "A"}, {"tenant": "A"},
               {"tenant": "B", "priority": 2}, {"tenant": "C"},
               {"tier": "offline"}, {"tier": "offline"},
               {"tier": "offline"}):
        submit(**kw)
    release(0, 0.5)
    release(1, 2.0)
    release(5, 1.0)
    submit(tier="offline")
    release(2, 3.0)
    submit(tenant="C", priority=-1)
    submit(tenant="D")
    release(2)                          # idempotent
    submit(tenant="E")
    release(3, 0.25)
    release(4, 40.0)
    submit(tenant="F")
    submit(tenant="G")
    submit(tenant="H")
    release(len(tickets) - 1)           # cancels an undispatched ticket
    ac.close()
    log.append(("state", [ticket(t) for t in tickets], ac.snapshot()))
    submit()
    return log


def test_admission_script_matches_reference():
    ref, port = (_admission_script(ns) for ns in BOTH)
    assert any(e[0] == "full" and e[2] == "online" and e[1] > 1 for e in ref)
    assert any(e[0] == "full" and e[2] == "offline" for e in ref)
    assert port == ref


@pytest.mark.parametrize("loads", [
    # per replica: the prompt lengths of its live requests (n = 1), and
    # whether it is serving
    [([], True), ([4], True), ([], True)],
    [([8, 8], True), ([4], True), ([16], True)],
    [([9], True), ([9], True), ([1, 1], True)],
    [([], False), ([30], True), ([29], True)],
    [([4, 4, 4], True), ([12], True)],
])
def test_router_pick_matches_reference(loads):
    def pick(ns):
        class Gated(ns.mock.MockEngine):
            def step(self):             # holds every request where it is
                time.sleep(0.001)
                return []

        reps = []
        for i, (plens, serving) in enumerate(loads):
            eng = Gated(kv_blocks=16, start_id=100 * i)
            for n in plens:
                eng.add_request(list(range(2, 2 + n)),
                                ns.sp.SamplingParams(max_new_tokens=4))
            rep = ns.router.EngineReplica(f"r{i}", eng)
            if serving:
                rep.start()
            reps.append(rep)
        try:
            r = ns.router.Router(reps)
            return r.pick().name, [rep.load() for rep in reps]
        finally:
            for rep in reps:
                if rep._thread.is_alive():
                    rep.kill()

    ref, port = (pick(ns) for ns in BOTH)
    assert port == ref


@pytest.mark.parametrize("seed,rate,n", [(0, 8.0, 16), (3, 0.5, 5),
                                         (7919, 40.0, 33)])
def test_arrivals_match_reference(seed, rate, n):
    kw = dict(n_requests=n, seed=seed, prompt_len_median=12, max_prompt=160,
              output_len_median=32, max_output=32)
    got = ShareGPTLike(256, **kw).arrivals(rate)
    want = RefShareGPTLike(256, **kw).arrivals(rate)
    assert got == want
    assert [t for t, _, _ in got] == sorted(t for t, _, _ in got)
    with pytest.raises(ValueError, match="positive"):
        ShareGPTLike(256, **kw).arrivals(0.0)


# ---------------------------------------------------------------------------
# The port's copies on their own: the reference's mock-engine cases
# ---------------------------------------------------------------------------

def _adm_rejects_when_queue_full_without_touching_dispatched():
    ac = AdmissionController(max_queue=2, max_active=1)
    a, b, c = ac.submit(), ac.submit(), ac.submit()
    with pytest.raises(QueueFull) as ei:
        ac.submit()
    assert ei.value.retry_after == 1
    assert a.dispatched.is_set()
    assert not b.dispatched.is_set() and not c.dispatched.is_set()
    s = ac.snapshot()
    assert s["admission_rejected_total"] == 1
    assert s["admission_pending"] == 2 and s["admission_active"] == 1


def _adm_dispatch_window_caps_active_and_release_refills():
    ac = AdmissionController(max_queue=8, max_active=2)
    t = [ac.submit() for _ in range(4)]
    assert [x.dispatched.is_set() for x in t] == [True, True, False, False]
    ac.release(t[0])
    assert t[2].dispatched.is_set() and not t[3].dispatched.is_set()
    assert ac.wait(t[2], timeout=0)


def _adm_priority_beats_arrival_order():
    ac = AdmissionController(max_queue=8, max_active=1)
    hold = ac.submit()
    low = ac.submit(priority=0)
    high = ac.submit(priority=5)
    ac.release(hold)
    assert high.dispatched.is_set() and not low.dispatched.is_set()


def _adm_tenant_fair_share_at_equal_priority():
    ac = AdmissionController(max_queue=8, max_active=2)
    a1, a2, a3 = (ac.submit(tenant="A") for _ in range(3))
    b1 = ac.submit(tenant="B")
    assert not a3.dispatched.is_set() and not b1.dispatched.is_set()
    ac.release(a1)
    assert b1.dispatched.is_set() and not a3.dispatched.is_set()
    ac.release(a2)
    assert a3.dispatched.is_set()
    ac.release(a3)
    ac.release(b1)
    assert ac.snapshot()["admission_active"] == 0


def _adm_priority_overrides_fair_share():
    ac = AdmissionController(max_queue=8, max_active=1)
    a1 = ac.submit(tenant="A")
    a2 = ac.submit(tenant="A", priority=9)
    b1 = ac.submit(tenant="B", priority=0)
    ac.release(a1)
    assert a2.dispatched.is_set() and not b1.dispatched.is_set()


def _adm_fifo_breaks_full_ties():
    ac = AdmissionController(max_queue=8, max_active=1)
    hold = ac.submit(tenant="A")
    x = ac.submit(tenant="B")
    y = ac.submit(tenant="C")
    ac.release(hold)
    assert x.dispatched.is_set() and not y.dispatched.is_set()


def _adm_release_is_idempotent_and_cancels_undispatched():
    ac = AdmissionController(max_queue=8, max_active=1)
    a, b = ac.submit(), ac.submit()
    ac.release(b)
    assert b.cancelled and not b.dispatched.is_set()
    ac.release(b)
    ac.release(a)
    ac.release(a)
    s = ac.snapshot()
    assert s["admission_active"] == 0 and s["admission_pending"] == 0


def _adm_close_cancels_pending_and_rejects_new():
    ac = AdmissionController(max_queue=8, max_active=1)
    a, b = ac.submit(), ac.submit()
    ac.close()
    assert ac.wait(b, timeout=1.0) and b.cancelled
    assert not a.cancelled
    with pytest.raises(Closed):
        ac.submit()


def _adm_unbounded_window_dispatches_immediately():
    ac = AdmissionController(max_queue=4, max_active=None)
    t = [ac.submit() for _ in range(5)]
    assert all(x.dispatched.is_set() for x in t)


def _adm_snapshot_counters():
    ac = AdmissionController(max_queue=1, max_active=1)
    a, b = ac.submit(), ac.submit()
    with pytest.raises(QueueFull):
        ac.submit()
    ac.release(a)
    s = ac.snapshot()
    assert s["admission_admitted_total"] == 2
    assert s["admission_rejected_total"] == 1
    assert s["admission_dispatched_total"] == 2
    assert s["admission_active"] == 1 and s["admission_pending"] == 0
    ac.release(b)


def _adm_offline_tickets_bypass_the_online_window():
    ac = AdmissionController(max_queue=1, max_active=1)
    hold = ac.submit()
    off = [ac.submit(tier="offline") for _ in range(3)]
    assert all(t.dispatched.is_set() and t.tier == "offline" for t in off)
    on = ac.submit()
    assert not on.dispatched.is_set()
    s = ac.snapshot()
    assert s["admission_offline_live"] == 3
    assert s["admission_offline_admitted_total"] == 3
    assert s["admission_active"] == 1 and s["admission_pending"] == 1
    for t in off:
        ac.release(t)
    assert not on.dispatched.is_set()
    assert ac.snapshot()["admission_offline_live"] == 0
    ac.release(hold)
    assert on.dispatched.is_set()


def _adm_offline_cap_rejects_with_offline_tier_tag():
    ac = AdmissionController(max_queue=1, max_active=1, max_queue_offline=2)
    t = [ac.submit(tier="offline") for _ in range(2)]
    with pytest.raises(QueueFull) as ei:
        ac.submit(tier="offline")
    assert ei.value.tier == "offline" and ei.value.retry_after >= 1
    on = ac.submit()
    assert on.dispatched.is_set() and on.tier == "online"
    assert ac.snapshot()["admission_offline_rejected_total"] == 1
    for x in t:
        ac.release(x)


def _adm_online_queue_full_reports_online_tier():
    ac = AdmissionController(max_queue=1, max_active=1)
    ac.submit()
    ac.submit()
    with pytest.raises(QueueFull) as ei:
        ac.submit()
    assert ei.value.tier == "online"


def _retry_after(span):
    """The 429 hint after two releases ``span`` seconds apart, with one
    ticket pending."""
    clk = _Clock()
    ac = AdmissionController(max_queue=1, max_active=1, clock=clk)
    a, b = ac.submit(), ac.submit()
    ac.release(a)
    clk.t = span
    ac.release(b)
    ac.submit()
    ac.submit()
    with pytest.raises(QueueFull) as ei:
        ac.submit()
    return ei.value.retry_after


def _adm_retry_after_reflects_measured_drain_rate():
    assert _retry_after(4.0) == 8          # ceil((1 + 1) / 0.25)


def _adm_retry_after_clamps_to_sane_bounds():
    assert _retry_after(0.001) == 1
    assert _retry_after(500.0) == 60


def _adm_retry_after_falls_back_without_history():
    ac = AdmissionController(max_queue=1, max_active=1, retry_after_s=3)
    ac.submit()
    ac.submit()
    with pytest.raises(QueueFull) as ei:
        ac.submit()
    assert ei.value.retry_after == 3


ADMISSION_CASES = [v for k, v in list(globals().items())
                   if k.startswith("_adm_")]


@pytest.mark.parametrize("case", ADMISSION_CASES,
                         ids=[c.__name__[5:] for c in ADMISSION_CASES])
def test_admission_cases(case):
    case()


def _params(n_new=4, n=1, priority=0):
    return SamplingParams(greedy=True, max_new_tokens=n_new, n=n,
                          priority=priority)


def _drain_stream(out_q, timeout=10.0):
    outs = []
    while True:
        out = out_q.get(timeout=timeout)
        if isinstance(out, BaseException):
            raise out
        outs.append(out)
        if out.finished:
            return outs


class _Stub:
    def __init__(self, name, free, depth=0, active=0, healthy=True):
        self.name = name
        self._snap = {"kv_blocks_free": free, "queue_depth": depth,
                      "active_requests": active, "kv_blocks_total": 64}
        self.healthy = healthy

    def load(self):
        return dict(self._snap)


class _Gated(MockEngine):
    """Holds decode until released, so KV occupancy is frozen while the
    routing decisions under test are made."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gate = threading.Event()

    def step(self):
        if not self.gate.is_set():
            time.sleep(0.001)
            return []
        return super().step()


def _router_pick_prefers_most_free_blocks():
    r = Router([_Stub("a", free=10), _Stub("b", free=30),
                _Stub("c", free=20)])
    assert r.pick().name == "b"


def _router_pick_ties_fall_to_load_then_order():
    r = Router([_Stub("a", free=10, depth=3), _Stub("b", free=10, depth=1),
                _Stub("c", free=10, depth=1)])
    assert r.pick().name == "b"


def _router_pick_skips_unhealthy_and_raises_when_none():
    r = Router([_Stub("a", free=50, healthy=False), _Stub("b", free=1)])
    assert r.pick().name == "b"
    with pytest.raises(ReplicaUnavailable):
        Router([_Stub("a", free=50, healthy=False)]).pick()


def _router_requires_replicas():
    with pytest.raises(ValueError):
        Router([])


def _router_replica_streams_deterministic_tokens():
    rep = EngineReplica("r0", MockEngine()).start()
    try:
        rid, out_q = rep.submit([3, 5], _params(n_new=4))
        outs = _drain_stream(out_q)
        assert outs[-1].finished and outs[-1].finish_reason == "length"
        assert [t for o in outs for t in o.new_token_ids] == \
            [(8 + k) % 64 for k in range(4)]
        assert outs[-1].metrics is not None
    finally:
        assert rep.drain()
    assert not rep.healthy


def _router_replica_abort_mid_stream_reclaims():
    eng = MockEngine()
    rep = EngineReplica("r0", eng).start()
    try:
        rid, out_q = rep.submit([2], _params(n_new=10_000))
        assert not out_q.get(timeout=10.0).finished
        rep.abort(rid)
        assert _drain_stream(out_q)[-1].finish_reason == "abort"
        assert eng.n_aborts == 1
        assert eng.load()["kv_blocks_free"] == eng.kv_blocks
    finally:
        rep.drain()


def _router_replica_fork_streams_ride_along():
    rep = EngineReplica("r0", MockEngine()).start()
    try:
        rid, out_q = rep.submit([4], _params(n_new=3, n=2))
        outs = _drain_stream(out_q)
        assert outs[-1].forks and outs[-1].forks[0].finished
        assert [t for o in outs for t in o.forks[0].new_token_ids] == \
            [(4 + 31 + k) % 64 for k in range(3)]
    finally:
        rep.drain()


def _router_replica_crash_marks_unhealthy_and_fails_streams():
    class Exploding(MockEngine):
        def step(self):
            raise RuntimeError("boom")

    rep = EngineReplica("r0", Exploding()).start()
    rid, out_q = rep.submit([1], _params())
    with pytest.raises(RuntimeError, match="boom"):
        _drain_stream(out_q)
    rep._thread.join(5.0)
    assert not rep.healthy and rep.error is not None
    with pytest.raises(ReplicaUnavailable):
        rep.submit([1], _params())


def _router_drain_finishes_inflight_work():
    rep = EngineReplica("r0", MockEngine()).start()
    rid, out_q = rep.submit([6], _params(n_new=8))
    assert rep.drain()
    outs = _drain_stream(out_q, timeout=1.0)
    assert outs[-1].finished and len(outs[-1].token_ids) == 8


def _router_spreads_by_free_blocks():
    reps = [EngineReplica(f"r{i}", _Gated(start_id=100 * i))
            for i in range(2)]
    r = Router(reps).start()
    try:
        qs = [r.submit([8] * 8, _params(n_new=8))[2] for _ in range(4)]
        assert r.routed == {"r0": 2, "r1": 2}
        for rep in reps:
            assert rep.engine.load()["active_requests"] == 2
            rep.engine.gate.set()
        for out_q in qs:
            _drain_stream(out_q)
    finally:
        r.shutdown(drain=True)


def _router_health_and_metrics_views():
    r = Router([EngineReplica("r0", MockEngine())]).start()
    try:
        h = r.health()
        assert h["r0"]["healthy"] and "kv_blocks_free" in h["r0"]
        assert r.metrics()["r0"]["requests_finished"] == 0
    finally:
        r.shutdown(drain=True)
    assert not r.health()["r0"]["healthy"]


ROUTER_CASES = [v for k, v in list(globals().items())
                if k.startswith("_router_")]


@pytest.mark.parametrize("case", ROUTER_CASES,
                         ids=[c.__name__[8:] for c in ROUTER_CASES])
def test_router_cases(case):
    case()


def _server(**kw):
    reps = [EngineReplica("r0", MockEngine())]
    srv = CompletionServer(Router(reps), vocab_size=64, model_name="mock",
                           **kw).start()
    return srv, reps[0].engine


def _request(addr, body=None, method="POST", path="/v1/completions",
             headers=None, timeout=30.0):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    return conn, conn.getresponse()


def _read_sse(resp):
    events, done = [], False
    while True:
        line = resp.readline()
        if not line:
            break
        if line == b"\n":
            continue
        assert line.startswith(b"data: "), line
        payload = line[len(b"data: "):].rstrip(b"\n")
        if payload == b"[DONE]":
            done = True
            break
        events.append(json.loads(payload))
    return events, done


def _http_sse_chunk_golden_bytes():
    assert proto.sse_event(proto.completion_chunk(7, 1234, "m", 0, [3, 4])) \
        == (b'data: {"choices":[{"finish_reason":null,"index":0,'
            b'"logprobs":null,"text":"3 4","token_ids":[3,4]}],'
            b'"created":1234,"id":"cmpl-7","model":"m",'
            b'"object":"text_completion.chunk"}\n\n')


def _http_sse_terminal_chunk_golden_bytes():
    chunk = proto.completion_chunk(7, 1234, "m", 1, [], "length")
    assert proto.sse_event(chunk) == (
        b'data: {"choices":[{"finish_reason":"length","index":1,'
        b'"logprobs":null,"text":"","token_ids":[]}],"created":1234,'
        b'"id":"cmpl-7","model":"m","object":"text_completion.chunk"}\n\n')
    assert proto.SSE_DONE == b"data: [DONE]\n\n"


def _http_completion_response_schema_and_usage():
    resp = proto.completion_response(
        9, 1234, "m",
        [{"token_ids": [5, 6, 7], "finish_reason": "length"},
         {"token_ids": [8], "finish_reason": "stop"}], prompt_tokens=4)
    assert resp["id"] == "cmpl-9" and resp["object"] == "text_completion"
    assert [c["index"] for c in resp["choices"]] == [0, 1]
    assert resp["choices"][0]["text"] == "5 6 7"
    assert resp["choices"][1]["finish_reason"] == "stop"
    assert resp["usage"] == {"prompt_tokens": 4, "completion_tokens": 4,
                             "total_tokens": 8}


def _http_parse_accepts_token_ids_and_strings():
    r = proto.parse_completion_request({"prompt": [3, 5, 7]}, 64)
    assert r.prompt_ids == [3, 5, 7] and r.tenant == "anonymous"
    r2 = proto.parse_completion_request({"prompt": "hi"}, 64)
    assert r2.prompt_ids == [2 + (b % 62) for b in b"hi"]


def _http_parse_rejects_malformed():
    for body, match in [({}, "prompt"), ({"prompt": []}, "prompt"),
                        ({"prompt": [999]}, "out of range"),
                        ({"prompt": [1], "max_tokens": 0}, "max_tokens"),
                        ({"prompt": [1], "max_tokens": "4"}, "max_tokens"),
                        ({"prompt": [1], "n": 0}, "n must"),
                        ({"prompt": [1], "n": True}, "n"),
                        ({"prompt": [1], "temperature": -1.0},
                         "temperature"),
                        ({"prompt": [1], "top_p": 0.0}, "top_p"),
                        ({"prompt": [1], "stream": 1}, "stream")]:
        with pytest.raises(ProtocolError, match=match):
            proto.parse_completion_request(body, 64)


def _http_parse_greedy_and_priority_thread_into_params():
    p = proto.parse_completion_request(
        {"prompt": [1], "temperature": 0.0, "priority": 3,
         "max_tokens": 5}, 64).sampling_params()
    assert p.greedy and p.priority == 3 and p.max_new_tokens == 5
    assert isinstance(p, SamplingParams)


def _http_parse_tenant_precedence_and_cap():
    body = {"prompt": [1], "user": "body-user", "max_tokens": 100}
    assert proto.parse_completion_request(body, 64).tenant == "body-user"
    r = proto.parse_completion_request(body, 64, tenant="key-9",
                                       max_tokens_cap=8)
    assert r.tenant == "key-9" and r.max_tokens == 8


def _http_render_prometheus_labels_and_filtering():
    assert proto.render_prometheus(
        {"r0": {"a": 1, "flag": True, "nested": {"x": 1}, "f": 2.5}},
        {"c": 3}) == ('repro_a{replica="r0"} 1\n'
                      'repro_f{replica="r0"} 2.5\n'
                      'repro_c 3\n')


def _http_streamed_completion_over_the_wire():
    srv, eng = _server()
    try:
        conn, resp = _request(srv.address, {
            "prompt": [3, 5], "max_tokens": 4, "stream": True})
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"
        events, done = _read_sse(resp)
        conn.close()
        assert done
        assert [t for e in events for c in e["choices"]
                for t in c["token_ids"] if c["index"] == 0] == \
            [(8 + k) % 64 for k in range(4)]
        assert [c["finish_reason"] for e in events for c in e["choices"]
                if c["finish_reason"]] == ["length"]
        assert all(e["id"].startswith("cmpl-") for e in events)
    finally:
        srv.close()


def _http_nonstream_aggregates_with_usage():
    srv, eng = _server()
    try:
        conn, resp = _request(srv.address, {
            "prompt": [3, 5], "max_tokens": 4, "n": 2, "stream": False})
        assert resp.status == 200
        out = json.loads(resp.read())
        conn.close()
        assert out["object"] == "text_completion"
        assert [c["token_ids"] for c in out["choices"]] == [
            [(8 + k) % 64 for k in range(4)],
            [(8 + 31 + k) % 64 for k in range(4)]]
        assert all(c["finish_reason"] == "length" for c in out["choices"])
        assert out["usage"] == {"prompt_tokens": 2, "completion_tokens": 8,
                                "total_tokens": 10}
    finally:
        srv.close()


def _http_429_when_queue_full():
    srv, eng = _server(max_queue=0)
    try:
        conn, resp = _request(srv.address, {"prompt": [3], "max_tokens": 2})
        assert resp.status == 429
        assert resp.headers["Retry-After"] == "1"
        assert json.loads(resp.read())["error"]["code"] == 429
        conn.close()
        assert eng.n_steps == 0
    finally:
        srv.close()


def _http_400_and_404():
    srv, _ = _server()
    try:
        conn = http.client.HTTPConnection(*srv.address, timeout=10)
        conn.request("POST", "/v1/completions", b"{not json",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        conn, resp = _request(srv.address, {"prompt": [1]},
                              path="/v1/nonesuch")
        assert resp.status == 404
        conn.close()
        conn, resp = _request(srv.address, {"max_tokens": 2})
        assert resp.status == 400
        assert "prompt" in json.loads(resp.read())["error"]["message"]
        conn.close()
    finally:
        srv.close()


def _http_health_models_metrics():
    srv, _ = _server()
    try:
        conn, resp = _request(srv.address, method="GET", path="/health")
        assert resp.status == 200
        h = json.loads(resp.read())
        conn.close()
        assert h["status"] == "ok" and h["replicas"]["r0"]["healthy"]
        conn, resp = _request(srv.address, method="GET", path="/v1/models")
        assert json.loads(resp.read())["data"][0]["id"] == "mock"
        conn.close()
        conn, resp = _request(srv.address, method="GET", path="/metrics")
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
        conn.close()
        assert 'repro_kv_blocks_total{replica="r0"} 64' in text
        assert "repro_admission_admitted_total 0" in text
        assert "repro_http_disconnects_total 0" in text
    finally:
        srv.close()


def _http_disconnect_mid_stream_aborts_and_reclaims():
    srv, eng = _server()
    try:
        conn, resp = _request(srv.address, {
            "prompt": [3], "max_tokens": 100_000, "stream": True})
        assert resp.status == 200
        assert resp.readline().startswith(b"data: ")
        resp.close()           # both handles hold the socket: close both
        conn.close()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if (eng.n_aborts == 1
                    and eng.load()["kv_blocks_free"] == eng.kv_blocks):
                break
            time.sleep(0.01)
        assert eng.n_aborts == 1
        assert eng.load()["kv_blocks_free"] == eng.kv_blocks
        assert srv.n_disconnects == 1
    finally:
        srv.close()


def _http_close_rejects_new_requests():
    srv, _ = _server()
    srv.admission.close()
    try:
        conn, resp = _request(srv.address, {"prompt": [1]}, timeout=10.0)
        assert resp.status == 503
        assert "draining" in json.loads(resp.read())["error"]["message"]
        conn.close()
    finally:
        srv.close()


HTTP_CASES = [v for k, v in list(globals().items()) if k.startswith("_http_")]


@pytest.mark.parametrize("case", HTTP_CASES,
                         ids=[c.__name__[6:] for c in HTTP_CASES])
def test_http_mock_cases(case):
    case()
