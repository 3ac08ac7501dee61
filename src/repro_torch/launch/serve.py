"""Serving entry point: the port's SiPipe engine end to end on a dense or
MoE model with a ShareGPT-shaped workload.

Offline batch (enqueue everything, then a blocking ``run()``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b

Online continuous serving (a Poisson arrival trace replayed through the
step-driven request API, ``add_request`` / ``step`` / ``abort``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --online --arrival-rate 8 --policy chunked --chunk-tokens 256

The OpenAI-style HTTP completions server (``repro_torch.serving``: N
engine replicas behind a least-loaded-KV router and admission control);
``--smoke`` runs its stdlib-client checks and exits with a status code:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --http --port 8000 --replicas 2

``--arch stablelm-1.6b`` serves the full-size configuration (random
weights from ``--seed``) in every mode; ``stablelm-1.6b-smoke`` the
reduced one.  ``--arch mixtral-8x7b-smoke`` serves the reduced MoE model
with its sliding window (W = 32, rolling KV cache); ``mixtral-8x7b`` at
its 32 published layers needs ~93 GB of bf16 weights, more than one 80 GB
card holds (``chip_smoke.py`` serves it cut to 16 layers).  The engine
runs on the card unless ``--device cpu`` is given.  Without
``--chunk-tokens`` the default policy prefills whole prompts
(monolithic); ``--chunk-tokens 256`` selects chunked prefill.
``--kv-layout contiguous`` serves over one cache row per sequence instead
of the paged cache (``auto``, the default, takes the paged one unless a
window is not a multiple of ``--block-size``).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from collections import deque

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, NaivePPEngine, SiPipeEngine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.registry import build_model
from repro_torch.runtime.data import ShareGPTLike

POLICY_CHOICES = ["auto", "monolithic", "chunked", "disaggregated", "adaptive"]
KV_LAYOUT_CHOICES = ["auto", "paged", "contiguous"]


def _build_model(arch: str, seed: int, device):
    """(cfg, model, params) of configuration ``arch`` (the size it names),
    random weights from ``seed`` on ``device`` (default: the card)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    return cfg, model, model.init(seed, device=resolve_device(device))


def _build_engine(arch: str, *, engine: str, pp: int, max_batch: int,
                  max_seq_len: int, n_samplers: int, chunk_tokens: int,
                  policy: str, hysteresis_tokens: int, tpot_slo_ms: float,
                  kv_layout: str = "auto", block_size: int = 16,
                  kv_blocks: int = 0, overlap_sampling: bool = True,
                  prefix_caching: bool = True, decode_enlarge_factor: int = 1,
                  keep_recent: int = 2048, seed: int = 0, prebuilt=None,
                  device=None):
    """``prebuilt`` = (cfg, model, params) skips the model build — callers
    comparing several engine configs on one model reuse it; the engine
    then runs where those parameters live, whatever ``device`` says."""
    cfg, model, params = (prebuilt if prebuilt is not None
                          else _build_model(arch, seed, device))
    ecfg = EngineConfig(pp_degree=pp, max_batch=max_batch,
                        max_seq_len=max_seq_len, n_samplers=n_samplers,
                        prefill_chunk_tokens=chunk_tokens or None,
                        scheduling_policy=policy,
                        phase_hysteresis_tokens=hysteresis_tokens or None,
                        tpot_slo_s=(tpot_slo_ms / 1e3) or None,
                        kv_layout=kv_layout, kv_block_size=block_size,
                        kv_blocks=kv_blocks or None,
                        overlap_sampling=overlap_sampling,
                        enable_prefix_caching=prefix_caching,
                        decode_enlarge_factor=decode_enlarge_factor,
                        keep_recent_requests=keep_recent, seed=seed)
    eng = (SiPipeEngine if engine == "sipipe" else NaivePPEngine)(
        model, params, ecfg)
    return cfg, eng


def _workload(cfg, n_requests: int, seed: int, max_seq_len: int,
              max_new_tokens: int) -> ShareGPTLike:
    return ShareGPTLike(cfg.vocab_size, n_requests=n_requests, seed=seed,
                        prompt_len_median=12, max_prompt=max_seq_len // 4,
                        output_len_median=max_new_tokens,
                        max_output=max_new_tokens)


# the serving CLI's sampling: temperature, top-k, top-p and penalties
SERVING_PARAMS = SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                frequency_penalty=0.2, presence_penalty=0.1)


def run(arch: str, *, engine: str = "sipipe", pp: int = 2, requests: int = 8,
        max_batch: int = 4, max_new_tokens: int = 16, max_seq_len: int = 256,
        n_samplers: int = 2, chunk_tokens: int = 0, policy: str = "auto",
        hysteresis_tokens: int = 0, tpot_slo_ms: float = 0.0,
        kv_layout: str = "auto", block_size: int = 16,
        kv_blocks: int = 0, n_samples: int = 1,
        prefix_caching: bool = True, seed: int = 0, device=None,
        verbose: bool = True) -> dict:
    """Offline batch mode: enqueue every prompt, blocking run()."""
    cfg, eng = _build_engine(arch, engine=engine, pp=pp, max_batch=max_batch,
                             max_seq_len=max_seq_len, n_samplers=n_samplers,
                             chunk_tokens=chunk_tokens, policy=policy,
                             hysteresis_tokens=hysteresis_tokens,
                             tpot_slo_ms=tpot_slo_ms, kv_layout=kv_layout,
                             block_size=block_size, kv_blocks=kv_blocks,
                             prefix_caching=prefix_caching, seed=seed,
                             device=device)
    wl = _workload(cfg, requests, seed, max_seq_len, max_new_tokens)
    for prompt, budget in wl.requests():
        eng.add_request(prompt, SamplingParams(
            **{**SERVING_PARAMS.__dict__, "n": n_samples,
               "max_new_tokens": min(budget, max_new_tokens)}))
    done = eng.run()
    m = eng.metrics()
    m["engine"] = engine
    m["finished"] = len(done)
    m["device"] = str(eng.device)
    if verbose:
        _print_metrics(m)
    return m


def run_online(arch: str, *, engine: str = "sipipe", pp: int = 2,
               requests: int = 8, max_batch: int = 4, max_new_tokens: int = 16,
               max_seq_len: int = 256, n_samplers: int = 2,
               chunk_tokens: int = 16, policy: str = "chunked",
               hysteresis_tokens: int = 0, tpot_slo_ms: float = 0.0,
               kv_layout: str = "auto", block_size: int = 16,
               kv_blocks: int = 0, overlap_sampling: bool = True,
               prefix_caching: bool = True, decode_enlarge_factor: int = 1,
               arrival_rate: float = 4.0, abort_every: int = 0,
               offline_requests: int = 0, seed: int = 0, device=None,
               verbose: bool = True, prebuilt=None) -> dict:
    """Online continuous serving: replay a Poisson arrival trace through
    the step-driven request API (``add_request``/``step``/``abort``),
    streaming tokens as they land and recording per-request
    TTFT/TPOT/queue-delay.

    ``abort_every`` > 0 cancels every Nth request after its first
    streamed token — the online smoke's abort-path coverage.

    ``offline_requests`` > 0 enqueues that many tier="offline" batch
    requests up front; they run only in scheduler slack and are
    accounted separately from the online trace.
    """
    cfg, eng = _build_engine(arch, engine=engine, pp=pp, max_batch=max_batch,
                             max_seq_len=max_seq_len, n_samplers=n_samplers,
                             chunk_tokens=chunk_tokens, policy=policy,
                             hysteresis_tokens=hysteresis_tokens,
                             tpot_slo_ms=tpot_slo_ms, kv_layout=kv_layout,
                             block_size=block_size, kv_blocks=kv_blocks,
                             overlap_sampling=overlap_sampling,
                             prefix_caching=prefix_caching,
                             decode_enlarge_factor=decode_enlarge_factor,
                             seed=seed, prebuilt=prebuilt, device=device)
    wl = _workload(cfg, requests, seed, max_seq_len, max_new_tokens)
    offline_rids: set = set()
    if offline_requests:
        owl = _workload(cfg, offline_requests, seed + 7919, max_seq_len,
                        max_new_tokens)
        for prompt, budget in owl.requests():
            offline_rids.add(eng.add_request(prompt, SamplingParams(
                **{**SERVING_PARAMS.__dict__, "tier": "offline",
                   "max_new_tokens": min(budget, max_new_tokens)})))
    trace = deque(wl.arrivals(arrival_rate))
    t0 = time.monotonic()
    n_submitted = n_finished = n_aborted = 0
    offline_finished = offline_tokens = 0
    abort_armed: set = set()
    streamed_tokens = 0
    while trace or eng.has_work:
        now = time.monotonic() - t0
        while trace and trace[0][0] <= now:
            t_arr, prompt, budget = trace.popleft()
            # backdate to the NOMINAL arrival: time spent queued outside
            # the engine (behind a blocking step) counts toward TTFT
            rid = eng.add_request(prompt, SamplingParams(
                **{**SERVING_PARAMS.__dict__,
                   "max_new_tokens": min(budget, max_new_tokens)}),
                arrival_t=t0 + t_arr)
            n_submitted += 1
            if abort_every and n_submitted % abort_every == 0:
                abort_armed.add(rid)
        outs = eng.step()
        for out in outs:
            if out.request_id in offline_rids:
                offline_tokens += len(out.new_token_ids)
                if out.finished:
                    offline_finished += 1
                continue
            streamed_tokens += len(out.new_token_ids)
            if out.finished:
                n_finished += out.state.name == "FINISHED"
                n_aborted += out.state.name == "ABORTED"
            elif out.request_id in abort_armed and out.token_ids:
                # mid-decode cancellation: the request already streamed
                # at least one token
                abort_armed.discard(out.request_id)
                eng.abort(out.request_id)
        if not outs and not eng.has_work and trace:
            # idle until the next arrival (bounded nap, wall-clock replay)
            time.sleep(min(0.002, max(0.0, trace[0][0] - now)))
    eng.shutdown()
    m = eng.metrics()
    m["engine"] = engine
    m["online"] = True
    m["arrival_rate_rps"] = arrival_rate
    m["finished"] = n_finished
    m["aborted"] = n_aborted
    m["streamed_tokens"] = streamed_tokens
    m["offline_submitted"] = len(offline_rids)
    m["offline_finished"] = offline_finished
    m["offline_streamed_tokens"] = offline_tokens
    m["device"] = str(eng.device)
    # the accounting invariant covers the ONLINE trace only; offline
    # completions are asserted separately (the loop runs to empty, so
    # every offline request must have finished too)
    assert n_finished + n_aborted == n_submitted == requests, \
        (n_finished, n_aborted, n_submitted)
    assert offline_finished == len(offline_rids), \
        (offline_finished, len(offline_rids))
    if verbose:
        _print_metrics(m)
    return m


def build_http_server(arch: str, *, engine: str = "sipipe", replicas: int = 1,
                      pp: int = 2, max_batch: int = 4, max_seq_len: int = 128,
                      n_samplers: int = 2, chunk_tokens: int = 16,
                      policy: str = "auto", kv_layout: str = "auto",
                      block_size: int = 16, kv_blocks: int = 0,
                      max_queue: int = 64, max_active: int = 0,
                      decode_enlarge_factor: int = 1,
                      host: str = "127.0.0.1", port: int = 0,
                      seed: int = 0, device=None, prebuilt=None):
    """Build (but don't start) the HTTP front-end: one model, N engine
    replicas behind a least-loaded-KV router, admission control, and the
    OpenAI-style completions server.  The replicas share the model's
    parameters; each has its own KV cache and stage threads."""
    from repro_torch.serving import CompletionServer, EngineReplica, Router

    if prebuilt is None:
        prebuilt = _build_model(arch, seed, device)
    cfg = prebuilt[0]
    reps = []
    for i in range(replicas):
        _, eng = _build_engine(arch, engine=engine, pp=pp,
                               max_batch=max_batch, max_seq_len=max_seq_len,
                               n_samplers=n_samplers,
                               chunk_tokens=chunk_tokens, policy=policy,
                               hysteresis_tokens=0, tpot_slo_ms=0.0,
                               kv_layout=kv_layout, block_size=block_size,
                               kv_blocks=kv_blocks,
                               decode_enlarge_factor=decode_enlarge_factor,
                               seed=seed, prebuilt=prebuilt)
        reps.append(EngineReplica(f"r{i}", eng))
    server = CompletionServer(Router(reps), vocab_size=cfg.vocab_size,
                              model_name=arch, max_queue=max_queue,
                              max_active=max_active or None,
                              host=host, port=port)
    return cfg, server


HOLD_TOKENS = 48     # the smoke's held stream: max_tokens
HOLD_MARGIN = 16     # its tokens kept back until the 429 probe is answered


class HoldGate:
    """Keeps the HTTP smoke's held stream from ending before its 429 probe.

    The probe needs the one active slot still held, and the slot is freed
    only when the held stream ends. Closed, the gate skips a replica's
    step while its only live request is the held one (``max_new_tokens ==
    HOLD_TOKENS``) with ``HOLD_MARGIN`` or fewer tokens left; any other
    request on the replica steps it as usual, and its control queues are
    drained between skipped steps. ``release()`` opens it for good."""

    def __init__(self, engines):
        self._open = threading.Event()
        for eng in engines:
            eng.step = self._gated(eng, eng.step)

    def release(self):
        self._open.set()

    def _gated(self, eng, step):
        def gated_step():
            if not self._open.is_set() and self._held_near_end(eng):
                self._open.wait(0.002)
                return []
            return step()
        return gated_step

    @staticmethod
    def _held_near_end(eng) -> bool:
        reqs = list(eng.requests.values())
        if len(reqs) != 1:
            return False
        seq = reqs[0].seq
        return (seq.params.max_new_tokens == HOLD_TOKENS
                and HOLD_TOKENS - len(seq.output_ids) <= HOLD_MARGIN)


def start_smoke_server(arch: str, *, replicas: int = 1, **kw):
    """The HTTP smoke's server, started: one active slot and a queue of one
    on an ephemeral port, each replica warmed by one short greedy request
    (its first prefill and batch-1 decode steps, graphs on the card), and
    a closed :class:`HoldGate` over the replicas. Returns ``(server,
    gate)``; pass the gate to :func:`_http_smoke`."""
    kw["max_queue"], kw["max_active"] = 1, 1
    _, server = build_http_server(arch, replicas=replicas, port=0, **kw)
    for rep in server.router.replicas:
        rep.engine.add_request([2, 3], SamplingParams(greedy=True,
                                                      max_new_tokens=4))
        while rep.engine.has_work:
            rep.engine.step()
    gate = HoldGate([rep.engine for rep in server.router.replicas])
    server.start()
    return server, gate


def run_http(arch: str, *, port: int = 8000, replicas: int = 1,
             smoke: bool = False, **kw) -> int:
    """Serve over HTTP until interrupted; ``smoke=True`` instead runs the
    in-process stdlib-client checks (streaming + 429 + /metrics) against
    a tiny-cap server (:func:`start_smoke_server`) and returns an exit
    code."""
    if smoke:
        server, gate = start_smoke_server(arch, replicas=replicas, **kw)
    else:
        _, server = build_http_server(arch, replicas=replicas, port=port,
                                      **kw)
        server.start()
    host, bound = server.address
    print(f"serving on http://{host}:{bound} "
          f"(replicas={replicas}, smoke={smoke})", flush=True)
    if smoke:
        try:
            _http_smoke(host, bound, gate)
            print("HTTP smoke OK", flush=True)
            return 0
        except Exception as e:     # noqa: BLE001 — exit-code gate
            import traceback
            traceback.print_exc()
            print(f"HTTP smoke FAILED: {e}", flush=True)
            return 1
        finally:
            server.close()
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def _http_smoke(host: str, port: int, gate: HoldGate):
    """Stdlib-client smoke against a live server with max_active=1,
    max_queue=1 (:func:`start_smoke_server`): (1) a streamed greedy
    completion produces SSE chunks and [DONE]; (2) with the single active
    slot held by a live stream, an offline /v1/batches submission still
    completes (it bypasses the online window), and with the queue full a
    further online request gets 429 + Retry-After while the held stream
    keeps producing; ``gate`` keeps the held stream's last tokens back
    until the 429 is in, so the check does not depend on timing; (3)
    /metrics scrapes as Prometheus text."""
    try:
        _http_smoke_checks(host, port, gate)
    finally:
        gate.release()          # never leave a replica gated at close


def _http_smoke_checks(host: str, port: int, gate: HoldGate):
    import http.client

    def post(body, extra_headers=None):
        c = http.client.HTTPConnection(host, port, timeout=120)
        c.request("POST", "/v1/completions", json.dumps(body),
                  {"Content-Type": "application/json",
                   **(extra_headers or {})})
        return c, c.getresponse()

    # 1) plain streamed completion end-to-end
    c, r = post({"prompt": [5, 9, 13], "max_tokens": 4,
                 "temperature": 0.0, "stream": True})
    assert r.status == 200, r.status
    events = _read_sse(r)
    assert events and events[-1] == "[DONE]", events[-2:]
    toks = []
    for ev in events[:-1]:
        toks += json.loads(ev)["choices"][0]["token_ids"]
    assert len(toks) == 4, toks
    c.close()

    # 2) hold the active slot with a long stream, fill the queue, expect
    #    429 on the next arrival — while the held stream stays live
    hold_c, hold_r = post({"prompt": [2, 3], "max_tokens": HOLD_TOKENS,
                           "temperature": 0.0, "stream": True})
    assert hold_r.status == 200
    first = _read_sse(hold_r, max_events=1)    # it is actively decoding
    assert first and first[0] != "[DONE]"

    # 2a) hybrid tier: with max_active=1 HELD by the live stream, an
    #     offline batch must still go through — offline bypasses the
    #     online dispatch window and runs in engine slack
    cb = http.client.HTTPConnection(host, port, timeout=120)
    cb.request("POST", "/v1/batches", json.dumps({
        "requests": [{"prompt": [7, 8, 9], "max_tokens": 3,
                      "temperature": 0.0}]}),
               {"Content-Type": "application/json"})
    rb = cb.getresponse()
    assert rb.status == 200, rb.status
    batch = json.loads(rb.read())
    cb.close()
    assert batch["object"] == "batch", batch
    assert len(batch["results"]) == 1
    assert len(batch["results"][0]["choices"][0]["token_ids"]) == 3, batch

    queued_done = threading.Event()

    def queued():
        c2, r2 = post({"prompt": [4, 5], "max_tokens": 2,
                       "temperature": 0.0, "stream": True})
        _read_sse(r2)
        c2.close()
        queued_done.set()

    qt = threading.Thread(target=queued, daemon=True)
    qt.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:   # wait until it occupies the queue
        c3 = http.client.HTTPConnection(host, port, timeout=30)
        c3.request("GET", "/metrics")
        pending = [ln for ln in c3.getresponse().read().decode().splitlines()
                   if ln.startswith("repro_admission_pending")]
        c3.close()
        if pending and pending[0].endswith(" 1"):
            break
        time.sleep(0.05)
    c4, r4 = post({"prompt": [6], "max_tokens": 2, "stream": False})
    assert r4.status == 429, r4.status
    assert r4.getheader("Retry-After"), "429 must carry Retry-After"
    c4.close()
    gate.release()
    rest = _read_sse(hold_r)                  # held stream was not perturbed
    assert rest and rest[-1] == "[DONE]"
    held = [t for ev in first + rest[:-1]
            for t in json.loads(ev)["choices"][0]["token_ids"]]
    assert len(held) == HOLD_TOKENS, len(held)
    hold_c.close()
    assert queued_done.wait(60), "queued request never completed"
    qt.join(5)

    # 3) Prometheus scrape
    c5 = http.client.HTTPConnection(host, port, timeout=30)
    c5.request("GET", "/metrics")
    r5 = c5.getresponse()
    assert r5.status == 200
    text = r5.read().decode()
    c5.close()
    assert 'repro_requests_finished{replica="r0"}' in text, text[:400]
    assert "repro_admission_rejected_total 1" in text, text[:400]
    assert "repro_admission_offline_admitted_total 1" in text, text[:400]
    assert 'repro_slack_tokens_sold{replica="r0"}' in text, text[:400]


def _read_sse(resp, max_events: int = 0):
    """Read SSE ``data:`` payloads off an http.client response (until
    [DONE]/EOF, or the first ``max_events`` if set)."""
    events = []
    while True:
        line = resp.fp.readline()
        if not line:
            return events
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        events.append(line[len("data: "):])
        if events[-1] == "[DONE]" or (max_events and
                                      len(events) >= max_events):
            return events


def _print_metrics(m: dict):
    print(json.dumps({k: v for k, v in m.items()
                      if k not in ("stages", "requests")},
                     indent=1, default=float))
    for i, st in enumerate(m["stages"]):
        print(f"  stage{i}: busy={st['busy_s']:.2f}s "
              f"prep={st['prep_s']:.2f}s bubble={st['bubble_frac']:.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="architecture id; a '-smoke' suffix selects the "
                         "reduced configuration")
    ap.add_argument("--engine", default="sipipe", choices=["sipipe", "naive"])
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--samplers", type=int, default=2)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="per-iteration token budget for span scheduling "
                         "policies (0 = monolithic prefill)")
    ap.add_argument("--policy", default="auto", choices=POLICY_CHOICES,
                    help="scheduling policy; 'auto' maps a token budget to "
                         "chunked and no budget to monolithic")
    ap.add_argument("--hysteresis-tokens", type=int, default=0,
                    help="disaggregated decode->prefill switch threshold in "
                         "pending prefill tokens per paused decode slot "
                         "(0 = the token budget)")
    ap.add_argument("--tpot-slo-ms", type=float, default=0.0,
                    help="adaptive policy: target mean inter-token latency "
                         "in ms (0 = self-calibrate from the first window); "
                         "disaggregated policy: prefill-phase length cap")
    ap.add_argument("--kv-layout", default="auto", choices=KV_LAYOUT_CHOICES,
                    help="KV cache layout: paged block tables or one "
                         "contiguous row per sequence ('auto': paged "
                         "unless a window is not a block multiple)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV slots per physical block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="total physical blocks (0 = the slot budget "
                         "contiguous rows would reserve)")
    ap.add_argument("--no-prefix-caching", action="store_true",
                    help="disable hash-based prompt-prefix block sharing "
                         "(paged layout)")
    ap.add_argument("-n", "--n-samples", type=int, default=1,
                    help="parallel sampling: completions per request "
                         "(n > 1 CoW-forks the prompt KV; paged layout, "
                         "offline mode)")
    ap.add_argument("--online", action="store_true",
                    help="continuous serving: Poisson arrivals replayed "
                         "through the step-driven request API")
    ap.add_argument("--http", action="store_true",
                    help="serve the OpenAI-style HTTP completions API "
                         "over N engine replicas")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP mode: listen port (0 = ephemeral)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="HTTP mode: in-process engine replicas behind "
                         "the least-loaded-KV router")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="HTTP mode: admission queue cap (full = 429)")
    ap.add_argument("--max-active", type=int, default=0,
                    help="HTTP mode: dispatched-request window "
                         "(0 = unbounded)")
    ap.add_argument("--smoke", action="store_true",
                    help="HTTP mode: run the stdlib-client smoke checks "
                         "(streaming + 429 + /metrics) and exit with a "
                         "status code")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="online mode: Poisson arrival rate (requests/s)")
    ap.add_argument("--abort-every", type=int, default=0,
                    help="online mode: abort every Nth request after its "
                         "first streamed token (0 = never)")
    ap.add_argument("--offline-requests", type=int, default=0,
                    help="online mode: tier='offline' batch requests "
                         "enqueued up front, served only in scheduler "
                         "slack (paged layout)")
    ap.add_argument("--decode-enlarge-factor", type=int, default=1,
                    help="disaggregated policy: decode-phase batch "
                         "enlargement cap for offline work, pow2 rungs "
                         "up to max_batch * factor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args()
    common = dict(engine=args.engine, pp=args.pp, requests=args.requests,
                  max_batch=args.max_batch, max_new_tokens=args.max_new_tokens,
                  n_samplers=args.samplers, chunk_tokens=args.chunk_tokens,
                  policy=args.policy, hysteresis_tokens=args.hysteresis_tokens,
                  tpot_slo_ms=args.tpot_slo_ms, kv_layout=args.kv_layout,
                  block_size=args.block_size, kv_blocks=args.kv_blocks,
                  prefix_caching=not args.no_prefix_caching,
                  decode_enlarge_factor=args.decode_enlarge_factor,
                  seed=args.seed, device=args.device)
    if args.http:
        raise SystemExit(run_http(
            args.arch, port=args.port, replicas=args.replicas,
            smoke=args.smoke, engine=args.engine, pp=args.pp,
            max_batch=args.max_batch, n_samplers=args.samplers,
            chunk_tokens=args.chunk_tokens, policy=args.policy,
            kv_layout=args.kv_layout, block_size=args.block_size,
            kv_blocks=args.kv_blocks, max_queue=args.max_queue,
            max_active=args.max_active, seed=args.seed, device=args.device))
    if args.online:
        run_online(args.arch, arrival_rate=args.arrival_rate,
                   abort_every=args.abort_every,
                   offline_requests=args.offline_requests, **common)
    else:
        common.pop("decode_enlarge_factor", None)
        run(args.arch, n_samples=args.n_samples, **common)


if __name__ == "__main__":
    main()
