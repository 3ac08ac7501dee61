"""Stdlib-only HTTP front-end: OpenAI-style completions over the engine
(docs/http.md).

Endpoints (all JSON unless noted):

  POST /v1/completions   completion request; ``"stream": true`` returns
                         Server-Sent Events (``data: {chunk}\\n\\n`` ...
                         ``data: [DONE]\\n\\n``), else the aggregate
                         completion object.  ``n > 1`` streams every
                         fork as its own choice index.  ``"tier":
                         "offline"`` marks best-effort batch traffic
                         (docs/hybrid.md).
  POST /v1/batches       offline batch enqueue: ``{"requests": [...]}``
                         of completion bodies, all forced to the
                         offline tier; blocks until every one finishes
                         and returns their completion objects in order.
                         Offline queue overflow is 503 + a tier body,
                         not 429 (batch clients back off, not retry).
  GET  /v1/models        the served model list.
  GET  /health           router + replica health.
  GET  /metrics          Prometheus text of every replica's
                         ``engine.metrics()`` + admission counters.

Built on ``http.server.ThreadingHTTPServer`` — one stdlib thread per
connection.  Handler threads never touch an engine: admission happens
in :class:`~repro.serving.admission.AdmissionController`, placement in
:class:`~repro.serving.router.Router`, and all engine calls run on the
chosen replica's loop thread.  A client that disconnects mid-stream
(write fails) gets its request aborted on the replica, so KV blocks
are reclaimed (tests/test_http.py e2e).
"""
from __future__ import annotations

import json
import queue
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.request import RequestState
from repro_torch.serving import admission as adm
from repro_torch.serving import protocol as proto
from repro_torch.serving.router import ReplicaUnavailable, Router

# streamed requests wait this long for the next RequestOutput before the
# server gives up on the replica (first-token jit compiles take seconds,
# so this is generous)
STREAM_IDLE_TIMEOUT_S = 120.0


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    ctx: "CompletionServer"


class CompletionServer:
    """The serving front-end: router + admission + HTTP transport."""

    def __init__(self, router: Router, *, vocab_size: int,
                 model_name: str = "repro", max_queue: int = 64,
                 max_active: Optional[int] = None, max_tokens_cap: int = 0,
                 host: str = "127.0.0.1", port: int = 0):
        self.router = router
        self.vocab_size = vocab_size
        self.model_name = model_name
        self.max_tokens_cap = max_tokens_cap
        self.admission = adm.AdmissionController(max_queue=max_queue,
                                                 max_active=max_active)
        self.n_disconnects = 0
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.ctx = self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._closed = False

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "CompletionServer":
        self.router.start()
        self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: float = 60.0):
        """Drain-on-shutdown: stop admitting (new requests see 503), let
        in-flight requests finish, then stop replicas and the listener."""
        if self._closed:
            return
        self._closed = True
        self.admission.close()
        self.router.shutdown(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def ctx(self) -> CompletionServer:
        return self.server.ctx          # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet: tests/benches parse stdout
        pass

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, code: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None):
        body = json.dumps(payload, sort_keys=True).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str,
               headers: Optional[Dict[str, str]] = None,
               body_extra: Optional[Dict[str, Any]] = None):
        err: Dict[str, Any] = {"message": message, "code": code}
        err.update(body_extra or {})
        self._send_json(code, {"error": err}, headers)

    def _tenant(self, body: Dict[str, Any]) -> Optional[str]:
        key = self.headers.get("X-API-Key")
        if not key:
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                key = auth[len("Bearer "):].strip()
        return key or None

    # -- GET endpoints -------------------------------------------------------
    def do_GET(self):
        ctx = self.ctx
        if self.path == "/health":
            health = ctx.router.health()
            ok = any(h.get("healthy") for h in health.values())
            self._send_json(200 if ok else 503,
                            {"status": "ok" if ok else "unavailable",
                             "replicas": health})
        elif self.path == "/v1/models":
            self._send_json(200, {"object": "list", "data": [{
                "id": ctx.model_name, "object": "model",
                "owned_by": "repro"}]})
        elif self.path == "/metrics":
            text = proto.render_prometheus(
                ctx.router.metrics(),
                {**ctx.admission.snapshot(),
                 "http_disconnects_total": ctx.n_disconnects})
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._error(404, f"no such endpoint: {self.path}")

    def _queue_full(self, e: "adm.QueueFull"):
        """Map a tier's queue overflow to its status: online -> 429 +
        Retry-After (interactive clients retry soon), offline -> 503 + a
        tier-carrying body (batch clients should back off).  Both bodies
        name the tier so callers can tell WHICH queue overflowed."""
        if e.tier == "offline":
            self._error(503, "offline admission queue full",
                        body_extra={"tier": "offline",
                                    "retry_after": e.retry_after})
        else:
            self._error(429, "admission queue full",
                        {"Retry-After": str(e.retry_after)},
                        body_extra={"tier": "online"})

    # -- POST /v1/completions, /v1/batches -----------------------------------
    def do_POST(self):
        if self.path == "/v1/batches":
            self._batches()
            return
        if self.path != "/v1/completions":
            self._error(404, f"no such endpoint: {self.path}")
            return
        ctx = self.ctx
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            req = proto.parse_completion_request(
                body, ctx.vocab_size, tenant=self._tenant(body),
                max_tokens_cap=ctx.max_tokens_cap)
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._error(400, "request body is not valid JSON")
            return
        except proto.ProtocolError as e:
            self._error(400, str(e))
            return

        try:
            ticket = ctx.admission.submit(priority=req.priority,
                                          tenant=req.tenant, tier=req.tier)
        except adm.QueueFull as e:
            self._queue_full(e)
            return
        except adm.Closed:
            self._error(503, "server is draining")
            return

        try:
            ctx.admission.wait(ticket)
            if ticket.cancelled:
                self._error(503, "server is draining")
                return
            try:
                replica, rid, out_q = ctx.router.submit(
                    req.prompt_ids, req.sampling_params(),
                    arrival_t=time.monotonic())
            except (ReplicaUnavailable, ValueError) as e:
                self._error(503 if isinstance(e, ReplicaUnavailable)
                            else 400, str(e))
                return
            created = int(time.time())
            if req.stream:
                self._stream(req, replica, rid, out_q, created)
            else:
                self._aggregate(req, replica, rid, out_q, created)
        finally:
            ctx.admission.release(ticket)

    def _next_output(self, replica, rid, out_q):
        """The request's next RequestOutput, or None on replica failure
        (crash exceptions ride the same queue)."""
        try:
            out = out_q.get(timeout=STREAM_IDLE_TIMEOUT_S)
        except queue.Empty:
            replica.abort(rid)
            return None
        if isinstance(out, BaseException):
            return None
        return out

    def _stream(self, req, replica, rid, out_q, created):
        ctx = self.ctx
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        # backstop for a live-but-stalled reader: a zero receive window
        # never fails sendall, it blocks — bound the stall
        self.connection.settimeout(STREAM_IDLE_TIMEOUT_S)
        finished_idx = set()

        def emit(payload: bytes) -> bool:
            try:
                # a closed client often does NOT fail our writes: its FIN
                # leaves the kernel ACKing into an orphaned socket until
                # the window fills, wedging sendall forever.  An SSE
                # client never sends mid-stream, so readability + empty
                # peek IS the disconnect — detect it, don't await it.
                r, _, _ = select.select([self.connection], [], [], 0)
                if r and not self.connection.recv(1, socket.MSG_PEEK):
                    raise OSError("client closed the connection")
                self.wfile.write(payload)
                self.wfile.flush()
                return True
            except OSError:
                # client went away mid-stream: reclaim the KV blocks
                ctx.n_disconnects += 1
                replica.abort(rid)
                return False

        while True:
            out = self._next_output(replica, rid, out_q)
            if out is None:
                emit(proto.sse_event({"error": {
                    "message": "replica failed mid-stream", "code": 500}}))
                return
            # the primary choice can finish while forks keep the request
            # open (n > 1): detect it from the ``state`` SNAPSHOT taken on
            # the engine thread at emit time — never from the live ``seq``,
            # which the loop thread keeps mutating under this reader.  Its
            # finish chunk waits for an increment with an empty delta (or
            # the request close), so a final token landing after the
            # snapshot is never sealed off behind a finish_reason.
            primary_done = out.finished or out.state in (
                RequestState.FINISHED, RequestState.ABORTED)
            reason = out.finish_reason
            if reason is None and primary_done and out.seq is not None:
                reason = out.seq.finish_reason
            seal = (out.finished or (primary_done
                                     and not out.new_token_ids)) \
                and reason is not None
            # (choice index, delta, this-choice-finished, finish_reason)
            slices = [(0, list(out.new_token_ids), seal,
                       reason if seal else None)]
            for fo in out.forks or []:
                fdone = fo.finished and fo.finish_reason is not None
                slices.append((fo.index, list(fo.new_token_ids), fdone,
                               fo.finish_reason if fdone else None))
            for idx, delta, done, reason in slices:
                if idx in finished_idx or not (delta or done):
                    continue
                chunk = proto.completion_chunk(
                    rid, created, req.model, idx, delta,
                    reason if done else None)
                if done:
                    finished_idx.add(idx)
                if not emit(proto.sse_event(chunk)):
                    return
            if out.finished:
                emit(proto.SSE_DONE)
                return

    def _collect(self, req, replica, rid, out_q,
                 created) -> Optional[Dict[str, Any]]:
        """Drain a request's RequestOutputs to completion; the aggregate
        completion payload, or None on replica failure."""
        toks: Dict[int, list] = {0: []}
        reasons: Dict[int, Optional[str]] = {}
        while True:
            out = self._next_output(replica, rid, out_q)
            if out is None:
                return None
            toks[0].extend(out.new_token_ids)
            for fo in out.forks or []:
                toks.setdefault(fo.index, []).extend(fo.new_token_ids)
                if fo.finished:
                    reasons[fo.index] = fo.finish_reason
            if out.finished:
                reasons[0] = out.finish_reason
                break
        choices = [{"token_ids": toks[i], "finish_reason": reasons.get(i)}
                   for i in sorted(toks)]
        return proto.completion_response(
            rid, created, req.model, choices, len(req.prompt_ids))

    def _aggregate(self, req, replica, rid, out_q, created):
        payload = self._collect(req, replica, rid, out_q, created)
        if payload is None:
            self._error(500, "replica failed mid-request")
        else:
            self._send_json(200, payload)

    # -- POST /v1/batches ----------------------------------------------------
    def _batches(self):
        """Offline batch enqueue (docs/hybrid.md): every entry of the
        ``requests`` list is parsed as a completion body FORCED to the
        offline tier, submitted through admission (offline cap, no
        online window) + the router, and the response blocks until all
        of them finish.  The engines run them only in scheduler slack —
        a saturating batch here never delays online traffic."""
        ctx = self.ctx
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise proto.ProtocolError("request body must be a JSON object")
            entries = body.get("requests")
            if not isinstance(entries, list) or not entries:
                raise proto.ProtocolError(
                    "'requests' must be a non-empty list of completion "
                    "request objects")
            tenant = self._tenant(body)
            reqs = []
            for entry in entries:
                if not isinstance(entry, dict):
                    raise proto.ProtocolError(
                        "each batch entry must be a JSON object")
                entry = dict(entry, tier="offline", stream=False)
                reqs.append(proto.parse_completion_request(
                    entry, ctx.vocab_size, tenant=tenant,
                    max_tokens_cap=ctx.max_tokens_cap))
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._error(400, "request body is not valid JSON")
            return
        except proto.ProtocolError as e:
            self._error(400, str(e))
            return

        tickets = []
        try:
            try:
                for r in reqs:
                    tickets.append(ctx.admission.submit(
                        priority=r.priority, tenant=r.tenant,
                        tier="offline"))
            except adm.QueueFull as e:
                self._queue_full(e)
                return
            except adm.Closed:
                self._error(503, "server is draining")
                return
            created = int(time.time())
            submitted = []
            try:
                for r in reqs:
                    replica, rid, out_q = ctx.router.submit(
                        r.prompt_ids, r.sampling_params(),
                        arrival_t=time.monotonic())
                    submitted.append((r, replica, rid, out_q))
            except (ReplicaUnavailable, ValueError) as e:
                for _, replica, rid, _ in submitted:
                    replica.abort(rid)
                self._error(503 if isinstance(e, ReplicaUnavailable)
                            else 400, str(e))
                return
            results = []
            for r, replica, rid, out_q in submitted:
                payload = self._collect(r, replica, rid, out_q, created)
                if payload is None:
                    for _, rep2, rid2, _ in submitted:
                        rep2.abort(rid2)
                    self._error(500, "replica failed mid-batch")
                    return
                results.append(payload)
            self._send_json(200, {"object": "batch", "created": created,
                                  "results": results})
        finally:
            for t in tickets:
                ctx.admission.release(t)
