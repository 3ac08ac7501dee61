"""In-process engine fleet: replicas + least-loaded-KV routing
(docs/http.md §Router).

Each :class:`EngineReplica` owns ONE loop thread that is the only
thread ever touching its engine: HTTP handler threads enqueue
submissions/aborts onto thread-safe queues, the loop drains them
between ``step()`` calls and fans each request's ``RequestOutput``
stream out to a per-request queue the handler consumes.  This keeps the
engine's single-driver threading contract (docs/serving.md) while any
number of connections stream concurrently.

The :class:`Router` places each request on the healthy replica with the
most free KV blocks (per-replica ``engine.load()`` feedback), breaking
ties by total load (queued + active requests) then replica order — so
K concurrent requests spread across the fleet instead of piling onto
replica 0.  Health = loop thread alive and no crash recorded;
``shutdown(drain=True)`` stops new work and lets every replica run its
in-flight requests to completion before stopping the engines.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.sampling_params import SamplingParams


class ReplicaUnavailable(RuntimeError):
    """No healthy replica can take the request (server maps to 503)."""


class _Submit:
    __slots__ = ("prompt_ids", "params", "arrival_t", "done", "rid",
                 "out_q", "error")

    def __init__(self, prompt_ids, params, arrival_t):
        self.prompt_ids = prompt_ids
        self.params = params
        self.arrival_t = arrival_t
        self.done = threading.Event()
        self.rid: Optional[int] = None
        self.out_q: Optional["queue.Queue"] = None
        self.error: Optional[BaseException] = None


class EngineReplica:
    """One engine + its serving loop thread."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self._submit_q: "queue.Queue[_Submit]" = queue.Queue()
        self._abort_q: "queue.Queue[int]" = queue.Queue()
        self._streams: Dict[int, "queue.Queue"] = {}
        self._streams_lock = threading.Lock()
        self._wake = threading.Event()
        self._draining = False
        self._stop = False
        self.error: Optional[BaseException] = None
        self.heartbeat = 0.0
        self.peak_busy_blocks = 0       # router-balance accounting (bench)
        self._thread = threading.Thread(target=self._loop,
                                        name=f"replica-{name}", daemon=True)

    def start(self) -> "EngineReplica":
        self._thread.start()
        return self

    # -- handler-thread surface ---------------------------------------------
    @property
    def healthy(self) -> bool:
        return (self._thread.is_alive() and self.error is None
                and not self._draining)

    def load(self) -> Dict[str, int]:
        """Engine load snapshot plus the not-yet-ingested submit backlog.
        Reads only counters/lens — safe from any thread.  The backlog is
        split by tier: offline submissions ride ``offline_queue_depth``
        so a deep batch backlog never repels ONLINE placements
        (docs/hybrid.md — the engine runs offline work in slack only)."""
        snap = self.engine.load()
        backlog_online = backlog_offline = 0
        with self._submit_q.mutex:
            for sub in self._submit_q.queue:
                if getattr(sub.params, "tier", "online") == "offline":
                    backlog_offline += 1
                else:
                    backlog_online += 1
        snap["queue_depth"] += backlog_online
        snap["offline_queue_depth"] = (
            snap.get("offline_queue_depth", 0) + backlog_offline)
        return snap

    def submit(self, prompt_ids: List[int], params: SamplingParams,
               arrival_t: Optional[float] = None,
               timeout: float = 120.0) -> Tuple[int, "queue.Queue"]:
        """Hand a request to the loop thread; returns ``(request_id,
        output_queue)`` once admitted.  The queue yields this request's
        ``RequestOutput`` increments in order; the ``finished=True``
        increment is the last item."""
        if not self.healthy:
            raise ReplicaUnavailable(f"replica {self.name} is not serving")
        sub = _Submit(prompt_ids, params, arrival_t)
        self._submit_q.put(sub)
        self._wake.set()
        # a step mid-flight (first-request jit compile) can hold the loop
        # for seconds — the admission wait is bounded, not instant
        if not sub.done.wait(timeout):
            raise ReplicaUnavailable(
                f"replica {self.name} did not admit within {timeout}s")
        if sub.error is not None:
            raise sub.error
        # the stream queue rides on the _Submit itself: looking it up in
        # _streams here would race a request fast enough to finish (and
        # be popped by _route) before this thread wakes
        return sub.rid, sub.out_q

    def abort(self, request_id: int):
        self._abort_q.put(request_id)
        self._wake.set()

    def metrics(self) -> Dict[str, Any]:
        return self.engine.metrics()

    # -- serving loop --------------------------------------------------------
    def _loop(self):
        try:
            while not self._stop:
                self._drain_control_queues()
                if self.engine.has_work:
                    outs = self.engine.step()
                    self._route(outs)
                    self._track_occupancy()
                elif self._draining:
                    break
                else:
                    self._wake.wait(0.002)
                    self._wake.clear()
        except BaseException as e:          # noqa: BLE001 — recorded, fleet
            self.error = e                  # health check reroutes traffic
            self._fail_streams(e)
        finally:
            try:
                self.engine.shutdown()
            except Exception:
                pass

    def _drain_control_queues(self):
        self.heartbeat = time.monotonic()
        while True:
            try:
                sub = self._submit_q.get_nowait()
            except queue.Empty:
                break
            try:
                rid = self.engine.add_request(sub.prompt_ids, sub.params,
                                              arrival_t=sub.arrival_t)
                sub.out_q = queue.Queue()
                with self._streams_lock:
                    self._streams[rid] = sub.out_q
                sub.rid = rid
            except Exception as e:
                sub.error = e
            sub.done.set()
        while True:
            try:
                rid = self._abort_q.get_nowait()
            except queue.Empty:
                break
            self.engine.abort(rid)

    def _route(self, outs):
        for out in outs:
            with self._streams_lock:
                q = self._streams.get(out.request_id)
                if out.finished:
                    self._streams.pop(out.request_id, None)
            if q is not None:
                q.put(out)

    def _track_occupancy(self):
        snap = self.engine.load()
        busy = snap["kv_blocks_total"] - snap["kv_blocks_free"]
        if busy > self.peak_busy_blocks:
            self.peak_busy_blocks = busy

    def _fail_streams(self, exc: BaseException):
        with self._streams_lock:
            streams, self._streams = list(self._streams.values()), {}
        for q in streams:
            q.put(exc)

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> bool:
        """Stop taking new requests, run in-flight work to completion,
        shut the engine down.  Returns True on a clean drain."""
        self._draining = True
        self._wake.set()
        self._thread.join(timeout)
        clean = not self._thread.is_alive()
        if not clean:
            self._stop = True
            self._wake.set()
            self._thread.join(5.0)
        return clean

    def kill(self):
        """Hard stop (tests); in-flight requests get no final output."""
        self._stop = True
        self._wake.set()
        self._thread.join(10.0)


class Router:
    """Least-loaded-KV placement over N replicas."""

    def __init__(self, replicas: List[EngineReplica]):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = replicas
        self._lock = threading.Lock()
        self.routed: Dict[str, int] = {r.name: 0 for r in replicas}

    def start(self) -> "Router":
        for r in self.replicas:
            r.start()
        return self

    def pick(self) -> EngineReplica:
        """The healthy replica with the most free KV blocks; ties fall to
        the least total load (queued + active), then replica order."""
        ranked = []
        for i, r in enumerate(self.replicas):
            if not r.healthy:
                continue
            snap = r.load()
            ranked.append((-snap["kv_blocks_free"],
                           snap["queue_depth"] + snap["active_requests"],
                           i, r))
        if not ranked:
            raise ReplicaUnavailable("no healthy replica")
        return min(ranked)[3]

    def submit(self, prompt_ids: List[int], params: SamplingParams,
               arrival_t: Optional[float] = None,
               ) -> Tuple[EngineReplica, int, "queue.Queue"]:
        with self._lock:
            r = self.pick()
            self.routed[r.name] += 1
        rid, out_q = r.submit(prompt_ids, params, arrival_t)
        return r, rid, out_q

    def health(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for r in self.replicas:
            entry: Dict[str, Any] = {"healthy": r.healthy}
            if r.error is not None:
                entry["error"] = repr(r.error)
            if r.healthy:
                entry.update(r.load())
            out[r.name] = entry
        return out

    def metrics(self) -> Dict[str, Dict[str, Any]]:
        return {r.name: r.metrics() for r in self.replicas
                if r.error is None}

    def shutdown(self, drain: bool = True, timeout: float = 60.0):
        if drain:
            threads = [threading.Thread(target=r.drain, args=(timeout,))
                       for r in self.replicas]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout + 5.0)
        else:
            for r in self.replicas:
                r.kill()
