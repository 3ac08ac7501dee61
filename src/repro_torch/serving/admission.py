"""Server-side admission control (docs/http.md §Admission).

Sits between the HTTP handler threads and the router: every completion
request takes a :class:`Ticket` here BEFORE touching any engine.  The
controller enforces

  * a queue cap — more than ``max_queue`` undispatched tickets rejects
    with :class:`QueueFull` (the server maps it to HTTP 429 +
    ``Retry-After``) without perturbing anything already running;
  * a dispatch window — at most ``max_active`` tickets are dispatched
    (= submitted to an engine) at once, so the engines' own waiting
    queues stay shallow and priority reordering happens HERE, where the
    full picture (tenant, priority, arrival) is visible;
  * dispatch order: priority desc, then per-tenant fair share (fewest
    in-flight requests first — a tenant flooding the queue cannot starve
    others at equal priority), then FIFO arrival.

The scheduler below repeats the priority-then-FIFO ordering for
whatever does reach an engine queue, and its preemption victim choice
is lowest-priority-then-latest-arrival — so priorities hold end to end:
admission, engine queueing, and block-pressure eviction.

Hybrid tier (docs/hybrid.md): ``tier="offline"`` tickets live OUTSIDE
the online accounting entirely.  They never occupy the online queue or
the ``max_active`` dispatch window (the engines' slack admission is the
real throttle for offline work — holding it behind the online window
would let batch traffic starve, or worse, let a deep batch backlog eat
the window and delay SLO traffic).  They are capped separately: at most
``max_queue_offline`` offline tickets may be live (submitted, not yet
released) at once; beyond that ``submit`` raises :class:`QueueFull`
with ``tier="offline"``, which the server maps to HTTP 503 + a
tier-carrying body (a batch client should back off much longer than an
interactive one — 429/Retry-After semantics are wrong for it).

The ``Retry-After`` hint on online 429s is estimated from the observed
drain rate: the controller timestamps recent ticket releases and
projects how long the current backlog needs to flush.  With no drain
history yet it falls back to the constructor's ``retry_after_s``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional


class QueueFull(Exception):
    """Admission queue at capacity; carries the Retry-After hint (s) and
    the tier whose queue overflowed (the server's status code and body
    depend on it: online -> 429 + Retry-After, offline -> 503 + tier)."""

    def __init__(self, retry_after: int = 1, tier: str = "online"):
        super().__init__(
            f"{tier} admission queue full; retry after {retry_after}s")
        self.retry_after = retry_after
        self.tier = tier


class Closed(Exception):
    """Controller draining/shut down; server maps it to HTTP 503."""


@dataclasses.dataclass
class Ticket:
    """One request's admission handle (created by ``submit``)."""

    seq: int                      # arrival order (monotonic)
    priority: int
    tenant: str
    tier: str = "online"
    dispatched: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    cancelled: bool = False
    released: bool = False


# releases sampled for the drain-rate Retry-After estimate; small and
# recent beats large and stale (load shifts minute to minute)
_DRAIN_WINDOW = 32


class AdmissionController:
    def __init__(self, max_queue: int = 64,
                 max_active: Optional[int] = None,
                 retry_after_s: int = 1,
                 max_queue_offline: int = 256,
                 clock: Optional[Callable[[], float]] = None):
        self.max_queue = max_queue
        self.max_active = max_active           # None = unbounded dispatch
        self.retry_after_s = retry_after_s     # hint before drain history
        self.max_queue_offline = max_queue_offline
        self._clock = clock or time.monotonic  # injectable for tests
        self._lock = threading.Lock()
        self._pending: List[Ticket] = []       # undispatched, arrival order
        self._inflight: Dict[str, int] = {}    # tenant -> dispatched count
        self._active = 0
        self._offline_live = 0                 # offline submitted-not-released
        self._seq = 0
        self._closed = False
        self._releases: Deque[float] = deque(maxlen=_DRAIN_WINDOW)
        self._releases_offline: Deque[float] = deque(maxlen=_DRAIN_WINDOW)
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_dispatched = 0
        self.n_admitted_offline = 0
        self.n_rejected_offline = 0

    # -- client side --------------------------------------------------------
    def submit(self, *, priority: int = 0, tenant: str = "anonymous",
               tier: str = "online") -> Ticket:
        """Take a ticket; raises :class:`QueueFull` when the tier's queue
        is at capacity, :class:`Closed` while draining.  Offline tickets
        dispatch immediately (their throttle is the engine's slack
        admission, not the online window) but are capped in total."""
        with self._lock:
            if self._closed:
                raise Closed()
            if tier == "offline":
                if self._offline_live >= self.max_queue_offline:
                    self.n_rejected_offline += 1
                    raise QueueFull(
                        self._drain_hint(self._releases_offline,
                                         self._offline_live),
                        tier="offline")
                t = Ticket(seq=self._seq, priority=priority,
                           tenant=tenant, tier="offline")
                self._seq += 1
                self._offline_live += 1
                self.n_admitted_offline += 1
                t.dispatched.set()
                return t
            if len(self._pending) >= self.max_queue:
                self.n_rejected += 1
                raise QueueFull(
                    self._drain_hint(self._releases, len(self._pending)))
            t = Ticket(seq=self._seq, priority=priority, tenant=tenant)
            self._seq += 1
            self._pending.append(t)
            self.n_admitted += 1
            self._pump()
        return t

    def wait(self, ticket: Ticket, timeout: Optional[float] = None) -> bool:
        """Block until the ticket is dispatched (True) or timeout."""
        return ticket.dispatched.wait(timeout)

    def release(self, ticket: Ticket):
        """Return the ticket's dispatch slot (request finished, aborted,
        or client gone); idempotent.  Cancels instead if undispatched."""
        with self._lock:
            if ticket.released:
                return
            ticket.released = True
            if ticket.tier == "offline":
                self._offline_live -= 1
                self._releases_offline.append(self._clock())
                return
            if not ticket.dispatched.is_set():
                ticket.cancelled = True
                try:
                    self._pending.remove(ticket)
                except ValueError:
                    pass
                return
            self._active -= 1
            self._releases.append(self._clock())
            n = self._inflight.get(ticket.tenant, 1) - 1
            if n:
                self._inflight[ticket.tenant] = n
            else:
                self._inflight.pop(ticket.tenant, None)
            self._pump()

    # -- dispatch ------------------------------------------------------------
    def _pump(self):
        """Dispatch pending tickets while the window has room (caller
        holds the lock).  Order: priority desc, least tenant in-flight,
        FIFO arrival — see the module docstring."""
        while self._pending and (self.max_active is None
                                 or self._active < self.max_active):
            best = min(self._pending,
                       key=lambda t: (-t.priority,
                                      self._inflight.get(t.tenant, 0),
                                      t.seq))
            self._pending.remove(best)
            self._active += 1
            self._inflight[best.tenant] = \
                self._inflight.get(best.tenant, 0) + 1
            self.n_dispatched += 1
            best.dispatched.set()

    def _drain_hint(self, releases: Deque[float], depth: int) -> int:
        """Retry-After (seconds) from the observed release rate: project
        how long ``depth + 1`` queued requests take to drain.  Falls back
        to ``retry_after_s`` before two releases exist (no rate yet) and
        clamps to [1, 60] — a hint, not a promise (caller holds the
        lock; reads only controller state)."""
        rel = list(releases)
        if len(rel) < 2:
            return max(1, int(self.retry_after_s))
        span = rel[-1] - rel[0]
        if span <= 0.0:
            return 1
        rate = (len(rel) - 1) / span           # releases / second
        return max(1, min(60, math.ceil((depth + 1) / rate)))

    # -- lifecycle / introspection -------------------------------------------
    def close(self):
        """Stop admitting; pending undispatched tickets are cancelled
        (their waiters see ``cancelled`` after a spurious dispatch)."""
        with self._lock:
            self._closed = True
            for t in self._pending:
                t.cancelled = True
                t.dispatched.set()     # wake waiters; they check cancelled
            self._pending.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "admission_pending": len(self._pending),
                "admission_active": self._active,
                "admission_admitted_total": self.n_admitted,
                "admission_rejected_total": self.n_rejected,
                "admission_dispatched_total": self.n_dispatched,
                "admission_offline_live": self._offline_live,
                "admission_offline_admitted_total": self.n_admitted_offline,
                "admission_offline_rejected_total": self.n_rejected_offline,
            }
