"""The continuous-serving request layer over :class:`~repro_torch.core.sequence.
Sequence`.

The engine's public surface speaks *requests*, not sequences: a request
is admitted with its own :class:`SamplingParams`, carries a monotonic id
from :class:`RequestIdAllocator` (ids never collide even after the
scheduler releases finished sequence state), moves through the

    QUEUED -> RUNNING -> FINISHED | ABORTED

lifecycle, and streams :class:`RequestOutput` increments from
``engine.step()`` / ``engine.generate()``.  The underlying ``Sequence``
remains the unit the scheduler, KV cache and sampler operate on; the
request's *primary* sequence shares its id (``request_id == seq_id``),
and parallel sampling (``SamplingParams.n > 1``) attaches ``n - 1``
CoW-forked sibling sequences whose streams ride along as
:class:`ForkOutput` entries on every increment (docs/memory.md "Prefix
caching & CoW forks").
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections.abc import Sequence as SequenceABC
from typing import List, Optional, Union

from repro_torch.core.sequence import SeqStatus, Sequence


class TokenStream(SequenceABC):
    """Zero-copy snapshot of the first ``n`` tokens of a request's growable
    output list.

    Streaming used to hand every :class:`RequestOutput` a fresh cumulative
    list — an O(len) slice per increment, quadratic per request end to
    end.  A ``TokenStream`` shares the request's backing ``output_ids``
    list instead (O(1) to construct); the bound ``n`` freezes the view at
    emit time, so tokens appended later never leak into an older output.
    It behaves like a read-only list (len / index / slice / iterate /
    ``==`` against lists and tuples); call :meth:`to_list` for a real copy.
    """

    __slots__ = ("_backing", "_n")

    def __init__(self, backing: List[int], n: int):
        self._backing = backing
        self._n = n

    @property
    def backing(self) -> List[int]:
        return self._backing

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: Union[int, slice]):
        if isinstance(i, slice):
            return self._backing[:self._n][i]
        if i < -self._n or i >= self._n:
            raise IndexError(i)
        return self._backing[i if i >= 0 else self._n + i]

    def __iter__(self):
        return iter(self._backing[:self._n])

    def to_list(self) -> List[int]:
        return self._backing[:self._n]

    def __add__(self, other) -> List[int]:
        return self.to_list() + list(other)

    def __radd__(self, other) -> List[int]:
        return list(other) + self.to_list()

    def __eq__(self, other) -> bool:
        if isinstance(other, TokenStream):
            other = other.to_list()
        if isinstance(other, tuple):
            other = list(other)
        return self.to_list() == other

    def __repr__(self) -> str:
        return f"TokenStream({self.to_list()!r})"


class RequestState(enum.Enum):
    QUEUED = 0      # admitted to the waiting queue, not yet scheduled
    RUNNING = 1     # scheduled at least once (prefilling or decoding)
    FINISHED = 2    # completed normally ("stop" / "length")
    ABORTED = 3     # cancelled via engine.abort(); resources reclaimed
    PREEMPTED = 4   # evicted under KV memory pressure (paged layout);
    #                 queued for resume-by-recompute, tokens so far retained

    @staticmethod
    def of(seq: Sequence) -> "RequestState":
        return {
            SeqStatus.WAITING: RequestState.QUEUED,
            SeqStatus.RUNNING: RequestState.RUNNING,
            SeqStatus.FINISHED: RequestState.FINISHED,
            SeqStatus.ABORTED: RequestState.ABORTED,
            SeqStatus.PREEMPTED: RequestState.PREEMPTED,
        }.get(seq.status, RequestState.RUNNING)


class RequestIdAllocator:
    """Monotonic request/sequence ids.  Never reuses an id, so releasing
    finished sequences from ``Scheduler.seqs`` (long-run memory bound)
    cannot cause a later request to collide with live worker-side state
    (KV rows, sampler penalty columns, TSEM metadata are all keyed by
    sequence id)."""

    def __init__(self, start: int = 0):
        self._counter = itertools.count(start)

    def next(self) -> int:
        return next(self._counter)


@dataclasses.dataclass
class RequestMetrics:
    """Per-request latency accounting (all times in seconds)."""

    request_id: int
    prompt_tokens: int
    output_tokens: int
    queue_s: Optional[float]    # arrival -> first scheduled
    ttft_s: Optional[float]     # arrival -> first output token
    tpot_s: Optional[float]     # mean inter-token time after the first
    e2e_s: Optional[float]      # arrival -> finish
    finish_reason: Optional[str]
    state: RequestState
    tier: str = "online"        # workload tier (docs/hybrid.md): online
    #                             latency percentiles exclude offline rows

    @staticmethod
    def of(seq: Sequence) -> "RequestMetrics":
        n = len(seq.output_ids)
        ttft = (seq.first_token_t - seq.arrival_t
                if seq.first_token_t is not None else None)
        queue = (seq.first_sched_t - seq.arrival_t
                 if seq.first_sched_t is not None else None)
        tpot = None
        if seq.first_token_t is not None and seq.last_token_t is not None \
                and n > 1:
            tpot = (seq.last_token_t - seq.first_token_t) / (n - 1)
        e2e = (seq.finish_t - seq.arrival_t
               if seq.finish_t is not None else None)
        return RequestMetrics(
            request_id=seq.seq_id, prompt_tokens=seq.prompt_len,
            output_tokens=n, queue_s=queue, ttft_s=ttft, tpot_s=tpot,
            e2e_s=e2e, finish_reason=seq.finish_reason,
            state=RequestState.of(seq), tier=seq.params.tier)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["state"] = self.state.name
        return d


@dataclasses.dataclass
class Request:
    """Engine-side bookkeeping for one in-flight request."""

    request_id: int
    seq: Sequence
    streamed: int = 0       # output tokens already emitted via RequestOutput
    # parallel sampling: the n-1 fork children (scheduler-spawned when the
    # primary's first token lands) and their per-fork streamed watermarks
    forks: List[Sequence] = dataclasses.field(default_factory=list)
    fork_streamed: List[int] = dataclasses.field(default_factory=list)

    @property
    def state(self) -> RequestState:
        return RequestState.of(self.seq)

    @property
    def priority(self) -> int:
        """Scheduling priority (from SamplingParams, docs/http.md)."""
        return self.seq.params.priority

    @property
    def all_seqs(self) -> List[Sequence]:
        return [self.seq] + self.forks


@dataclasses.dataclass
class RequestOutput:
    """One streaming increment for a request, returned by ``engine.step()``.

    ``new_token_ids`` are the tokens generated since the previous output
    for this request (the delta — the only per-emit copy); ``token_ids``
    is the cumulative output so far as a zero-copy :class:`TokenStream`
    view over the request's growable output list (list-like; call
    ``.to_list()`` for an owned copy).  The final increment has
    ``finished=True`` and carries the request's latency metrics; after
    it, the engine holds no per-request state (the ``seq`` handle stays
    valid for the caller)."""

    request_id: int
    new_token_ids: List[int]
    token_ids: Union[List[int], "TokenStream"]
    finished: bool
    state: RequestState
    finish_reason: Optional[str] = None
    metrics: Optional[RequestMetrics] = None
    seq: Optional[Sequence] = None      # underlying sequence (offline compat)
    # parallel sampling (SamplingParams.n > 1): one entry per fork child,
    # in spawn order — index 0 is the SECOND completion (the primary
    # sequence's stream stays in the top-level fields, so n == 1 callers
    # see no change).  ``finished`` above flips only when the primary AND
    # every fork are done.
    forks: Optional[List["ForkOutput"]] = None


@dataclasses.dataclass
class ForkOutput:
    """One fork child's slice of a :class:`RequestOutput` increment."""

    index: int                          # 1-based completion index
    new_token_ids: List[int]
    token_ids: Union[List[int], "TokenStream"]
    finished: bool
    finish_reason: Optional[str] = None
    seq: Optional[Sequence] = None
