"""Sequence state + the worker-side SequenceCache (TSEM §5.2)."""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.sampling_params import SamplingParams


class SeqStatus(enum.Enum):
    WAITING = 0
    RUNNING = 1
    FINISHED = 2
    PREEMPTED = 3
    ABORTED = 4


@dataclasses.dataclass
class Sequence:
    seq_id: int
    prompt_ids: List[int]
    params: SamplingParams
    output_ids: List[int] = dataclasses.field(default_factory=list)
    status: SeqStatus = SeqStatus.WAITING
    arrival_t: float = 0.0
    first_sched_t: Optional[float] = None   # WAITING -> RUNNING transition
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None    # feeds live TPOT (adaptive policy)
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None     # "stop" | "length" | "abort"
    # chunked-prefill progress: prompt tokens whose KV is (or is being)
    # written into the cache.  Advanced by the scheduler at chunk-issue
    # time; the monolithic path sets it to the full prompt on admission.
    prefilled: int = 0
    # preemption-by-recompute (paged KV, docs/memory.md): a preempted
    # sequence loses its KV blocks and is re-admitted as a fresh prefill
    # of its FULL token history (prompt + outputs so far).  The target
    # records how many leading tokens that resume-prefill must cover;
    # None = an ordinary sequence, prefill covers the prompt only.
    prefill_target: Optional[int] = None
    preemptions: int = 0
    # parallel sampling (SamplingParams.n > 1, docs/memory.md): a fork
    # child shares its parent's prompt KV via refcounted block tables.
    # ``forked`` marks a child whose KV is already materialized (no
    # prefill compute needed — admission is bookkeeping only); it is
    # cleared on preemption/demotion, falling back to recompute.
    fork_parent: Optional[int] = None
    forked: bool = False
    forks_spawned: bool = False       # parent: children already created
    # prompt-prefix caching: leading tokens whose KV was mapped onto
    # cached blocks at admission (prefill may start past them).
    cached_prefix: int = 0

    @property
    def length(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def priority(self) -> int:
        """Scheduling priority (from SamplingParams): higher serves first,
        lower preempts first under KV block pressure."""
        return self.params.priority

    @property
    def tier(self) -> str:
        """Workload tier (docs/hybrid.md): "online" or "offline"."""
        return self.params.tier

    @property
    def is_online(self) -> bool:
        """False for best-effort offline-tier work: queued separately,
        admitted only into scheduler slack, preempted before any online
        sequence regardless of priority."""
        return self.params.tier != "offline"

    @property
    def prefill_len(self) -> int:
        """Tokens the prefill phase must cover before sampling resumes:
        the prompt, or — after a preemption — the full token history at
        eviction time (the last history token's logits produce the next
        output, exactly the decode step the eviction interrupted)."""
        if self.prefill_target is not None:
            return self.prefill_target
        return len(self.prompt_ids)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prefill_len

    def prefill_slice(self, off: int, n: int) -> List[int]:
        """Input ids for the prefill span [off, off+n) over the prefill
        token stream (prompt, extended by outputs after a preemption)."""
        if off + n <= len(self.prompt_ids):
            return list(self.prompt_ids[off:off + n])
        return list((self.prompt_ids + self.output_ids)[off:off + n])

    @property
    def last_token(self) -> int:
        return self.output_ids[-1] if self.output_ids else self.prompt_ids[-1]

    def mark_running(self, now: Optional[float] = None):
        """WAITING -> RUNNING (admission); records the queue-exit time the
        per-request queue-delay metric is computed from."""
        self.status = SeqStatus.RUNNING
        if self.first_sched_t is None:
            self.first_sched_t = time.monotonic() if now is None else now

    def append(self, token_id: int, now: float) -> bool:
        """Returns True when the sequence finishes."""
        self.output_ids.append(int(token_id))
        if self.first_token_t is None:
            self.first_token_t = now
        self.last_token_t = now
        if len(self.output_ids) >= self.params.max_new_tokens:
            done, reason = True, "length"
        elif (self.params.eos_token_id >= 0
                and token_id == self.params.eos_token_id):
            done, reason = True, "stop"
        else:
            done = False
        if done:
            self.status = SeqStatus.FINISHED
            self.finish_t = now
            self.finish_reason = self.finish_reason or reason
        return done


@dataclasses.dataclass
class CachedSeqState:
    """Worker-local cached metadata for a sequence (avoids re-shipping
    prompt/output ids every iteration — the paper's SequenceCache)."""

    seq_id: int
    prompt_len: int
    out_len: int
    cache_row: int            # contiguous layout: KV-cache row; paged: -1
    # paged layout: physical placement lives in the shared
    # BlockSpaceManager (read live at staging time — tables grow between
    # iterations); this handle only marks the sequence as admitted


class SequenceCache:
    """Maps seq_id -> cached state; assigns/releases KV placement.

    Two memory modes (``EngineConfig.kv_layout``, docs/memory.md):

      contiguous  each sequence owns one dense ``[max_seq_len]`` cache row
                  from a fixed pool — admission fails when rows run out.
      paged       placement is a block table in the shared
                  :class:`~repro_torch.runtime.paged_kv.BlockSpaceManager`
                  (``kv``); rows are not assigned, capacity is governed by
                  block-budget admission + preemption in the scheduler.
    """

    def __init__(self, max_rows: int, kv=None):
        self.max_rows = max_rows
        self.kv = kv                       # BlockSpaceManager in paged mode
        self._by_id: Dict[int, CachedSeqState] = {}
        self._free_rows = list(range(max_rows - 1, -1, -1))

    @property
    def paged(self) -> bool:
        return self.kv is not None

    def lookup(self, seq_id: int) -> Optional[CachedSeqState]:
        return self._by_id.get(seq_id)

    def admit(self, seq_id: int, prompt_len: int) -> CachedSeqState:
        st = self._by_id.get(seq_id)
        if st is None:
            if self.paged:
                # blocks were reserved by the scheduler's block-budget
                # admission; this only registers the worker-side handle
                st = CachedSeqState(seq_id, prompt_len, 0, -1)
            else:
                if not self._free_rows:
                    raise RuntimeError("KV cache rows exhausted")
                st = CachedSeqState(seq_id, prompt_len, 0,
                                    self._free_rows.pop())
            self._by_id[seq_id] = st
        return st

    def release(self, seq_id: int):
        st = self._by_id.pop(seq_id, None)
        if st is None:
            return
        if self.paged:
            self.kv.release(seq_id)        # idempotent (preempt frees first)
        else:
            self._free_rows.append(st.cache_row)

    def drop_entry(self, seq_id: int):
        """Forget the worker-side handle WITHOUT touching placement —
        preemption already freed the blocks scheduler-side, and the
        sequence keeps its id (and sampler state) for the resume."""
        self._by_id.pop(seq_id, None)

    def advance(self, seq_id: int):
        st = self._by_id.get(seq_id)
        if st is not None:     # may be gone: aborted/preempted mid-flight
            st.out_len += 1

    @property
    def free_rows(self) -> int:
        return len(self._free_rows)
