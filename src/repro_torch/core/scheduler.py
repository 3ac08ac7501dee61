"""Continuous-batching scheduler (SiPipe §4.2) with pluggable policies.

Keeps p microbatches in flight (one per pipeline stage).  On receiving
iteration n's sampling output it immediately dispatches iteration n+p with
the same sequence set minus finished ones plus admitted waiters — which is
exactly the stability property the column-wise sampler and the TSEM
BatchMetadata replicas rely on (batches n and n+p are near-identical).

The scheduler owns the durable state (sequences, waiting queue, slot
membership, completion bookkeeping); WHAT each iteration carries is
delegated to a :class:`repro_torch.core.policies.SchedulingPolicy`:

  monolithic     whole-prompt ``is_prefill`` batches + flat decodes (the
                 seed behavior; selected when ``token_budget`` is None).
  chunked        SARATHI-style chunked prefill (opt-in via
                 ``token_budget``): long prompts are split into
                 fixed-token-budget chunks piggybacked on the slot's
                 in-flight decode tokens.
  disaggregated  TD-Pipe-style temporal disaggregation: the pipeline
                 alternates prefill-only and decode-only phases under a
                 hysteresis threshold (opt-in via ``policy=``).

Span-policy contract (chunked + disaggregated):

  * each scheduled iteration emits per-seq *spans* ``(offset, n_tokens)``
    — a decode step is the degenerate span ``(length-1, 1)``;
  * sampling fires only for sequences whose span reaches the last prompt
    token (``needs_sample``) — earlier chunks produce no token;
  * total tokens per iteration never exceed ``token_budget`` (the budget
    is clamped to ``max_batch + 1`` so prefill always makes progress).

Chunk-carrying iterations are executed over a *packed ragged* layout —
the batch's valid span tokens concatenated into flat [T] vectors and
bucketed to a small set of power-of-two widths (``packed_layout()`` /
``packed_width``) — see docs/scheduling.md.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sequence import SeqStatus, Sequence


BUCKET_FLOOR = 8


def bucket_width(n_tokens: int) -> int:
    """Packed execution width for ``n_tokens`` valid span tokens: the
    smallest power of two >= n_tokens (floor 8).  Bucketing the ragged
    total to a small set of widths means XLA compiles one chunk step per
    (bucket, batch) pair instead of one per distinct token count."""
    b = BUCKET_FLOOR
    while b < n_tokens:
        b <<= 1
    return b


class SlackAccount:
    """Measured pipeline slack and the offline tokens sold into it
    (docs/hybrid.md).

    Every policy feeds this at schedule time: free decode seats left
    after online admission, the leftover token budget of a prefill
    phase, whole drain-tail iterations once online work runs out.  The
    counters are the engine's bubble accounting — how much slack the
    scheduler SAW (``seats_seen``) versus how much it actually SOLD to
    offline-tier sequences (``tokens_sold``)."""

    def __init__(self):
        self.seats_seen = 0      # free online seats observed at schedule time
        self.tokens_sold = 0     # span tokens issued to offline sequences
        self.offers = 0          # schedule calls that observed any slack

    def see(self, seats: int):
        if seats > 0:
            self.seats_seen += seats
            self.offers += 1

    def sell(self, tokens: int):
        if tokens > 0:
            self.tokens_sold += tokens


@dataclasses.dataclass
class SchedulingOutput:
    """Broadcast to every worker + sampler via BIC-I."""

    iteration: int
    slot: int                      # iteration %% p — the TSEM replica index
    seq_ids: List[int]
    # per-seq state the CPU executor needs to build model inputs
    positions: np.ndarray          # [B] span start (decode: next-token position)
    tokens: np.ndarray             # [B] first input token of each span
    is_prefill: bool               # True -> monolithic-prefill the batch first
    prompt_lens: Optional[List[int]] = None
    batch_recomposed: bool = False
    # ---- chunked-prefill extensions (None on pure monolithic/decode paths) --
    spans: Optional[List[Tuple[int, int]]] = None   # per-seq (offset, n_tokens)
    span_tokens: Optional[List[List[int]]] = None   # input ids for each span
    needs_sample: Optional[List[bool]] = None       # span reaches a sampling point
    # ---- paged KV layout (None under contiguous rows) -----------------------
    # [B, nb] int32 physical block table per batch row, padded with the
    # trash block — snapshotted at schedule time by the scheduler (the
    # placement this iteration's in-kernel gather / dirty-slot write-back
    # must see), staged verbatim by every stage's CPU executor.  ``nb`` is
    # a rung of the BlockSpaceManager's capped width ladder, so only a
    # handful of (batch, nb) stage-fn shapes ever compile (docs/memory.md)
    block_tables: Optional[np.ndarray] = None
    # [K, 2] int32 (src, dst) device-side block copies queued by CoW since
    # the previous schedule (fork tail-block copies, growth-time CoW of a
    # shared block).  Every stage applies them to its physical cache
    # BEFORE executing this iteration: per-stage FIFO puts the copy after
    # all in-flight writes to ``src`` (shared blocks are never written, so
    # src content is stable) and before any reader of ``dst``
    block_copies: Optional[np.ndarray] = None
    # per-seq preemption generation at schedule time: ``complete`` drops a
    # sampled token whose sequence was preempted (and possibly already
    # re-admitted) after this iteration was scheduled — the resumed
    # prefill recomputes that token itself, and accepting the stale one
    # would duplicate it
    epochs: Optional[List[int]] = None

    @property
    def max_span(self) -> int:
        """Widest span in the batch; 1 for pure-decode iterations."""
        if not self.spans:
            return 1
        return max(c for _, c in self.spans)

    @property
    def total_tokens(self) -> int:
        if not self.spans:
            return len(self.seq_ids)
        return sum(c for _, c in self.spans)

    @property
    def packed_width(self) -> int:
        """Execution width of the packed ragged token layout: 1 for pure
        decode (the flat [B] fast path), else the power-of-two bucket that
        ``total_tokens`` rounds up to (see :func:`bucket_width`)."""
        if self.max_span == 1:
            return 1
        return bucket_width(self.total_tokens)

    def packed_layout(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """The packed [T] token layout (T = total_tokens, unpadded).

        Returns ``(tokens, positions, seq_idx, last_index)`` int32 arrays:
        every valid span token exactly once, batch columns concatenated in
        order, positions monotone within each column; ``last_index[i]`` is
        the packed index of column i's final (sampling) token.
        """
        toks: List[int] = []
        pos: List[int] = []
        seq: List[int] = []
        last = np.zeros(len(self.seq_ids), np.int32)
        for i, ((off, n), ids) in enumerate(zip(self.spans, self.span_tokens)):
            toks.extend(ids)
            pos.extend(range(off, off + n))
            seq.extend([i] * n)
            last[i] = len(toks) - 1
        return (np.asarray(toks, np.int32), np.asarray(pos, np.int32),
                np.asarray(seq, np.int32), last)

    def sample_indices(self) -> List[int]:
        """Batch columns whose logits must be sampled this iteration."""
        if self.needs_sample is None:
            return list(range(len(self.seq_ids)))
        return [i for i, ns in enumerate(self.needs_sample) if ns]


class Scheduler:
    def __init__(self, *, max_batch: int, pp_degree: int = 1,
                 max_seq_len: int = 4096,
                 token_budget: Optional[int] = None,
                 policy: Optional[str] = None,
                 hysteresis_tokens: Optional[int] = None,
                 tpot_slo_s: Optional[float] = None,
                 decode_enlarge_factor: int = 1,
                 keep_finished: int = 1024,
                 kv_manager=None,
                 seq_id_fn=None):
        from repro_torch.core.policies import make_policy

        self.max_batch = max_batch
        self.p = pp_degree
        self.max_seq_len = max_seq_len
        # span policies need a budget; decode members take 1 token each,
        # so budget > max_batch guarantees prefill progress
        self.token_budget = (max(token_budget, max_batch + 1)
                             if token_budget is not None else None)
        self.policy = make_policy(policy, token_budget=self.token_budget,
                                  hysteresis_tokens=hysteresis_tokens,
                                  tpot_slo_s=tpot_slo_s,
                                  decode_enlarge_factor=decode_enlarge_factor)
        # paged KV layout (docs/memory.md): admission switches from seat
        # counting to block-budget accounting against this
        # BlockSpaceManager, and decode growth under memory pressure
        # preempts the lowest-priority running sequence (None = the
        # contiguous row layout, no block accounting)
        self.kv = kv_manager
        self.n_preemptions = 0
        # parallel sampling (SamplingParams.n > 1): fresh seq ids for fork
        # children come from the engine's RequestIdAllocator so they can
        # never collide with future requests; the fallback counter only
        # serves schedulers constructed without an engine (unit tests)
        self._seq_id_fn = seq_id_fn
        self._fallback_id = 1 << 20
        self.n_forks = 0
        self.n_fork_demotions = 0
        self._spawned_forks: List[Sequence] = []  # for the engine to adopt
        self._preempted_pending: List[int] = []   # for the engine to reap
        self._preempt_hold: set = set()   # no re-admission within the call
        self.waiting: Deque[Sequence] = deque()
        # hybrid serving (docs/hybrid.md): offline-tier requests queue
        # separately so every online code path — admission loops, the
        # disaggregated phase machine, block-budget gates — sees state
        # IDENTICAL to an online-only run.  Policies admit from this
        # queue only into measured slack, accounted here.
        self.waiting_offline: Deque[Sequence] = deque()
        self.slack = SlackAccount()
        self.n_offline_preemptions = 0
        self.seqs: Dict[int, Sequence] = {}
        self.slot_members: List[List[int]] = [[] for _ in range(pp_degree)]
        self.iteration = 0
        # long-run memory bound: FINISHED/ABORTED sequences are released
        # from ``seqs`` once their slot membership clears; only a capped
        # window of recently finished sequences is retained here
        self.finished: Deque[Sequence] = deque(maxlen=keep_finished)
        self._retired: set = set()       # finished/aborted, pending release
        # live inter-token gaps across all sequences (seconds); feeds the
        # adaptive token-budget policy
        self.tpot_samples: Deque[float] = deque(maxlen=128)
        # serializes status transitions between complete() (runs on the
        # engine's device thread) and abort() (caller thread): without it
        # an abort landing between complete's RUNNING check and
        # Sequence.append could be overwritten to FINISHED
        self._mutex = threading.Lock()

    @property
    def chunked(self) -> bool:
        """True when the active policy emits spans (packed-[T] execution)."""
        return self.policy.uses_spans

    # -- request ingestion --------------------------------------------------
    def add_request(self, seq: Sequence):
        if len(seq.prompt_ids) >= self.max_seq_len:
            # fail loudly up front: the chunked path would otherwise issue
            # chunks past the KV cache and silently produce garbage
            raise ValueError(
                f"prompt of {len(seq.prompt_ids)} tokens does not fit "
                f"max_seq_len={self.max_seq_len} (need >= 1 output slot)")
        seq.arrival_t = seq.arrival_t or time.monotonic()
        self.seqs[seq.seq_id] = seq
        self._enqueue_waiting(seq)

    def _queue_for(self, seq: Sequence) -> Deque[Sequence]:
        """The waiting queue a sequence belongs to (by tier)."""
        return self.waiting if seq.is_online else self.waiting_offline

    def _enqueue_waiting(self, seq: Sequence):
        """Insert a NEW request into its tier's waiting queue in admission
        order: priority first, FIFO within a priority (monotonic ids =
        arrival order).  Resume entries at the queue FRONT — PREEMPTED
        sequences awaiting re-admission and spawned fork children — are
        never jumped: they already hold tokens/blocks and resume first
        regardless of a newcomer's priority (docs/http.md)."""
        w = self._queue_for(seq)
        if not w or w[-1].priority >= seq.priority:
            w.append(seq)                      # fast path: uniform priority
            return
        i = 0
        while i < len(w) and (w[i].status == SeqStatus.PREEMPTED
                              or w[i].forked):
            i += 1
        while i < len(w) and w[i].priority >= seq.priority:
            i += 1
        w.insert(i, seq)

    def admit_next(self) -> Sequence:
        """Pop the waiting-queue head and admit it: WAITING -> RUNNING plus
        paged block reservation.  Policies call this inside their admission
        loops (gated on :meth:`can_admit_next`), so every policy shares one
        admission order — priority, then FIFO (the queue's insertion
        order); per-tenant fair share is enforced a layer up, by
        ``serving.admission`` (docs/http.md)."""
        seq = self.waiting.popleft()
        seq.mark_running()
        self.kv_admit(seq)
        return seq

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.waiting_offline)
                or any(self.slot_members))

    # -- paged-KV admission / growth / preemption ----------------------------
    def can_admit_next(self) -> bool:
        """Block-budget admission gate for the ONLINE waiting-queue head
        (FIFO: a head that does not fit blocks the queue rather than
        being skipped).  Always True under the contiguous layout.

        Offline-tier sequences never stand between online traffic and
        the block pool: when the head does not fit, RUNNING offline
        sequences are preempted-by-recompute (cheapest relief first:
        their released blocks — including any cached blocks they pinned —
        return to the pool at once) until the head fits or no offline
        victim remains.  An online-only run has no offline victims, so
        its admission decisions are untouched."""
        if self.kv is None or not self.waiting:
            return True
        head = self.waiting[0]
        if head.seq_id in self._preempt_hold:
            return False       # never re-admit within the evicting call
        if head.forked and self.kv.has(head.seq_id):
            return True        # fork child: blocks materialized at spawn
        token_ids = head.prompt_ids + head.output_ids
        while not self.kv.can_admit(head.length, token_ids=token_ids,
                                    evict_cached=False):
            if self._demote_waiting_fork(offline_only=True):
                continue
            victim = self._preemption_victim(offline_only=True)
            if victim is None:
                # the offline tier holds nothing: the free list equals
                # the online-only baseline, so the ordinary gate (which
                # may reclaim cached prefix blocks at admit time) makes
                # exactly the decision an online-only run would make
                return self.kv.can_admit(head.length, token_ids=token_ids)
            self._preempt(victim)
        return True

    def can_admit_next_offline(self) -> bool:
        """Block-budget gate for the OFFLINE queue head.  Unlike the
        online gate this never reclaims anything — offline work is
        admitted only into blocks that are genuinely free right now
        (``evict_cached=False``, no prefix matching), so admitting it
        cannot disturb the prefix cache or any online sequence."""
        if not self.waiting_offline:
            return False
        head = self.waiting_offline[0]
        if head.seq_id in self._preempt_hold:
            return False
        if self.kv is None:
            return True
        if head.forked and self.kv.has(head.seq_id):
            return True
        return self.kv.can_admit(head.length, token_ids=None,
                                 evict_cached=False)

    def admit_next_offline(self) -> Sequence:
        """Pop and admit the offline-queue head (policies call this only
        after online admission has taken everything it can use)."""
        seq = self.waiting_offline.popleft()
        seq.mark_running()
        self.kv_admit(seq)
        return seq

    def kv_admit(self, seq: Sequence):
        """Reserve KV blocks for an admitted sequence (covers its full
        prefill target — prompt, or post-preemption token history).

        Prefix caching (docs/memory.md): the manager maps the sequence's
        leading full blocks onto cached physical blocks when their token
        hashes match — those tokens need no prefill compute, so
        ``prefilled`` starts past them and span policies chunk only the
        unshared tail.  A fork child whose blocks were materialized at
        spawn skips block reservation entirely (its prompt KV already
        lives in the shared blocks)."""
        if self.kv is None:
            return
        if seq.forked and self.kv.has(seq.seq_id):
            seq.prefilled = seq.prefill_len
            return
        # offline sequences bypass the prefix index entirely (no matches,
        # no registrations): sharing or evicting cached blocks on behalf
        # of best-effort work would perturb the online trace
        token_ids = (seq.prompt_ids + seq.output_ids) if seq.is_online \
            else None
        cached = self.kv.admit(seq.seq_id, seq.length, token_ids=token_ids)
        seq.cached_prefix = cached
        if cached > seq.prefilled:
            seq.prefilled = cached

    def _preemption_victim(self, offline_only: bool = False) -> Optional[int]:
        """Preemption victim: the lowest-priority RUNNING sequence that
        still holds blocks; latest arrival breaks priority ties (monotonic
        ids make arrival order = id order, so ``-sid`` prefers the newest).
        Offline-tier sequences are ALWAYS chosen before any online one,
        regardless of priority (docs/hybrid.md).  ``offline_only``
        restricts candidates to the offline tier — used when the
        beneficiary is itself offline (growth) or when reclaiming slack
        for online admission, so those paths can never touch online
        state.  Candidates are sorted first so the choice is a pure
        function of the candidate set — never of ``seqs`` dict insertion
        order."""
        cands = sorted(sid for sid, q in self.seqs.items()
                       if q.status == SeqStatus.RUNNING and self.kv.has(sid)
                       and not (offline_only and q.is_online))
        if not cands:
            return None
        return min(cands, key=lambda sid: (self.seqs[sid].is_online,
                                           self.seqs[sid].priority, -sid))

    def _preempt(self, victim: int):
        """Evict a RUNNING sequence under memory pressure: free its blocks,
        mark it PREEMPTED and push it to the FRONT of the waiting queue so
        it is re-admitted (as a fresh prefill of its full token history) as
        soon as blocks free up.  In-flight iterations still referencing it
        execute harmlessly — their sampled tokens are discarded by
        ``complete`` (status != RUNNING) and recomputed bit-exactly after
        the resume under greedy sampling."""
        seq = self.seqs[victim]
        seq.status = SeqStatus.PREEMPTED
        seq.prefilled = 0
        seq.prefill_target = seq.length
        seq.preemptions += 1
        # losing the blocks voids any shared placement: the resume is a
        # plain recompute (re-admission may still prefix-cache-hit)
        seq.forked = False
        seq.cached_prefix = 0
        if self.kv is not None:     # seat-only mode has no blocks to free
            self.kv.release(victim)
        for m in self.slot_members:
            if victim in m:
                m.remove(victim)
        self._queue_for(seq).appendleft(seq)
        self._preempted_pending.append(victim)
        self._preempt_hold.add(victim)
        self.n_preemptions += 1
        if not seq.is_online:
            self.n_offline_preemptions += 1

    def preempt_offline_seat(self, members: List[int]) -> bool:
        """Free one SEAT for online admission: preempt the lowest-priority
        (then newest) RUNNING offline member of ``members`` (the list is
        mutated in place).  Works in both seat-only mode (no KV manager,
        e.g. pp_sim) and paged mode; returns False when no offline member
        remains — online admission then proceeds exactly as it would in
        an online-only run."""
        offline = [sid for sid in members
                   if self.seqs[sid].status == SeqStatus.RUNNING
                   and not self.seqs[sid].is_online]
        if not offline:
            return False
        victim = min(offline,
                     key=lambda sid: (self.seqs[sid].priority, -sid))
        self._preempt(victim)
        if victim in members:
            members.remove(victim)
        return True

    def _ensure_block_capacity(self, slot: int):
        """Pre-schedule growth reservation: every RUNNING member of the
        slot about to be scheduled gets blocks covering its current length
        (a decode span writes KV at position ``length - 1``).  When the
        free list cannot cover a growth, the lowest-priority RUNNING
        sequence is preempted and the growth retried; the grower preempts
        itself when it IS the lowest priority."""
        members = sorted(sid for sid in self.slot_members[slot]
                         if self.seqs[sid].status == SeqStatus.RUNNING)
        for sid in members:
            seq = self.seqs[sid]
            if seq.status != SeqStatus.RUNNING:
                continue       # evicted as a victim earlier in this loop
            if seq.is_online:
                # Baseline-equivalent growth (docs/hybrid.md): while any
                # offline work still holds blocks, grow from genuinely
                # free blocks only, reclaiming offline holdings (waiting
                # offline fork CoW tails, then RUNNING offline members)
                # when short.  Only once the offline tier holds nothing —
                # i.e. the free list equals what an online-only run would
                # see — fall through to the ordinary relief chain (evict
                # cached prefix blocks, demote online forks, preempt
                # online victims), so hybrid traffic can never change
                # WHICH cached blocks or online sequences get evicted.
                while not self.kv.ensure(sid, seq.length,
                                         evict_cached=False):
                    if self._demote_waiting_fork(offline_only=True):
                        continue
                    victim = self._preemption_victim(offline_only=True)
                    if victim is None:
                        break
                    self._preempt(victim)
                else:
                    continue   # strict growth succeeded
                while not self.kv.ensure(sid, seq.length):
                    # cheapest relief first: demote a not-yet-admitted
                    # fork child back to recompute (frees its CoW tail
                    # block and drops shared refs) before evicting a
                    # RUNNING sequence
                    if self._demote_waiting_fork():
                        continue
                    victim = self._preemption_victim()
                    if victim is None:
                        break
                    self._preempt(victim)
                    if victim == sid:
                        break
            else:
                # offline grower: relief strictly within its own tier —
                # never evict cached prefix blocks, demote online forks,
                # or preempt online sequences for best-effort growth
                # (self-preemption when it is the only offline holder)
                while not self.kv.ensure(sid, seq.length,
                                         evict_cached=False):
                    if self._demote_waiting_fork(offline_only=True):
                        continue
                    victim = self._preemption_victim(offline_only=True)
                    if victim is None:
                        break
                    self._preempt(victim)
                    if victim == sid:
                        break

    def _demote_fork(self, seq: Sequence):
        """Un-fork a child: release its (mostly shared) block table and
        fall back to the preemption-style recompute path — on admission it
        prefills its full history (prompt + first token) from scratch,
        bit-exact under greedy.  Keeps its queue position."""
        if self.kv is not None:
            self.kv.release(seq.seq_id)
        seq.forked = False
        seq.cached_prefix = 0
        seq.prefilled = 0
        seq.prefill_target = seq.length
        self.n_fork_demotions += 1

    def _demote_waiting_fork(self, offline_only: bool = False) -> bool:
        """Demote the most recently spawned WAITING fork child, if any.
        Offline forks go first (their CoW tails are offline holdings —
        reclaiming them can never perturb the online trace); with
        ``offline_only`` the online queue is not touched at all."""
        for seq in reversed(self.waiting_offline):
            if seq.forked and seq.status == SeqStatus.WAITING:
                self._demote_fork(seq)
                return True
        if offline_only:
            return False
        for seq in reversed(self.waiting):
            if seq.forked and seq.status == SeqStatus.WAITING:
                self._demote_fork(seq)
                return True
        return False

    def drain_preempted(self) -> List[int]:
        """Hand the engine the sequences preempted since the last drain
        (it drops their worker-side handles; blocks are already free)."""
        out, self._preempted_pending = self._preempted_pending, []
        return out

    # -- parallel sampling (SamplingParams.n > 1) ----------------------------
    def _spawn_forks(self, parent: Sequence, tok: int, now: float):
        """Materialize ``n - 1`` CoW fork children off the parent's prompt
        KV (called under ``_mutex`` from ``complete`` when the parent's
        first token lands).  Each child adopts the parent's block table by
        refcount (``kv.fork``) and immediately CoWs its tail block
        (``kv.ensure`` — the child's first decode writes slot
        ``prompt_len``, which lives in a shared block): after spawn no
        decode ever writes a block another sequence reads.  When even the
        one CoW block cannot be found, the child is demoted to
        resume-by-recompute instead of failing.  Children enter the FRONT
        of the waiting queue; a child whose single sampled token already
        finishes it (``max_new_tokens == 1`` or instant EOS) never touches
        the allocator at all."""
        parent.forks_spawned = True
        for _ in range(parent.params.n - 1):
            if self._seq_id_fn is not None:
                cid = self._seq_id_fn()
            else:
                self._fallback_id = max(self._fallback_id,
                                        max(self.seqs, default=0) + 1)
                cid = self._fallback_id
                self._fallback_id += 1
            child = Sequence(seq_id=cid,
                             prompt_ids=list(parent.prompt_ids),
                             params=parent.params,
                             arrival_t=parent.arrival_t,
                             fork_parent=parent.seq_id)
            child.first_sched_t = parent.first_sched_t
            self.n_forks += 1
            if child.append(tok, now):       # finished on its first token
                self.finished.append(child)
                self._spawned_forks.append(child)
                continue
            child.prefilled = parent.prompt_len
            if self.kv is not None and self.kv.fork(parent.seq_id, cid):
                child.forked = True
                child.cached_prefix = parent.prompt_len
                # an offline child's CoW tail may not evict cached prefix
                # blocks (best-effort work must not perturb online state)
                if not self.kv.ensure(cid, child.length,
                                      evict_cached=parent.is_online):
                    self._demote_fork(child)
            else:
                # contiguous layout / parent blocks already gone: full
                # recompute of the (prompt + first token) history
                child.prefilled = 0
                child.prefill_target = child.length
            self.seqs[cid] = child
            self._queue_for(child).appendleft(child)
            self._spawned_forks.append(child)

    def drain_spawned_forks(self) -> List[Sequence]:
        """Hand the engine the fork children spawned since the last drain
        (it attaches them to the parent's Request for per-fork streams)."""
        with self._mutex:
            out, self._spawned_forks = self._spawned_forks, []
            return out

    def fork_children_of(self, parent_id: int) -> List[Sequence]:
        """Live fork children of ``parent_id`` known to the scheduler —
        including ones spawned by ``complete`` that the engine has not yet
        attached to the parent Request.  ``engine.abort`` folds these into
        its target set so a request aborted inside the spawn→attach window
        cannot leave orphaned children decoding against freed parents."""
        with self._mutex:
            return [q for q in self.seqs.values()
                    if q.fork_parent == parent_id
                    and q.status in (SeqStatus.WAITING, SeqStatus.RUNNING,
                                     SeqStatus.PREEMPTED)]

    # -- iteration dispatch ---------------------------------------------------
    def schedule(self, iteration: Optional[int] = None) -> Optional[SchedulingOutput]:
        """Build the scheduling output for the next iteration of slot
        ``iteration %% p``, delegating admission + span construction to the
        active :class:`~repro_torch.core.policies.SchedulingPolicy`."""
        it = self.iteration if iteration is None else iteration
        if self.kv is not None:
            self._preempt_hold.clear()
            with self._mutex:      # vs complete() appending on device threads
                if self.kv.prefix_enabled:
                    # publish full prompt blocks whose KV writes were
                    # issued in STRICTLY EARLIER iterations into the
                    # prefix index: per-stage FIFO means those writes
                    # execute on every stage before any iteration
                    # scheduled from here on can read the shared blocks
                    # offline sequences never feed the prefix index: a
                    # cache entry that exists only because best-effort
                    # work ran would change online hit patterns
                    for sid, q in self.seqs.items():
                        if (q.status == SeqStatus.RUNNING and not q.forked
                                and q.is_online):
                            self.kv.register_prefix(
                                sid, q.prompt_ids,
                                min(q.prefilled, q.prompt_len))
                self._ensure_block_capacity(it % self.p)
        out = self.policy.schedule(self, it)
        if out is not None:
            self.iteration = max(self.iteration, it + 1)
            if self.kv is not None:
                # snapshot the batch's physical placement NOW: the padded
                # block tables every stage's CPU executor stages verbatim
                # (tables only grow between iterations; growth for THIS
                # iteration's members was ensured above) — plus each
                # member's preemption generation, so completions of
                # iterations scheduled before an eviction are dropped
                out.block_tables = self.kv.padded_tables(out.seq_ids)
                out.block_copies = self.kv.drain_copies()
                out.epochs = [self.seqs[sid].preemptions
                              for sid in out.seq_ids]
        self._purge_retired()
        return out

    def _purge_retired(self):
        """Release FINISHED/ABORTED sequences whose slot membership has
        cleared (the slot's own next ``schedule`` filters them out, which
        only happens after every in-flight iteration referencing them has
        completed — so nothing downstream can still need ``seqs[sid]``)."""
        if not self._retired:
            return
        live = set()
        for m in self.slot_members:
            live.update(m)
        for sid in [s for s in self._retired if s not in live]:
            self.seqs.pop(sid, None)
            self._retired.discard(sid)

    # -- request cancellation ------------------------------------------------
    def abort(self, seq_id: int) -> Optional[Sequence]:
        """Mark a sequence ABORTED; returns it (or None if unknown/done).

        A WAITING sequence is removed from the queue and released at
        once; a RUNNING one keeps its scheduler record until its slot's
        next ``schedule`` call drops it from membership (in-flight
        iterations may still reference it) — worker-side resources (KV
        row, sampler columns) are the engine's to reclaim."""
        with self._mutex:
            seq = self.seqs.get(seq_id)
            if seq is None or seq.status in (SeqStatus.FINISHED,
                                             SeqStatus.ABORTED):
                return None
            now = time.monotonic()
            # PREEMPTED sequences sit in the waiting queue awaiting resume
            # — an abort must pull them out before a policy re-admits them
            queued = seq.status in (SeqStatus.WAITING, SeqStatus.PREEMPTED)
            seq.status = SeqStatus.ABORTED
            seq.finish_t = now
            seq.finish_reason = "abort"
            if queued:
                try:
                    self._queue_for(seq).remove(seq)
                except ValueError:
                    pass
                self.seqs.pop(seq_id, None)
                if self.kv is not None:
                    self.kv.release(seq_id)
            else:
                self._retired.add(seq_id)
            return seq

    # -- sampling-output ingestion ----------------------------------------
    def complete(self, iteration: int, seq_ids: List[int],
                 token_ids: np.ndarray,
                 epochs: Optional[List[int]] = None) -> List[int]:
        """Append sampled tokens; returns finished seq ids.

        ``epochs`` (paged layout) is each sequence's preemption
        generation at the time this iteration was SCHEDULED: a token from
        an iteration that predates the sequence's eviction is dropped
        even if the sequence has already been re-admitted — the resumed
        prefill recomputes that very token (bit-exact under greedy), so
        accepting the stale one would duplicate it."""
        now = time.monotonic()
        done = []
        epochs = epochs if epochs is not None else [None] * len(seq_ids)
        with self._mutex:
            for sid, tok, epoch in zip(seq_ids, token_ids, epochs):
                seq = self.seqs.get(sid)
                if seq is None or seq.status != SeqStatus.RUNNING:
                    continue   # finished/aborted while this batch was in flight
                if epoch is not None and seq.preemptions != epoch:
                    continue   # scheduled before an eviction: stale token
                if seq.last_token_t is not None and seq.is_online:
                    # TPOT-SLO feedback (adaptive budget, disaggregated
                    # phase cap) tracks ONLINE latency only — offline
                    # tokens steering it would alter online decisions
                    self.tpot_samples.append(now - seq.last_token_t)
                finished_now = (seq.append(int(tok), now)
                                or seq.length >= self.max_seq_len)
                # parallel sampling: the parent's FIRST token is the
                # moment every stage provably holds its full prompt KV
                # (the token only exists because the prefill traversed
                # the whole pipeline) — fork the n-1 children here,
                # BEFORE any finish-time block release below
                if (seq.params.n > 1 and not seq.forks_spawned
                        and seq.fork_parent is None):
                    self._spawn_forks(seq, int(tok), now)
                if finished_now:
                    seq.status = SeqStatus.FINISHED
                    seq.finish_t = seq.finish_t or now
                    seq.finish_reason = seq.finish_reason or "length"
                    self.finished.append(seq)
                    self._retired.add(sid)
                    if self.kv is not None:
                        # block-budget accounting: a finished sequence's
                        # blocks return to the pool at once (the engine's
                        # own release is idempotent with this)
                        self.kv.release(sid)
                    done.append(sid)
        return done
