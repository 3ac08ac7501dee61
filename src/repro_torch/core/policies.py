"""Pluggable scheduling policies behind the SchedulingOutput span interface.

The continuous-batching scheduler (repro_torch.core.scheduler) owns the durable
state — sequences, the waiting queue, per-slot membership — and delegates
each iteration's admission + span construction to a ``SchedulingPolicy``:

  monolithic     whole-prompt prefills dispatched as pipeline-blocking
                 ``is_prefill`` batches (the seed behavior; the engine's
                 ``_admit_and_prefill`` runs them through every stage).
  chunked        SARATHI-style chunked prefill: decode members always carry
                 their 1 token, the remaining per-iteration token budget is
                 handed to prefilling members as prompt chunks.
  disaggregated  TD-Pipe-style temporal disaggregation: the pipeline
                 alternates *prefill phases* (iterations carry only prompt
                 chunks at the full token budget, zero decode piggybacking;
                 admission happens here) and *decode phases* (pure 1-token
                 iterations that keep the TSEM incremental n/n+p fast path),
                 switched by a hysteresis threshold on pending-prefill
                 tokens vs. the in-flight decode slots being paused.
  adaptive       chunked scheduling with a latency-SLO adaptive token
                 budget: shrinks the chunk budget when the live TPOT
                 (Scheduler.tpot_samples, fed by the request layer's
                 completion path) breaches the SLO, grows it back under
                 headroom.

Every policy emits the same per-seq ``(offset, n_tokens)`` spans, so TSEM
staging, the packed [T] chunk execution path, SAT transmission and the
sampler pool need no wire changes; a new policy is a subclass here, not
an engine fork.  See docs/scheduling.md §Scheduling policies and
docs/serving.md for the request lifecycle feeding the adaptive budget.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sequence import SeqStatus, Sequence

if TYPE_CHECKING:  # avoid the runtime cycle scheduler <-> policies
    from repro_torch.core.scheduler import Scheduler, SchedulingOutput


def _span_output(s: "Scheduler", it: int, slot: int, batch_ids: List[int],
                 spans: List[Tuple[int, int]], span_tokens: List[List[int]],
                 needs_sample: List[bool], recomposed: bool) -> "SchedulingOutput":
    """Assemble a span-carrying SchedulingOutput (shared by span policies)."""
    from repro_torch.core.scheduler import SchedulingOutput

    return SchedulingOutput(
        iteration=it,
        slot=slot,
        seq_ids=batch_ids,
        positions=np.array([off for off, _ in spans], np.int32),
        tokens=np.array([t[0] for t in span_tokens], np.int32),
        is_prefill=False,          # no monolithic pipeline-blocking pass
        # span-relevant prefill length: the prompt, or — for a sequence
        # resuming from preemption — its full recomputed token history
        prompt_lens=[s.seqs[q].prefill_len for q in batch_ids],
        batch_recomposed=recomposed,
        spans=spans,
        span_tokens=span_tokens,
        needs_sample=needs_sample,
    )


class SchedulingPolicy:
    """Builds one iteration's SchedulingOutput from scheduler state.

    ``uses_spans`` declares the execution contract: span policies emit
    per-seq ``(offset, n_tokens)`` spans executed through the packed-[T]
    chunk path (and require a token budget); the monolithic policy emits
    flat decode batches plus ``is_prefill`` admission batches.
    """

    name: str = "?"
    uses_spans: bool = False

    def schedule(self, s: "Scheduler", it: int) -> Optional["SchedulingOutput"]:
        raise NotImplementedError

    def metrics(self) -> Dict[str, int]:
        """Policy-specific counters, merged into engine metrics."""
        return {}

    @staticmethod
    def _alive_members(s: "Scheduler", slot: int) -> Tuple[List[int], bool]:
        """Slot membership minus finished sequences; True if it shrank."""
        members = [sid for sid in s.slot_members[slot]
                   if s.seqs[sid].status == SeqStatus.RUNNING]
        return members, len(members) != len(s.slot_members[slot])

    @staticmethod
    def _tier_split(s: "Scheduler",
                    members: List[int]) -> Tuple[List[int], List[int]]:
        """Partition slot members by tier, preserving order.  Policies
        schedule the online sublist FIRST and exactly as an online-only
        run would (docs/hybrid.md): offline members ride behind it in
        batch order, so the online sub-trace of every iteration is
        bit-identical with or without offline traffic."""
        online = [sid for sid in members if s.seqs[sid].is_online]
        offline = [sid for sid in members if not s.seqs[sid].is_online]
        return online, offline

    @staticmethod
    def _prune_running(s: "Scheduler", ids: List[int]) -> List[int]:
        """Drop members preempted mid-schedule (the online admission
        gate reclaims offline holdings as a side effect)."""
        return [sid for sid in ids
                if s.seqs[sid].status == SeqStatus.RUNNING]


class MonolithicPolicy(SchedulingPolicy):
    """Seed behavior: admit waiters as whole-prompt ``is_prefill`` batches
    (the engine prefills them through every stage, pipeline-blocking), then
    run flat 1-token decode iterations."""

    name = "monolithic"
    uses_spans = False

    def schedule(self, s: "Scheduler", it: int) -> Optional["SchedulingOutput"]:
        from repro_torch.core.scheduler import SchedulingOutput

        slot = it % s.p
        members, recomposed = self._alive_members(s, slot)
        online, offline = self._tier_split(s, members)
        new_prefill: List[int] = []

        def admit(seq: Sequence, into: List[int]):
            # a fork child admits with its prefill already satisfied (its
            # prompt KV lives in the shared blocks) — it joins as a pure
            # decode member, no is_prefill pass.  A prefix-cache-hit seq
            # still runs the full monolithic prefill (prefill_fn is pure
            # self-attention, it cannot resume mid-prompt from cache); its
            # recompute is write-masked so shared blocks are never touched
            # (engine passes mask_shared tables) — memory sharing only.
            needs_prefill = not seq.prefill_done
            seq.prefilled = seq.prefill_len       # monolithic: all at once
            into.append(seq.seq_id)
            if needs_prefill:
                new_prefill.append(seq.seq_id)

        while s.waiting and len(online) < s.max_batch and s.can_admit_next():
            offline = self._prune_running(s, offline)
            # online always gets its seat: an offline member occupying
            # the last one is preempted-by-recompute (docs/hybrid.md)
            if (len(online) + len(offline) >= s.max_batch
                    and not s.preempt_offline_seat(offline)):
                break
            admit(s.admit_next(), online)         # paged: reserves blocks
            recomposed = True
        # ---- offline tier: only seats the online tier left unclaimed ----
        offline = self._prune_running(s, offline)
        s.slack.see(s.max_batch - len(online))
        while (not s.waiting and s.waiting_offline
               and len(online) + len(offline) < s.max_batch
               and s.can_admit_next_offline()):
            admit(s.admit_next_offline(), offline)
            recomposed = True
        new_members = online + offline
        recomposed = recomposed or new_members != members
        members = new_members
        s.slot_members[slot] = members
        if not members:
            return None
        s.slack.sell(len(offline))    # one decode token per offline member

        tokens = np.array([s.seqs[sid].last_token for sid in members], np.int32)
        positions = np.array([s.seqs[sid].length - 1 for sid in members], np.int32)
        return SchedulingOutput(
            iteration=it,
            slot=slot,
            seq_ids=list(members),
            positions=positions,
            tokens=tokens,
            is_prefill=bool(new_prefill),
            prompt_lens=[len(s.seqs[q].prompt_ids) for q in members],
            batch_recomposed=recomposed,
        )


class ChunkedPolicy(SchedulingPolicy):
    """SARATHI-style chunked prefill piggybacked on decodes.

    Decode members are always carried (1 token each); prefill chunks share
    whatever budget remains, in slot-membership order; admission continues
    while the slot has space and budget."""

    name = "chunked"
    uses_spans = True

    def schedule(self, s: "Scheduler", it: int) -> Optional["SchedulingOutput"]:
        slot = it % s.p
        members, recomposed = self._alive_members(s, slot)
        online, offline = self._tier_split(s, members)

        # online decodes are entitled to their token; offline members get
        # no entitlement — they draw only from the leftover budget below
        n_decode = sum(1 for sid in online if s.seqs[sid].prefill_done)
        budget_left = s.token_budget - n_decode

        batch_ids: List[int] = []
        spans: List[Tuple[int, int]] = []
        span_tokens: List[List[int]] = []
        needs_sample: List[bool] = []

        def emit(seq: Sequence):
            nonlocal budget_left
            if seq.prefill_done:
                off = seq.length - 1
                spans.append((off, 1))
                span_tokens.append([seq.last_token])
                needs_sample.append(True)
                batch_ids.append(seq.seq_id)
                return True
            c = min(seq.prefill_len - seq.prefilled, budget_left)
            if c <= 0:
                return False          # deferred: stays a slot member
            off = seq.prefilled
            spans.append((off, c))
            span_tokens.append(seq.prefill_slice(off, c))
            needs_sample.append(off + c >= seq.prefill_len)
            batch_ids.append(seq.seq_id)
            seq.prefilled = off + c   # chunk issued: next schedule continues
            budget_left -= c
            return True

        deferred = False
        for sid in online:
            if not emit(s.seqs[sid]):
                deferred = True
        # fork children and prefix-cache hits need no special casing here:
        # kv_admit leaves them prefill_done (fork) or with ``prefilled``
        # advanced past the cached blocks (hit), and ``emit`` naturally
        # produces a decode span or a tail-only chunk starting at the
        # first unshared (block-aligned) token
        while (s.waiting and len(online) < s.max_batch
               and budget_left > 0 and s.can_admit_next()):
            offline = self._prune_running(s, offline)
            if (len(online) + len(offline) >= s.max_batch
                    and not s.preempt_offline_seat(offline)):
                break
            seq = s.admit_next()
            online.append(seq.seq_id)
            recomposed = True
            emit(seq)

        # ---- offline tier (docs/hybrid.md): whatever budget and seats
        # the online tier left this iteration.  Offline decodes are
        # deferrable (unlike online ones) — an iteration whose online
        # members ate the budget simply pauses them.
        offline = self._prune_running(s, offline)
        s.slack.see(s.max_batch - len(online))
        sold = 0

        def emit_offline(seq: Sequence) -> bool:
            nonlocal budget_left, sold
            if seq.prefill_done:
                if budget_left < 1:
                    return False
                spans.append((seq.length - 1, 1))
                span_tokens.append([seq.last_token])
                needs_sample.append(True)
                batch_ids.append(seq.seq_id)
                budget_left -= 1
                sold += 1
                return True
            c = min(seq.prefill_len - seq.prefilled, budget_left)
            if c <= 0:
                return False
            off = seq.prefilled
            spans.append((off, c))
            span_tokens.append(seq.prefill_slice(off, c))
            needs_sample.append(off + c >= seq.prefill_len)
            batch_ids.append(seq.seq_id)
            seq.prefilled = off + c
            budget_left -= c
            sold += c
            return True

        for sid in offline:
            if not emit_offline(s.seqs[sid]):
                deferred = True
        # admit offline only when no online waiter wants the seat (an
        # online head blocked on KV blocks would thrash: its admission
        # gate reclaims offline holdings on its next attempt)
        while (not s.waiting and s.waiting_offline
               and len(online) + len(offline) < s.max_batch
               and budget_left > 0 and s.can_admit_next_offline()):
            seq = s.admit_next_offline()
            offline.append(seq.seq_id)
            recomposed = True
            emit_offline(seq)
        s.slack.sell(sold)

        new_members = online + offline
        recomposed = recomposed or new_members != members
        s.slot_members[slot] = new_members
        if not batch_ids:
            return None
        # any chunked batch (or deferral gap) recomposes vs. pure decode
        recomposed = recomposed or deferred or any(c > 1 for _, c in spans)
        return _span_output(s, it, slot, batch_ids, spans, span_tokens,
                            needs_sample, recomposed)


class DisaggregatedPolicy(SchedulingPolicy):
    """TD-Pipe-style temporally-disaggregated phase scheduling.

    The whole pipeline (all p slots) is either in a *prefill phase* or a
    *decode phase*:

      prefill phase  iterations carry only prompt chunks, each slot using
                     the FULL token budget (zero decode piggybacking);
                     waiting sequences are admitted here.  Decode-ready
                     members are deferred (stay slot members, excluded from
                     the batch).
      decode phase   pure 1-token decode iterations — ``max_span == 1``, so
                     the engine runs the flat decode fast path and TSEM's
                     incremental n/n+p metadata update applies.  Prefilling
                     is never interleaved; no admission happens here.

    Phase machine (re-evaluated before every schedule call; the switch is
    global, so iteration durations stay uniform within a phase — the
    load-imbalance bubble TD-Pipe targets):

      PREFILL -> DECODE  when no prefill work is schedulable: every running
                         sequence finished its prefill and no waiter can be
                         admitted (queue empty or slots full).  Entering
                         decode therefore never strands a half-prefilled
                         sequence.
      DECODE  -> PREFILL when the pending prefill backlog justifies pausing
                         the in-flight decodes:
                           pending_tokens >= hysteresis_tokens * n_decode_slots
                         where ``pending_tokens`` counts only ADMISSIBLE
                         waiting prompts (the first ``free-seat-count``
                         queue entries — a deep queue behind one free seat
                         must not thrash the phase), ``n_decode_slots`` is
                         the number of slots currently carrying decode work
                         (the slots a prefill phase would pause), and
                         ``hysteresis_tokens`` defaults to the token budget
                         (one full prefill iteration per paused slot).
                         Forced immediately when no decode work remains, so
                         waiters never starve.

    TPOT-aware phase-length cap (``tpot_slo_s``): a prefill phase pauses
    every in-flight decode for its whole duration, so its length directly
    bounds the worst inter-token gap.  With an SLO set, the policy
    estimates the wall cost per prefill token from the live
    ``Scheduler.tpot_samples`` feed (median decode-iteration latency /
    token budget) and caps the tokens one phase may issue at
    ``PAUSE_FACTOR * tpot_slo_s`` worth of work: past the cap the phase
    stops ADMITTING new waiters and switches to decode as soon as every
    running prefill completes — the cap can end a phase early but never
    strands a half-prefilled sequence (the PREFILL->DECODE entry condition
    keeps requiring ``run_prefill == 0``).  The cap never drops below one
    full prefill iteration, so every phase makes progress — and it only
    binds while decode work is actually being paused (``n_decode > 0``):
    a phase with nothing to pause resets its token count and admits
    freely, which is also what keeps a capped phase whose members all
    FINISH from blocking admission forever.

    On a static workload (everything admitted, empty queue) the phase
    switches at most once, PREFILL -> DECODE; the threshold cannot re-fire
    because pending prefill stays zero — the no-oscillation property
    (tests/test_policies.py).
    """

    name = "disaggregated"
    uses_spans = True

    PREFILL = "prefill"
    DECODE = "decode"

    PAUSE_FACTOR = 4.0     # max decode pause per prefill phase, in SLO units
    MIN_TPOT_SAMPLES = 8   # live samples needed before the cap engages

    def __init__(self, hysteresis_tokens: Optional[int] = None,
                 tpot_slo_s: Optional[float] = None,
                 decode_enlarge_factor: int = 1):
        self.hysteresis_tokens = hysteresis_tokens   # None -> token budget
        self.tpot_slo_s = tpot_slo_s                 # None -> no phase cap
        # TD-Pipe-style decode-phase batch enlargement (docs/hybrid.md):
        # during pure-decode phases, offline decodes may widen the batch
        # beyond max_batch up to max_batch * factor, but only at pow2
        # rung totals (2*mb, 4*mb, ...) so each rung is ONE extra XLA
        # compile shape — the same capping discipline as table widths
        self.decode_enlarge_factor = max(1, int(decode_enlarge_factor))
        self.phase = self.PREFILL
        self.phase_switches = 0
        self.prefill_iters = 0
        self.decode_iters = 0
        self.enlarged_decode_iters = 0   # decode batches widened past mb
        self._phase_tokens = 0      # prefill tokens issued this phase
        self._phase_cap = 0         # 0 = uncapped
        self.capped_phases = 0

    def metrics(self) -> Dict[str, int]:
        return {
            "phase": self.phase,
            "phase_switches": self.phase_switches,
            "prefill_iters": self.prefill_iters,
            "decode_iters": self.decode_iters,
            "enlarged_decode_iters": self.enlarged_decode_iters,
            "decode_enlarge_factor": self.decode_enlarge_factor,
            "phase_token_cap": self._phase_cap,
            "capped_phases": self.capped_phases,
        }

    # -- phase machine ------------------------------------------------------
    def _switch(self, phase: str):
        self.phase = phase
        self.phase_switches += 1
        if phase == self.PREFILL:
            self._phase_tokens = 0

    def _refresh_cap(self, s: "Scheduler"):
        """Recompute the per-phase token cap from the live TPOT feed."""
        if self.tpot_slo_s is None or \
                len(s.tpot_samples) < self.MIN_TPOT_SAMPLES:
            self._phase_cap = 0
            return
        # one decode iteration ~ one sample gap; a prefill iteration does
        # ~token_budget tokens of the same stage work, so the wall cost of
        # a prefill token ~ median_gap / budget
        s_per_token = float(np.median(list(s.tpot_samples))) / s.token_budget
        cap = int((self.PAUSE_FACTOR * self.tpot_slo_s)
                  / max(s_per_token, 1e-9))
        self._phase_cap = max(cap, s.token_budget)   # >= one full iteration

    def _capped(self) -> bool:
        return bool(self._phase_cap) and self._phase_tokens >= self._phase_cap

    def _evaluate_phase(self, s: "Scheduler"):
        # Phase decisions are a pure function of ONLINE state: offline
        # members or backlog flipping a phase would change online
        # scheduling vs an online-only run (docs/hybrid.md).  Only when
        # there is no online work anywhere — nothing running, nothing
        # queued (incl. preempted resumes) — does the offline tier drive
        # the machine: an online-only run schedules nothing in that
        # state, so there is no online trace to disturb.
        tier_online = bool(s.waiting) or any(
            q.status == SeqStatus.RUNNING and q.is_online
            for q in s.seqs.values())
        queue = s.waiting if tier_online else s.waiting_offline
        running = [q for q in s.seqs.values()
                   if q.status == SeqStatus.RUNNING
                   and q.is_online == tier_online]
        n_decode = sum(1 for q in running if q.prefill_done)
        run_prefill = sum(q.prefill_len - q.prefilled for q in running
                          if not q.prefill_done)
        slot_alive = [sum(1 for sid in m
                          if s.seqs[sid].status == SeqStatus.RUNNING
                          and s.seqs[sid].is_online == tier_online)
                      for m in s.slot_members]
        # offline-driven: seats extend to the enlargement headroom, so a
        # backlog keeps prefilling until decode phases can run enlarged
        per_slot = (s.max_batch if tier_online
                    else s.max_batch * self.decode_enlarge_factor)
        space = sum(max(0, per_slot - a) for a in slot_alive)
        # only the ADMISSIBLE backlog counts: the first `space` waiting
        # prompts (FIFO admission) — a deep queue behind one free seat
        # must not fire the threshold, pause every decode slot, and then
        # flip straight back (phase thrash)
        # remaining (not total) prefill tokens: a prefix-cache hit's shared
        # prefix and a fork child's whole prompt cost no prefill compute,
        # so they must not inflate the pause-the-decodes threshold
        waiting_tokens = sum(max(0, q.prefill_len - q.prefilled)
                             for q, _ in zip(queue, range(space)))

        if self.phase == self.PREFILL:
            self._refresh_cap(s)
            # the cap bounds how long PAUSED DECODES wait; with no decode
            # work in flight it has nothing to protect — reset it so the
            # backlog keeps admitting (otherwise a phase whose members all
            # FINISH while capped would block admission forever: no
            # decodes to switch to, no admission to make progress with)
            if self._capped() and n_decode == 0:
                self._phase_tokens = 0
            # leave only when nothing is prefillable: running prefills done
            # AND no admission possible — so decode never strands a
            # half-prefilled sequence.  A capped phase treats its remaining
            # backlog as non-admissible (it paused decodes long enough).
            backlog = 0 if self._capped() else waiting_tokens
            if run_prefill == 0 and backlog == 0 and n_decode > 0:
                if self._capped() and waiting_tokens > 0:
                    self.capped_phases += 1    # the cap ended this phase
                self._switch(self.DECODE)
            return
        # DECODE phase: running sequences are all prefill_done (the entry
        # condition), so pending prefill is exactly the admissible backlog
        if waiting_tokens == 0:
            return
        if n_decode == 0:
            self._switch(self.PREFILL)   # forced: no decode work at all
            return
        n_decode_slots = sum(
            1 for m in s.slot_members
            if any(s.seqs[sid].status == SeqStatus.RUNNING
                   and s.seqs[sid].is_online == tier_online
                   and s.seqs[sid].prefill_done for sid in m))
        h = (self.hysteresis_tokens if self.hysteresis_tokens is not None
             else s.token_budget)
        if waiting_tokens >= h * max(1, n_decode_slots):
            self._switch(self.PREFILL)

    # -- per-slot dispatch --------------------------------------------------
    def schedule(self, s: "Scheduler", it: int) -> Optional["SchedulingOutput"]:
        self._evaluate_phase(s)
        slot = it % s.p
        members, recomposed = self._alive_members(s, slot)
        online, offline = self._tier_split(s, members)
        # offline membership may run up to max_batch * factor (the
        # enlargement headroom); online always fits in max_batch
        cap_members = s.max_batch * self.decode_enlarge_factor

        if self.phase == self.DECODE:
            # fork children carry zero prefill tokens — admitting them
            # mid-decode-phase keeps the pure-1-token invariant (they join
            # as decode members) and lets parallel-sampling children start
            # without waiting for the next prefill phase
            while (s.waiting and s.waiting[0].forked
                   and len(online) < s.max_batch and s.can_admit_next()):
                offline = self._prune_running(s, offline)
                if (len(online) + len(offline) >= cap_members
                        and not s.preempt_offline_seat(offline)):
                    break
                seq = s.admit_next()
                online.append(seq.seq_id)
                recomposed = True
            # offline fork children are likewise decode-ready; fresh
            # offline prompts wait for a prefill phase
            offline = self._prune_running(s, offline)
            s.slack.see(s.max_batch - len(online))
            while (s.waiting_offline and s.waiting_offline[0].forked
                   and len(online) + len(offline) < cap_members
                   and s.can_admit_next_offline()):
                seq = s.admit_next_offline()
                offline.append(seq.seq_id)
                recomposed = True
            new_members = online + offline
            recomposed = recomposed or new_members != members
            s.slot_members[slot] = new_members
            on_ids = [sid for sid in online if s.seqs[sid].prefill_done]
            off_ids = [sid for sid in offline if s.seqs[sid].prefill_done]
            # enlargement ladder: batch totals beyond max_batch only at
            # pow2 rungs (2*mb, 4*mb, ... <= mb*factor) — each rung is
            # one extra compile shape.  Between rungs, offline decodes
            # share the <= max_batch seats round-robin (rotation by
            # decode_iters) so none of them starves.
            total = len(on_ids) + len(off_ids)
            if total > s.max_batch:
                rung = s.max_batch
                r = 2 * s.max_batch
                while r <= cap_members:
                    if r <= total:
                        rung = r
                    r *= 2
                total = rung
            n_off = max(0, total - len(on_ids))
            if off_ids and n_off < len(off_ids):
                start = self.decode_iters % len(off_ids)
                off_ids = [off_ids[(start + i) % len(off_ids)]
                           for i in range(n_off)]
            else:
                off_ids = off_ids[:n_off]
            batch_ids = on_ids + off_ids
            if not batch_ids:
                return None
            spans = []
            span_tokens = []
            for sid in batch_ids:
                seq = s.seqs[sid]
                spans.append((seq.length - 1, 1))
                span_tokens.append([seq.last_token])
            recomposed = recomposed or len(batch_ids) != len(new_members)
            self.decode_iters += 1
            if len(batch_ids) > s.max_batch:
                self.enlarged_decode_iters += 1
            s.slack.sell(len(off_ids))
            return _span_output(s, it, slot, batch_ids, spans, span_tokens,
                                [True] * len(batch_ids), recomposed)

        # PREFILL phase: full budget to prompt chunks, decodes deferred
        budget_left = s.token_budget
        batch_ids, spans, span_tokens, needs_sample = [], [], [], []
        deferred = False

        def emit_chunk(seq: Sequence) -> bool:
            nonlocal budget_left
            c = min(seq.prefill_len - seq.prefilled, budget_left)
            if c <= 0:
                return False
            off = seq.prefilled
            spans.append((off, c))
            span_tokens.append(seq.prefill_slice(off, c))
            needs_sample.append(off + c >= seq.prefill_len)
            batch_ids.append(seq.seq_id)
            seq.prefilled = off + c
            budget_left -= c
            return True

        def emit_online_chunk(seq: Sequence) -> bool:
            ok = emit_chunk(seq)
            if ok:
                # only ONLINE tokens advance the TPOT phase cap: offline
                # tokens riding leftover budget must not end a phase
                # earlier than an online-only run would (docs/hybrid.md)
                self._phase_tokens += spans[-1][1]
            return ok

        for sid in online:
            seq = s.seqs[sid]
            if seq.prefill_done or not emit_online_chunk(seq):
                deferred = True       # decode members pause during prefill
        # a TPOT-capped phase stops admitting: in-progress prefills finish,
        # the backlog waits for the next phase (decodes get their turn)
        while (s.waiting and len(online) < s.max_batch
               and budget_left > 0 and not self._capped()
               and s.can_admit_next()):
            offline = self._prune_running(s, offline)
            if (len(online) + len(offline) >= cap_members
                    and not s.preempt_offline_seat(offline)):
                break
            seq = s.admit_next()
            online.append(seq.seq_id)
            recomposed = True
            emit_online_chunk(seq)

        # ---- offline tier: leftover prefill budget (docs/hybrid.md).
        # The phase's iteration count is a function of online state
        # alone, and each iteration stays <= token_budget tokens, so
        # filling the leftover costs at most what a full online prefill
        # iteration already costs.  Batch width stays <= max_batch (no
        # new compile shapes on the packed path).
        offline = self._prune_running(s, offline)
        s.slack.see(s.max_batch - len(online))
        sold0 = budget_left
        for sid in offline:
            seq = s.seqs[sid]
            if seq.prefill_done or len(batch_ids) >= s.max_batch \
                    or not emit_chunk(seq):
                deferred = True       # offline decodes pause during prefill
        while (not s.waiting and s.waiting_offline
               and len(online) + len(offline) < cap_members
               and len(batch_ids) < s.max_batch
               and budget_left > 0 and s.can_admit_next_offline()):
            seq = s.admit_next_offline()
            offline.append(seq.seq_id)
            recomposed = True
            if not seq.prefill_done:      # forked child: already decode-ready
                emit_chunk(seq)
        s.slack.sell(sold0 - budget_left)

        new_members = online + offline
        recomposed = recomposed or new_members != members
        s.slot_members[slot] = new_members
        if not batch_ids:
            return None
        self.prefill_iters += 1
        recomposed = recomposed or deferred or any(c > 1 for _, c in spans)
        return _span_output(s, it, slot, batch_ids, spans, span_tokens,
                            needs_sample, recomposed)


class AdaptivePolicy(ChunkedPolicy):
    """Latency-SLO adaptive token budget (ROADMAP item).

    Chunked scheduling whose per-iteration budget tracks the LIVE TPOT
    the request layer exposes.  Every chunk-carrying iteration inflates
    the inter-token latency of each co-scheduled decode (iteration cost
    ~ t_fixed + t_token * budget), so:

      * when the recent mean inter-token gap (``Scheduler.tpot_samples``,
        fed by ``complete()``) breaches the SLO, the chunk budget shrinks
        multiplicatively — decodes win back latency;
      * when there is headroom (< ``GROW_AT`` x SLO), the budget grows
        back toward the configured maximum — prefill wins back TTFT.

    The budget stays within ``[max_batch + 1, initial budget]``: the
    lower bound preserves prefill progress (the scheduler's own clamp),
    the upper bound preserves the engine's budget-fits-sliding-window
    validation done against the initial value.  ``tpot_slo_s=None``
    self-calibrates: the SLO becomes ``SLO_CALIB`` x the median of the
    first full sample window (useful on hardware whose absolute decode
    latency is unknown up front, e.g. this CPU container).
    """

    name = "adaptive"

    WINDOW = 16        # iterations between budget re-evaluations
    MIN_SAMPLES = 8    # gaps needed before adapting / self-calibrating
    SHRINK = 0.5       # multiplicative decrease on SLO breach
    GROW = 1.5         # multiplicative increase under headroom
    GROW_AT = 0.6      # grow when tpot < GROW_AT * SLO
    SLO_CALIB = 1.5    # self-calibrated SLO = SLO_CALIB * median(window)

    def __init__(self, tpot_slo_s: Optional[float] = None):
        self.tpot_slo_s = tpot_slo_s
        self._budget: Optional[int] = None
        self._min_budget = 0
        self._max_budget = 0
        self._next_eval = self.WINDOW
        self.budget_adjustments = 0

    def metrics(self) -> Dict[str, int]:
        return {
            "budget": self._budget or 0,
            "budget_max": self._max_budget,
            "budget_adjustments": self.budget_adjustments,
            "tpot_slo_us": int((self.tpot_slo_s or 0.0) * 1e6),
        }

    def _adapt(self, s: "Scheduler", it: int):
        if self._budget is None:           # first call: bind to the scheduler
            self._max_budget = s.token_budget
            self._min_budget = min(s.max_batch + 1, s.token_budget)
            self._budget = s.token_budget
        if it < self._next_eval or len(s.tpot_samples) < self.MIN_SAMPLES:
            return
        self._next_eval = it + self.WINDOW
        window = list(s.tpot_samples)
        if self.tpot_slo_s is None:
            self.tpot_slo_s = self.SLO_CALIB * float(np.median(window))
            return
        tpot = float(np.mean(window[-self.WINDOW:]))
        if tpot > self.tpot_slo_s and self._budget > self._min_budget:
            self._budget = max(self._min_budget,
                               int(self._budget * self.SHRINK))
            self.budget_adjustments += 1
        elif tpot < self.GROW_AT * self.tpot_slo_s \
                and self._budget < self._max_budget:
            self._budget = min(self._max_budget,
                               max(self._budget + 1,
                                   int(self._budget * self.GROW)))
            self.budget_adjustments += 1

    def schedule(self, s: "Scheduler", it: int) -> Optional["SchedulingOutput"]:
        self._adapt(s, it)
        s.token_budget = self._budget      # ChunkedPolicy reads it live
        return super().schedule(s, it)


POLICIES = {
    "monolithic": MonolithicPolicy,
    "chunked": ChunkedPolicy,
    "disaggregated": DisaggregatedPolicy,
    "adaptive": AdaptivePolicy,
}


def make_policy(name: Optional[str], *, token_budget: Optional[int] = None,
                hysteresis_tokens: Optional[int] = None,
                tpot_slo_s: Optional[float] = None,
                decode_enlarge_factor: int = 1) -> SchedulingPolicy:
    """Resolve a policy name against the token budget.

    ``None``/``"auto"`` keeps the historical contract: a token budget means
    chunked, no budget means monolithic.  Span policies require a budget;
    the monolithic policy rejects one (it would be silently ignored).
    """
    if name is None or name == "auto":
        name = "chunked" if token_budget is not None else "monolithic"
    if name not in POLICIES:
        raise ValueError(
            f"unknown scheduling policy {name!r}; choose from "
            f"{sorted(POLICIES)}")
    if hysteresis_tokens is not None and name != "disaggregated":
        raise ValueError(
            "phase_hysteresis_tokens / --hysteresis-tokens applies only "
            f"to the disaggregated policy (got policy {name!r})")
    if tpot_slo_s is not None and name not in ("adaptive", "disaggregated"):
        raise ValueError(
            "tpot_slo_s / --tpot-slo-ms applies only to the adaptive "
            "(budget adaptation) and disaggregated (prefill-phase length "
            f"cap) policies (got policy {name!r})")
    if decode_enlarge_factor < 1:
        raise ValueError(
            f"decode_enlarge_factor must be >= 1, got {decode_enlarge_factor}")
    if decode_enlarge_factor > 1 and name != "disaggregated":
        raise ValueError(
            "decode_enlarge_factor > 1 applies only to the disaggregated "
            "policy (decode-phase batch enlargement, docs/hybrid.md; got "
            f"policy {name!r})")
    if name == "monolithic":
        if token_budget is not None:
            raise ValueError(
                "monolithic policy takes no token budget "
                "(prefill_chunk_tokens / --chunk-tokens must be unset)")
        return MonolithicPolicy()
    if token_budget is None:
        raise ValueError(
            f"{name} policy requires a per-iteration token budget "
            "(set prefill_chunk_tokens / --chunk-tokens)")
    if name == "disaggregated":
        return DisaggregatedPolicy(hysteresis_tokens=hysteresis_tokens,
                                   tpot_slo_s=tpot_slo_s,
                                   decode_enlarge_factor=decode_enlarge_factor)
    if name == "adaptive":
        return AdaptivePolicy(tpot_slo_s=tpot_slo_s)
    return ChunkedPolicy()
