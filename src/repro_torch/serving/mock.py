"""A deterministic stand-in engine for transport-layer tests.

Implements exactly the engine surface the serving layer touches —
``add_request`` / ``step`` / ``abort`` / ``load`` / ``metrics`` /
``has_work`` / ``shutdown`` — with a trivial arithmetic "model": token
``k`` of a completion is ``(sum(prompt) + k) % vocab``.  One token per
request per ``step()``, ``SamplingParams.n > 1`` emits fork streams
with a per-fork offset.  Lets protocol, router, and admission tests run
the full HTTP path in milliseconds, with no JAX compile anywhere
(tests/test_http.py, tests/test_router.py); the real-engine e2e parity
lives next to it in the same files.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional

from repro_torch.core.request import (
    ForkOutput,
    RequestMetrics,
    RequestOutput,
    RequestState,
)
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.core.sequence import SeqStatus, Sequence


class MockEngine:
    """Deterministic fake with real RequestOutput framing."""

    BLOCK = 4      # tokens per fake KV block (occupancy accounting)

    def __init__(self, vocab_size: int = 64, kv_blocks: int = 64,
                 start_id: int = 0):
        self.vocab_size = vocab_size
        self.kv_blocks = kv_blocks
        self._ids = itertools.count(start_id)
        self._live: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self.n_aborts = 0
        self.n_finished = 0
        self.n_steps = 0
        self._stopped = False

    # -- engine surface ------------------------------------------------------
    def add_request(self, prompt_ids: List[int], params: SamplingParams,
                    arrival_t: Optional[float] = None) -> int:
        rid = next(self._ids)
        seq = Sequence(rid, list(prompt_ids), params)
        seq.status = SeqStatus.RUNNING
        with self._lock:
            self._live[rid] = {"seq": seq, "streamed": 0,
                               "forks": [list() for _ in range(params.n - 1)],
                               "aborted": False}
        return rid

    def abort(self, request_id: int, fork: Optional[int] = None) -> bool:
        with self._lock:
            r = self._live.get(request_id)
            if r is None:
                return False
            r["aborted"] = True
            self.n_aborts += 1
        return True

    def _token(self, seq: Sequence, k: int, fork: int = 0) -> int:
        return (sum(seq.prompt_ids) + 31 * fork + k) % self.vocab_size

    def step(self) -> List[RequestOutput]:
        self.n_steps += 1
        outs: List[RequestOutput] = []
        with self._lock:
            for rid in list(self._live):
                r = self._live[rid]
                seq: Sequence = r["seq"]
                want = seq.params.max_new_tokens
                if r["aborted"]:
                    seq.status = SeqStatus.ABORTED
                    seq.finish_reason = "abort"
                else:
                    k = len(seq.output_ids)
                    seq.output_ids.append(self._token(seq, k))
                    for fi, f in enumerate(r["forks"]):
                        f.append(self._token(seq, len(f), fi + 1))
                    if len(seq.output_ids) >= want:
                        seq.status = SeqStatus.FINISHED
                        seq.finish_reason = "length"
                done = seq.status in (SeqStatus.FINISHED, SeqStatus.ABORTED)
                new = seq.output_ids[r["streamed"]:]
                r["streamed"] = len(seq.output_ids)
                forks = [ForkOutput(fi + 1, ([] if r["aborted"] else [f[-1]]),
                                    list(f), done, seq.finish_reason if done
                                    else None)
                         for fi, f in enumerate(r["forks"])] or None
                outs.append(RequestOutput(
                    rid, new, list(seq.output_ids), done,
                    RequestState.of(seq), seq.finish_reason if done else None,
                    RequestMetrics.of(seq) if done else None, seq,
                    forks=forks))
                if done:
                    self._live.pop(rid)
                    self.n_finished += seq.status == SeqStatus.FINISHED
        return outs

    @property
    def has_work(self) -> bool:
        return bool(self._live)

    def load(self) -> Dict[str, int]:
        with self._lock:
            busy = sum(-(-(r["seq"].length) // self.BLOCK) * seq_count(r)
                       for r in self._live.values())
        return {"active_requests": len(self._live), "queue_depth": 0,
                "kv_blocks_total": self.kv_blocks,
                "kv_blocks_free": max(0, self.kv_blocks - busy)}

    def metrics(self) -> Dict[str, float]:
        load = self.load()
        return {"requests_finished": self.n_finished,
                "requests_aborted": self.n_aborts,
                "requests_active": load["active_requests"],
                "queue_depth": 0,
                "kv_blocks_total": load["kv_blocks_total"],
                "kv_blocks_free": load["kv_blocks_free"],
                "steps": self.n_steps}

    def shutdown(self):
        self._stopped = True


def seq_count(rec: dict) -> int:
    return 1 + len(rec["forks"])
