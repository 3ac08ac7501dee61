"""Column-wise CPU sampling with incremental metadata reuse (SiPipe §5.1).

The sampler runs on host CPUs, decoupled from the accelerator: the final
pipeline stage ships logits and goes straight to its next microbatch,
eliminating the paper's *load-imbalance bubble*.

Key mechanics reproduced from the paper:
  * incremental penalty construction: each iteration touches exactly the B
    entries of each penalty buffer addressed by the new token ids, instead
    of recomputing dense penalty tensors from the output history Y (the
    naive baseline below recomputes — cost grows with sequence length);
  * preallocated max-length output buffer Y: new token ids are appended in
    place — no reshape/reallocation per iteration;
  * column-wise (transposed) layout on the *shard ingestion* path: TP
    workers produce [B, V/t] logits shards; transposed to [V/t, B] they
    concatenate along rows into Z^T [V, B] with zero gathers (§5.1(3)).
    ``sample(..., transposed=True)`` consumes that layout directly;
  * p distinct replicas (pipeline degree) — microbatch n and n+p are the
    same sequence set, so each replica's buffers stay valid under PP.

Per-request sampling parameters: ``sample()`` accepts either one
``SamplingParams`` (the whole batch shares it) or a per-column sequence
of them — the serving API contract that mixed continuous-batching
batches carry each request's own temperature/penalties.  Penalty
application is vectorized over per-column coefficient arrays against the
shared replica buffers; the draw stage partitions columns into groups of
identical params (mixed batches are recompositions of a few distinct
request configs, so groups are few).  A uniform batch takes the exact
pre-existing scalar path, bit-for-bit.

Hardware adaptation (DESIGN.md §sampler-layout): on this numpy substrate
the compute-heavy steps (softmax/top-k) are fastest along contiguous
vocab rows, so when logits arrive row-major [B, V] the penalty buffers are
kept row-major too — the *incremental O(B) update* (the paper's actual
saving) is layout-independent; the column-wise layout is used exactly
where it pays: zero-copy transposed shard ingestion.

``NaiveSampler`` implements the recompute-from-scratch baseline used for
the ablation benchmark (paper Fig. 16).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.sampling_params import SamplingParams

ParamsLike = Union[SamplingParams, Sequence[SamplingParams]]


def _softmax(z: np.ndarray, axis: int) -> np.ndarray:
    m = z.max(axis=axis, keepdims=True)
    e = np.exp(z - m, dtype=np.float32)
    return e / e.sum(axis=axis, keepdims=True)


def _normalize_params(params: ParamsLike, b: int) -> List[SamplingParams]:
    """Broadcast a single SamplingParams to the batch; validate lengths."""
    if isinstance(params, SamplingParams):
        return [params] * b
    plist = list(params)
    if len(plist) != b:
        raise ValueError(
            f"per-column sampling params length {len(plist)} != batch {b}")
    return plist


def _uniform(plist: List[SamplingParams]) -> Optional[SamplingParams]:
    """The shared params when every column agrees, else None."""
    first = plist[0]
    return first if all(q == first for q in plist) else None


def _coef(plist: List[SamplingParams], attr: str, axis: int) -> np.ndarray:
    """Per-column coefficient array shaped to broadcast along ``axis``."""
    a = np.array([getattr(q, attr) for q in plist], np.float32)
    return a[:, None] if axis == 1 else a[None, :]


def _apply_penalties(z: np.ndarray, plist: List[SamplingParams],
                     freq: np.ndarray, pres: np.ndarray,
                     axis: int) -> np.ndarray:
    """(1) logits adjustment — fused vector ops on the penalty buffers
    (a sampler replica's persistent buffers, or NaiveSampler's recomputed
    ones).  Uniform batches keep the scalar expressions; mixed batches
    use per-column coefficient arrays broadcast against the same buffers.
    Shared by both samplers so penalty semantics cannot diverge."""
    u = _uniform(plist)
    if u is not None:
        if u.frequency_penalty:
            z -= u.frequency_penalty * freq
        if u.presence_penalty:
            z -= u.presence_penalty * pres
        if u.repetition_penalty != 1.0:
            seen = pres > 0
            pen = np.where(z > 0, z / u.repetition_penalty,
                           z * u.repetition_penalty)
            z = np.where(seen, pen, z)
        return z
    fp = _coef(plist, "frequency_penalty", axis)
    if fp.any():
        z -= fp * freq
    pp = _coef(plist, "presence_penalty", axis)
    if pp.any():
        z -= pp * pres
    rp = _coef(plist, "repetition_penalty", axis)
    if (rp != 1.0).any():
        seen = (pres > 0) & (rp != 1.0)
        pen = np.where(z > 0, z / rp, z * rp)
        z = np.where(seen, pen, z)
    return z


def _draw_grouped(z: np.ndarray, plist: List[SamplingParams], axis: int,
                  draw_one) -> np.ndarray:
    """Token draw honoring per-column params: columns sharing params form
    one group and draw together via ``draw_one(z_group, params)`` (a
    uniform batch == one group == the original whole-batch path)."""
    u = _uniform(plist)
    if u is not None:
        if u.greedy or u.temperature == 0.0:
            return z.argmax(axis=axis).astype(np.int32)
        return draw_one(z, u)
    out = np.zeros(len(plist), np.int32)
    groups: Dict[SamplingParams, List[int]] = {}
    for i, q in enumerate(plist):
        groups.setdefault(q, []).append(i)
    for q, cols in groups.items():
        idx = np.asarray(cols, np.int64)
        zz = z[idx] if axis == 1 else z[:, idx]   # fancy-index copy
        if q.greedy or q.temperature == 0.0:
            ids = zz.argmax(axis=axis).astype(np.int32)
        else:
            ids = draw_one(zz, q)
        out[idx] = ids
    return out


@dataclasses.dataclass
class _Replica:
    """Per-pipeline-slot penalty state.  ``layout`` is "rm" (row-major
    [B, V]) or "cw" (column-wise [V, B], transposed-shard ingestion)."""

    layout: str
    freq: np.ndarray
    pres: np.ndarray
    out: np.ndarray         # [L_max, B] int32 output ids (row-appended)
    out_len: np.ndarray     # [B] int32
    seq_ids: List[int]


class ColumnWiseSampler:
    """The SiPipe CPU sampler (see module docstring)."""

    def __init__(self, vocab_size: int, max_batch: int, *, pp_degree: int = 1,
                 max_len: int = 4096, seed: int = 0):
        self.v = vocab_size
        self.max_batch = max_batch
        self.p = pp_degree
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self._replicas: Dict[int, _Replica] = {}
        # serializes replica get-rebuild-update: sample() runs on the
        # engine's pool threads while drop_seq() (request retire/abort)
        # runs on the driver thread — an unsynchronized concurrent rebuild
        # of the same slot replica would drop the pool thread's penalty
        # update for surviving sequences
        self._lock = threading.Lock()

    # ---- replica management ---------------------------------------------
    def _replica(self, slot: int, batch: int, seq_ids: Sequence[int],
                 layout: str) -> _Replica:
        """Fetch (or rebuild) the slot's penalty replica.

        Rebuilds carry per-sequence state over: when the sequence set
        shrinks, grows or is reordered (mixed-batch evictions, chunked
        prefill phases), every sequence still present keeps its freq /
        pres / output columns — only departed sequences are dropped and
        new ones start from zero.  This is what makes chunked prefill
        compose exactly with frequency/presence penalties.
        """
        r = self._replicas.get(slot)
        ids = list(seq_ids)
        if (r is not None and r.out_len.shape[0] == batch
                and r.seq_ids == ids and r.layout == layout):
            return r
        shape = (self.v, batch) if layout == "cw" else (batch, self.v)
        new = _Replica(
            layout=layout,
            freq=np.zeros(shape, np.float32),
            pres=np.zeros(shape, np.float32),
            out=np.zeros((self.max_len, batch), np.int32),
            out_len=np.zeros(batch, np.int32),
            seq_ids=ids,
        )
        if r is not None:
            old_col = {sid: j for j, sid in enumerate(r.seq_ids)}
            for col, sid in enumerate(ids):
                j = old_col.get(sid)
                if j is None:
                    continue
                src_f = r.freq[:, j] if r.layout == "cw" else r.freq[j]
                src_p = r.pres[:, j] if r.layout == "cw" else r.pres[j]
                if layout == "cw":
                    new.freq[:, col] = src_f
                    new.pres[:, col] = src_p
                else:
                    new.freq[col] = src_f
                    new.pres[col] = src_p
                new.out[:, col] = r.out[:, j]
                new.out_len[col] = r.out_len[j]
        self._replicas[slot] = new
        return new

    def reset(self):
        with self._lock:
            self._replicas.clear()

    def evict(self, slot: int):
        with self._lock:
            self._replicas.pop(slot, None)

    def drop_seq(self, seq_id: int):
        """Strip a released sequence's penalty column from every replica
        (request retired or aborted — its state must not linger)."""
        with self._lock:
            for slot, r in list(self._replicas.items()):
                if seq_id not in r.seq_ids:
                    continue
                ids = [s for s in r.seq_ids if s != seq_id]
                if not ids:
                    del self._replicas[slot]
                else:
                    self._replica(slot, len(ids), ids, r.layout)

    def tracked_seq_ids(self) -> set:
        """Sequence ids with live penalty columns (leak assertions)."""
        with self._lock:
            out = set()
            for r in self._replicas.values():
                out.update(r.seq_ids)
            return out

    # ---- the sampling pipeline -------------------------------------------
    def sample(
        self,
        logits: np.ndarray,
        params: ParamsLike,
        *,
        slot: int = 0,
        seq_ids: Optional[Sequence[int]] = None,
        transposed: bool = False,
    ) -> np.ndarray:
        """logits: [B, V] row-major, or [V, B] when ``transposed`` (the
        zero-gather concatenation of per-worker [V/t, B] shards).
        ``params``: one SamplingParams for the whole batch, or one per
        column (per-request sampling parameters in mixed batches)."""
        if transposed:
            return self._sample_cw(np.asarray(logits, np.float32), params,
                                   slot, seq_ids)
        z = np.array(logits, np.float32, copy=True)          # [B, V]
        b = z.shape[0]
        plist = _normalize_params(params, b)
        with self._lock:
            r = self._replica(slot % self.p, b, seq_ids or list(range(b)),
                              "rm")
            z = _apply_penalties(z, plist, r.freq, r.pres, axis=1)
            ids = _draw_grouped(z, plist, 1,
                                lambda zz, q: self._draw(zz, q, 1))
            self._update(r, ids)
        return ids

    def _sample_cw(self, zt, params, slot, seq_ids):
        # np.asarray does NOT copy an already-float32 input, and both the
        # penalty ops below and _draw mutate in place — copy so the
        # caller's logits buffer (shipped over BIC-L) survives intact
        zt = np.array(zt, np.float32, copy=True)
        v, b = zt.shape
        assert v == self.v, (v, self.v)
        plist = _normalize_params(params, b)
        with self._lock:
            r = self._replica(slot % self.p, b, seq_ids or list(range(b)),
                              "cw")
            zt = _apply_penalties(zt, plist, r.freq, r.pres, axis=0)
            ids = _draw_grouped(zt, plist, 0,
                                lambda zz, q: self._draw(zz, q, 0))
            self._update(r, ids)
        return ids

    # ---- shared probability pipeline --------------------------------------
    def _draw(self, z: np.ndarray, params: SamplingParams, axis: int) -> np.ndarray:
        if params.greedy or params.temperature == 0.0:
            return z.argmax(axis=axis).astype(np.int32)
        if params.temperature != 1.0:
            z /= params.temperature
        if params.top_k:
            if axis == 1:
                kth = np.partition(z, -params.top_k, axis=1)[:, -params.top_k]
                z[z < kth[:, None]] = -np.inf
            else:
                kth = np.partition(z, -params.top_k, axis=0)[-params.top_k]
                z[z < kth[None, :]] = -np.inf
        probs = _softmax(z, axis)
        if params.min_p:
            cap = probs.max(axis=axis, keepdims=True) * params.min_p
            probs[probs < cap] = 0.0
        if params.top_p < 1.0:
            probs = self._top_p_filter(probs, params.top_p, axis)
        probs /= probs.sum(axis=axis, keepdims=True)
        b = probs.shape[1 - axis]
        u = self.rng.random(b, dtype=np.float32)
        cdf = np.cumsum(probs, axis=axis)
        if axis == 1:
            ids = (cdf < u[:, None]).sum(axis=1)
        else:
            ids = (cdf < u[None, :]).sum(axis=0)
        return ids.clip(0, self.v - 1).astype(np.int32)

    @staticmethod
    def _top_p_filter(probs: np.ndarray, top_p: float, axis: int) -> np.ndarray:
        order = np.argsort(-probs, axis=axis)
        sp = np.take_along_axis(probs, order, axis=axis)
        csum = np.cumsum(sp, axis=axis)
        keep_sorted = (csum - sp) <= top_p   # keep until mass exceeds p
        keep = np.zeros_like(keep_sorted)
        np.put_along_axis(keep, order, keep_sorted, axis=axis)
        return np.where(keep, probs, 0.0)

    # ---- incremental metadata update: O(B) scattered writes ----------------
    def _update(self, r: _Replica, ids: np.ndarray):
        b = ids.shape[0]
        cols = np.arange(b)
        if r.layout == "cw":
            r.freq[ids, cols] += 1.0
            r.pres[ids, cols] = 1.0
        else:
            r.freq[cols, ids] += 1.0
            r.pres[cols, ids] = 1.0
        r.out[r.out_len.clip(max=self.max_len - 1), cols] = ids
        np.minimum(r.out_len + 1, self.max_len, out=r.out_len)

    def seed_prompt(self, slot: int, batch: int, seq_ids: Sequence[int],
                    prompt_ids: List[np.ndarray], layout: str = "rm"):
        """Fold prompt tokens into the penalty state (vLLM semantics:
        repetition/presence penalties consider the prompt)."""
        with self._lock:
            r = self._replica(slot % self.p, batch, seq_ids, layout)
            for col, ids in enumerate(prompt_ids):
                ids = np.asarray(ids, np.int64)
                if layout == "cw":
                    np.add.at(r.freq[:, col], ids, 1.0)
                    r.pres[ids, col] = 1.0
                else:
                    np.add.at(r.freq[col], ids, 1.0)
                    r.pres[col, ids] = 1.0


class NaiveSampler:
    """Recompute-from-scratch baseline (what pipeline-agnostic engines do):
    rebuilds [B, V] penalty tensors from the full output history every
    iteration — cost grows with generated length.  Accepts the same
    per-column params contract as ColumnWiseSampler.

    When ``seq_ids`` is passed (the engine always does), output history
    is keyed per sequence, so batch recomposition under continuous
    serving cannot hand a successor request its predecessor's penalty
    history; without ``seq_ids`` the legacy per-slot positional history
    applies (microbenchmarks seed it directly)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.v = vocab_size
        self.rng = np.random.default_rng(seed)
        self.history: Dict[int, List[np.ndarray]] = {}      # slot -> columns
        self.seq_history: Dict[int, np.ndarray] = {}        # seq_id -> ids

    def drop_seq(self, seq_id: int):
        """Release a retired/aborted sequence's output history."""
        self.seq_history.pop(seq_id, None)

    def tracked_seq_ids(self) -> set:
        return set(self.seq_history)

    def sample(self, logits: np.ndarray, params: ParamsLike, *,
               slot: int = 0, seq_ids: Optional[Sequence[int]] = None,
               **_) -> np.ndarray:
        z = np.array(logits, np.float32, copy=True)   # [B, V]
        b = z.shape[0]
        plist = _normalize_params(params, b)
        if seq_ids is not None:
            hist = [self.seq_history.get(sid, np.zeros(0, np.int64))
                    for sid in seq_ids]
        else:
            hist = self.history.setdefault(
                slot, [np.zeros(0, np.int64) for _ in range(b)])
            if len(hist) != b:
                hist = self.history[slot] = [np.zeros(0, np.int64)
                                             for _ in range(b)]

        if any(q.needs_penalties() for q in plist):
            freq = np.zeros((b, self.v), np.float32)  # fresh allocation
            for i, h in enumerate(hist):              # full recompute over Y
                np.add.at(freq[i], h, 1.0)
            pres = (freq > 0).astype(np.float32)
            z = _apply_penalties(z, plist, freq, pres, axis=1)

        ids = _draw_grouped(z, plist, 1, self._draw)

        if seq_ids is not None:
            for sid, t in zip(seq_ids, ids):
                self.seq_history[sid] = np.append(
                    self.seq_history.get(sid, np.zeros(0, np.int64)), t)
        else:
            for i, t in enumerate(ids):
                hist[i] = np.append(hist[i], t)
        return ids

    def _draw(self, z: np.ndarray, params: SamplingParams) -> np.ndarray:
        b = z.shape[0]
        if params.greedy or params.temperature == 0.0:
            return z.argmax(axis=1).astype(np.int32)
        if params.temperature != 1.0:
            z /= params.temperature
        if params.top_k:
            kth = np.partition(z, -params.top_k, axis=1)[:, -params.top_k]
            z[z < kth[:, None]] = -np.inf
        probs = _softmax(z, 1)
        if params.min_p:
            cap = probs.max(axis=1, keepdims=True) * params.min_p
            probs[probs < cap] = 0.0
        if params.top_p < 1.0:
            probs = ColumnWiseSampler._top_p_filter(probs, params.top_p, 1)
        probs /= probs.sum(axis=1, keepdims=True)
        u = self.rng.random((b, 1), dtype=np.float32)
        cdf = np.cumsum(probs, axis=1)
        return (cdf < u).sum(axis=1).clip(0, self.v - 1).astype(np.int32)


class SamplingWorker:
    """Host-side sampling thread that overlaps iteration *n*'s sampling
    with the device's execution of iteration *n+1* (the SiPipe design
    point: sampling leaves the critical path of the stage loop).

    A single daemon thread drains a FIFO queue, so dispatch order equals
    submission order equals iteration order — token streams are
    *identical* to synchronous sampling (the sampler replicas' penalty
    state is mutated in exactly the same sequence, and the engine's
    per-slot autoregressive gate still makes a slot's next iteration
    await its sampled token).  The worker only moves *where* the wall
    time of ``dispatch_fn`` is spent: off the thread that launches
    device work.

    ``dispatch_fn(sched, logits)`` is the engine's synchronous sampling
    entry (sample + publish + iter-done bookkeeping).  Exceptions are
    captured and re-raised on the driver thread via ``check()`` — the
    engine polls it from its await loop, so a sampler crash surfaces
    instead of deadlocking the per-slot gate.
    """

    def __init__(self, dispatch_fn: Callable, name: str = "sampling-worker"):
        self.dispatch_fn = dispatch_fn
        self._q: "queue.Queue" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, sched, logits):
        self._q.put((sched, logits))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue                       # drain; check() will raise
            sched, logits = item
            try:
                self.dispatch_fn(sched, logits)
            except BaseException as e:         # noqa: BLE001
                self._exc = e

    def check(self):
        """Re-raise (once per poll) any exception from the worker thread."""
        if self._exc is not None:
            raise RuntimeError("sampling worker failed") from self._exc

    def stop(self, timeout: float = 5.0):
        self._q.put(None)
        self._thread.join(timeout=timeout)
