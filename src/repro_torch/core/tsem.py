"""Token-Safe Execution Model (SiPipe §5.2), adapted to JAX.

The paper's mechanism targets CUDA graphs: static kernel sequences bound
to fixed device buffers, where asynchronous CPU input preparation causes
write-after-read hazards.  The JAX/TPU analogue (see DESIGN.md
§Hardware-adaptation):

  CUDA graph              ->  AOT-compiled executable (jit().lower().compile())
                              with donated inputs (stable buffer bindings)
  two captured graphs     ->  two *versioned host staging buffer sets* per
  per batch size              batch size; the executable is shape-keyed
  WAR hazard              ->  CPU executor writes staging version i % 2
                              while the device consumes version (i-1) % 2

The FSM with CPU/GPU indicators (CI/GI) is reproduced literally: the CPU
executor may run ahead by exactly one iteration (CI == GI gate), which is
what makes the double buffer sufficient.

``BatchMetadataCache`` keeps p replica versions (pipeline degree) and
updates them *incrementally* when the batch composition is unchanged
between iterations n and n+p — only positions advance and last tokens
swap, no reallocation (§5.2 + §5.1 inter-batch similarity).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import SchedulingOutput


@dataclasses.dataclass
class BatchMetadata:
    """Preprocessed CPU tensors for one microbatch (one TSEM replica).

    Pure-decode batches use the flat [B] layout (``width == 1``).  Mixed
    chunked-prefill batches carry the *packed ragged* layout instead of
    padded [B, C] matrices: flat [W] token/position/seq-index vectors
    (W = the power-of-two bucket ``SchedulingOutput.packed_width``), so
    a mostly-decode batch with one chunk does sum(T_i) work, not B x C.
    Padding entries duplicate the last valid packed element (same token,
    position AND batch row), so downstream cache scatters write identical
    values at duplicate indices and stay deterministic without a mask.
    """

    seq_ids: List[int]
    rows: np.ndarray           # [B] cache-row assignment (contiguous layout)
    tokens: np.ndarray         # [B] first input token of each span
    positions: np.ndarray      # [B] span start positions
    iteration: int = -1
    width: int = 1             # packed bucket width (1 = pure decode)
    n_valid: int = 0           # valid packed tokens (T <= width)
    pack_tokens: Optional[np.ndarray] = None     # [W] int32
    pack_positions: Optional[np.ndarray] = None  # [W] int32
    pack_seq: Optional[np.ndarray] = None        # [W] batch column per token
    last_index: Optional[np.ndarray] = None      # [B] packed idx of last valid
    # paged KV layout: [B, nb] physical block table (trash-padded).  The
    # dirty-slot write-back mapping (which physical block a row's new
    # token lands in) is derived *inside* the jitted stage function from
    # the table + positions — no host-side slot staging.
    n_blocks: int = 0          # nb (0 = contiguous layout)
    block_tables: Optional[np.ndarray] = None    # [B, nb] int32

    def advance_inplace(self, sched: SchedulingOutput, rows: np.ndarray):
        """Incremental update: same sequence set, next iteration.  Under
        the paged layout a table may have gained a block between n and
        n+p, so the (same-shaped) table snapshot is refreshed in place."""
        np.copyto(self.tokens, sched.tokens)
        np.copyto(self.positions, sched.positions)
        np.copyto(self.rows, rows)
        if self.block_tables is not None:
            np.copyto(self.block_tables, sched.block_tables)
        self.iteration = sched.iteration


def _build_packed(sched: SchedulingOutput):
    """Packed [W] vectors, padded to the bucket with last-valid duplicates."""
    tok, pos, seq, last = sched.packed_layout()
    t = tok.shape[0]
    w = sched.packed_width

    def pad(a):
        out = np.empty(w, np.int32)
        out[:t] = a
        out[t:] = a[-1]
        return out

    return pad(tok), pad(pos), pad(seq), last, t


class BatchMetadataCache:
    """p versions of BatchMetadata, indexed by iteration %% p.

    The incremental-update fast path applies only when both the cached
    replica and the incoming batch are pure decode (width 1) with the same
    sequence set; iterations carrying prefill chunks rebuild, since their
    per-seq token spans change between n and n+p as prefill progresses.
    """

    def __init__(self, pp_degree: int):
        self.p = pp_degree
        self._meta: List[Optional[BatchMetadata]] = [None] * pp_degree
        self.incremental_hits = 0
        self.rebuilds = 0

    def update(self, sched: SchedulingOutput,
               rows: np.ndarray) -> BatchMetadata:
        slot = sched.iteration % self.p
        meta = self._meta[slot]
        width = sched.packed_width
        nb = 0 if sched.block_tables is None else sched.block_tables.shape[1]
        if (meta is not None and meta.seq_ids == sched.seq_ids
                and meta.width == 1 and width == 1
                and meta.n_blocks == nb):
            meta.advance_inplace(sched, rows)
            self.incremental_hits += 1
            return meta
        meta = BatchMetadata(
            seq_ids=list(sched.seq_ids),
            rows=np.array(rows, np.int32),
            tokens=np.array(sched.tokens, np.int32),
            positions=np.array(sched.positions, np.int32),
            iteration=sched.iteration,
            width=width,
            n_blocks=nb,
        )
        if width > 1:
            (meta.pack_tokens, meta.pack_positions, meta.pack_seq,
             meta.last_index, meta.n_valid) = _build_packed(sched)
        if nb:
            meta.block_tables = np.array(sched.block_tables, np.int32)
        self._meta[slot] = meta
        self.rebuilds += 1
        return meta


class VersionedStaging:
    """Two host-side staging buffer sets per batch shape (v0 / v1).

    Pure-decode iterations stage flat [B] arrays; chunked iterations are
    keyed additionally by the packed bucket width W and stage flat [W]
    token/position/seq-index vectors plus the [B] last-valid indices.
    Under the paged KV layout the key gains the padded block-table width
    nb, and the set stages the [B, nb] physical block table (the jitted
    stage derives the dirty-slot write-back mapping from it on device).
    """

    def __init__(self):
        self._bufs: Dict[Tuple[int, int, int, int],
                         Dict[str, np.ndarray]] = {}

    def buffers(self, version: int, batch: int, width: int = 1,
                n_blocks: int = 0) -> Dict[str, np.ndarray]:
        key = (version & 1, batch, width, n_blocks)
        if key not in self._bufs:
            bufs = {
                "tokens": np.zeros(batch, np.int32),
                "positions": np.zeros(batch, np.int32),
                "rows": np.zeros(batch, np.int32),
            }
            if width > 1:
                bufs["pack_tokens"] = np.zeros(width, np.int32)
                bufs["pack_positions"] = np.zeros(width, np.int32)
                bufs["pack_seq"] = np.zeros(width, np.int32)
                bufs["last_index"] = np.zeros(batch, np.int32)
                bufs["n_valid"] = np.zeros(1, np.int32)
            if n_blocks:
                bufs["block_tables"] = np.zeros((batch, n_blocks), np.int32)
            self._bufs[key] = bufs
        return self._bufs[key]


@dataclasses.dataclass
class ModelInputDescriptor:
    """Lightweight descriptor enqueued to the device executor (the heavy
    tensors live in the staging buffers it points at)."""

    iteration: int
    version: int
    batch: int
    is_prefill: bool
    sched: SchedulingOutput
    width: int = 1             # packed bucket width (1 = flat decode)
    n_blocks: int = 0          # padded block-table width (0 = contiguous)


class TokenSafeExecutor:
    """Decoupled CPU-prepare / device-execute with the paper's FSM.

    ``prepare_fn(sched, staging_bufs) -> None`` fills staging in place.
    ``execute_fn(desc, staging_bufs) -> Any`` runs the AOT step.
    """

    def __init__(self, prepare_fn: Callable, execute_fn: Callable,
                 *, max_ahead: int = 1, name: str = "stage"):
        self.prepare_fn = prepare_fn
        self.execute_fn = execute_fn
        self.staging = VersionedStaging()
        self.name = name
        self.ci = -1                      # CPU indicator
        self.gi = -1                      # GPU indicator
        self.max_ahead = max_ahead
        self._sched_q: List[SchedulingOutput] = []
        self._input_q: List[ModelInputDescriptor] = []
        self._cv = threading.Condition()
        self._stop = False
        self._results: Dict[int, Any] = {}
        self.prep_time = 0.0
        self.exec_time = 0.0
        self.stall_time = 0.0
        self._threads: List[threading.Thread] = []

    # -- communicator API ----------------------------------------------------
    def submit(self, sched: SchedulingOutput):
        with self._cv:
            self._sched_q.append(sched)
            self._cv.notify_all()

    def result(self, iteration: int, timeout: float = 60.0) -> Any:
        deadline = time.monotonic() + timeout
        with self._cv:
            while iteration not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"{self.name}: iter {iteration}")
                self._cv.wait(remaining)
            return self._results.pop(iteration)

    # -- FSM loops -------------------------------------------------------------
    def _cpu_loop(self):
        while True:
            with self._cv:
                # W -> R when all generated inputs are consumed (CI - GI gate)
                while not self._stop and (
                    not self._sched_q or self.ci - self.gi >= self.max_ahead
                ):
                    self._cv.wait(0.05)
                if self._stop:
                    return
                sched = self._sched_q.pop(0)
                version = (self.ci + 1) & 1
            t0 = time.monotonic()
            width = sched.packed_width
            nb = (0 if sched.block_tables is None
                  else sched.block_tables.shape[1])
            bufs = self.staging.buffers(version, len(sched.seq_ids), width,
                                        nb)
            self.prepare_fn(sched, bufs)
            self.prep_time += time.monotonic() - t0
            with self._cv:
                self.ci += 1
                self._input_q.append(ModelInputDescriptor(
                    sched.iteration, version, len(sched.seq_ids),
                    sched.is_prefill, sched, width, nb))
                self._cv.notify_all()

    def _device_loop(self):
        while True:
            t_wait = time.monotonic()
            with self._cv:
                while not self._stop and not self._input_q:
                    self._cv.wait(0.05)
                if self._stop:
                    return
                desc = self._input_q.pop(0)
                self.gi += 1        # increment on entering R: frees the CPU
                self._cv.notify_all()
            self.stall_time += time.monotonic() - t_wait
            t0 = time.monotonic()
            bufs = self.staging.buffers(desc.version, desc.batch, desc.width,
                                        desc.n_blocks)
            out = self.execute_fn(desc, bufs)
            self.exec_time += time.monotonic() - t0
            with self._cv:
                self._results[desc.iteration] = out
                self._cv.notify_all()

    def start(self):
        for fn, nm in ((self._cpu_loop, "cpu"), (self._device_loop, "dev")):
            t = threading.Thread(target=fn, name=f"{self.name}-{nm}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)


class SynchronousExecutor:
    """Baseline (no TSEM): prepare-then-execute serially, like engines that
    defer input preparation until the previous forward completes."""

    def __init__(self, prepare_fn: Callable, execute_fn: Callable, name: str = "stage"):
        self.prepare_fn = prepare_fn
        self.execute_fn = execute_fn
        self.staging = VersionedStaging()
        self.name = name
        self.prep_time = 0.0
        self.exec_time = 0.0
        self.stall_time = 0.0

    def run(self, sched: SchedulingOutput) -> Any:
        width = sched.packed_width
        nb = 0 if sched.block_tables is None else sched.block_tables.shape[1]
        bufs = self.staging.buffers(0, len(sched.seq_ids), width, nb)
        t0 = time.monotonic()
        self.prepare_fn(sched, bufs)
        t1 = time.monotonic()
        out = self.execute_fn(
            ModelInputDescriptor(sched.iteration, 0, len(sched.seq_ids),
                                 sched.is_prefill, sched, width, nb), bufs)
        t2 = time.monotonic()
        self.prep_time += t1 - t0
        self.exec_time += t2 - t1
        return out
