"""The SiPipe serving engine (§4) on PyTorch: scheduler + p stage workers +
CPU sampler pool + BIC channels, running the port's model end to end.

A port of ``repro.core.engine`` over the paged KV cache and over
contiguous cache rows.  Two engines share all components:

  SiPipeEngine  — CPU column-wise sampling (decoupled from the last stage),
                  TSEM double-buffered CPU/device executors per stage, SAT
                  structure-aware stage channels.
  NaivePPEngine — the pipeline-agnostic baseline: in-stage sampling on the
                  final stage's critical path, synchronous prepare-then-
                  execute, structure-unaware stage transmission.

Every stage lives on the device the parameters live on (one card, or the
CPU for the parity tests); stages run on their own threads, and hidden
states pass between them through host arrays, as in the reference.  Every
scheduling policy runs: monolithic admission prefills whole prompts
through ``prefill_fn`` (the flash-attention kernel) and writes their K/V
into the paged cache; span policies (chunked, disaggregated, adaptive)
take ``chunk_fn`` (packed spans, the paged span-attention kernel); pure
decode iterations take ``decode_fn`` (the paged decode-attention kernel).
A model built with ``ModelOptions(kv_quant=True)`` keeps an int8 cache
and runs the int8 twins of the paged kernels.  A sliding-window model
(mixtral's MoE family) keeps a rolling cache, position p at logical slot
p % W, so a sequence holds at most W / block_size blocks and its chunks
take the rolling span kernels.  The contiguous layout
(``kv_layout="contiguous"``, and ``auto`` for a window that is not a
block multiple) gives each sequence one cache row of max_seq_len (or W)
slots from a pool of max_batch * pp rows: the stage steps read and write
the rows in place through the contiguous kernels, without block tables,
prefix caching, preemption or copy-on-write forks.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, \
    Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bic import LocalRing, SubSlotRing
from repro_torch.core.request import (
    ForkOutput,
    Request,
    RequestIdAllocator,
    RequestMetrics,
    RequestOutput,
    RequestState,
    TokenStream,
)
from repro_torch.core.sampler import ColumnWiseSampler, NaiveSampler, \
    SamplingWorker
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.core.sat import StructureAwareChannel, \
    StructureUnawareChannel
from repro_torch.core.scheduler import Scheduler, SchedulingOutput
from repro_torch.core.sequence import SeqStatus, Sequence, SequenceCache
from repro_torch.core.step_graphs import CudaGraphs, StepGraphs
from repro_torch.core.tsem import (
    BatchMetadataCache,
    ModelInputDescriptor,
    SynchronousExecutor,
    TokenSafeExecutor,
)
from repro_torch.models.registry import Model
from repro_torch.models.stacked import run_stack, tree_map
from repro_torch.runtime.paged_kv import BlockSpaceManager


# ---------------------------------------------------------------------------
# Stage splitting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PPStage:
    index: int
    n_stages: int
    groups: Tuple[int, int]              # [lo, hi) of the blocks stack
    params: Any
    prefill_fn: Callable                 # (params, x_or_tokens[B,S], pos0, last_idx[B]) -> (x|logits, cache)
    decode_fn: Callable                  # (params, cache, x_or_tokens[B], positions[B], tables, rows[B]) -> x|logits
    chunk_fn: Callable                   # (params, cache, x_or_tokens[T], positions[T], seq_idx[T], last_idx[B], tables, span_starts[B], n_valid, rows[B]) -> x|logits

    @property
    def is_first(self) -> bool:
        return self.index == 0

    @property
    def is_last(self) -> bool:
        return self.index == self.n_stages - 1

    @property
    def n_groups(self) -> int:
        return self.groups[1] - self.groups[0]


def split_for_pp(model: Model, params: Any, p: int) -> List[PPStage]:
    """Partition a decoder LM into p contiguous stages (layer groups).
    Stage parameters are views of ``params``: nothing is copied."""
    st = model.stacks["blocks"]
    if st.n < p:
        raise ValueError(f"{st.n} layer groups < {p} stages")
    bounds = [round(i * st.n / p) for i in range(p + 1)]
    stages = []
    for i in range(p):
        lo, hi = bounds[i], bounds[i + 1]
        sp: Dict[str, Any] = {
            "blocks": tree_map(lambda x: x[lo:hi], params["stacks"]["blocks"])}
        if i == 0:
            sp["embed"] = params["embed"]
        if i == p - 1:
            sp["lnf"], sp["head"] = params["lnf"], params["head"]
        stages.append(_make_stage(model, i, p, (lo, hi), sp))
    return stages


def _make_stage(model: Model, idx: int, p: int, bounds, sp) -> PPStage:
    st = model.stacks["blocks"]
    lo, hi = bounds
    sub = dataclasses.replace(st, n=hi - lo)
    first, last = idx == 0, idx == p - 1

    def prefill_fn(params, x_or_tokens, pos0, last_idx):
        """Whole-prompt prefill of a right-padded batch [B, S].
        ``last_idx`` [B]: each sequence's final real position; logits
        come from the true last token, not the pad tail (and windowed
        models fill their rolling caches by the real lengths).  Returns
        the stage output and the batch's fresh cache, leaves [groups, B,
        S, ...] ([groups, B, W, ...] for a window W)."""
        s = x_or_tokens.shape[1]
        dev = x_or_tokens.device
        positions = pos0 + torch.arange(s, dtype=torch.int32, device=dev)
        ctx = model.make_ctx("prefill", positions, seq_lens=last_idx + 1)
        x = model.embed_tokens(params, x_or_tokens) if first else x_or_tokens
        cache = model.prefill_cache(sub.n, x.shape[0], s, dev, x.dtype)
        x = run_stack(sub, params["blocks"], x, ctx, cache)
        if last:
            rows = torch.arange(x.shape[0], device=dev)
            return model.lm_head(params, x[rows, last_idx.long()]), cache
        return x, cache

    def decode_fn(params, cache, x_or_tokens, positions, tables=None,
                  rows=None):
        """Pure-decode step.  Paged: ``cache`` leaves are block-major
        [groups, n_blocks, bs, ...] and attention reads and writes through
        the [B, nb] block table ``tables``.  Contiguous (``tables`` None):
        leaves [groups, R, S, ...] and batch row b lives in cache row
        ``rows[b]`` ([B] int32).  Either way the cache changes in exactly
        the slots of this step's tokens (written in place)."""
        ctx = model.make_ctx("decode", positions, block_tables=tables,
                             rows=rows)
        x = model.embed_tokens(params, x_or_tokens) if first else x_or_tokens
        x = run_stack(sub, params["blocks"], x, ctx, cache)
        return model.lm_head(params, x) if last else x

    def chunk_fn(params, cache, x_or_tokens, positions, seq_idx, last_idx,
                 tables=None, span_starts=None, n_valid=None, rows=None):
        """Mixed chunked-prefill/decode step over the packed ragged layout:
        the batch's valid span tokens concatenated into flat [T] vectors
        (T = the power-of-two bucket; padding duplicates the last valid
        token).  ``seq_idx`` [T] maps each token to its batch row and
        ``last_idx`` [B] is the packed index of each row's final token,
        whose logits feed the sampler.  ``tables`` and ``rows`` as in
        ``decode_fn``.  Windowed models also take ``span_starts`` [B] (each
        row's span offset: the tokens already in its rolling cache);
        ``n_valid`` is the unpadded token count (an int)."""
        ctx = model.make_ctx("chunk", positions, seq_idx=seq_idx,
                             span_starts=span_starts, n_valid=n_valid,
                             block_tables=tables, rows=rows)
        x = model.embed_tokens(params, x_or_tokens) if first else x_or_tokens
        x = run_stack(sub, params["blocks"], x, ctx, cache)
        return model.lm_head(params, x[last_idx.long()]) if last else x

    return PPStage(idx, p, bounds, sp, prefill_fn, decode_fn, chunk_fn)


def _leaves(cache):
    """(layer, leaf name, tensor) of a stage cache ``{"l<i>": {...}}``."""
    return [(lk, kk, t) for lk, layer in cache.items()
            for kk, t in layer.items()]


def write_prefill(cache, fresh, tables: torch.Tensor, pad_block: int) -> None:
    """Write a prefill pass's K/V into the paged cache, in place.
    ``fresh`` leaves are [groups, B, S, ...] (``prefill_fn``'s cache; S
    is W for a rolling cache, whose slot s holds a position congruent to
    s mod W); ``cache`` leaves [groups, n_blocks + 1, bs, ...]; ``tables``
    [B, nb] int32.  The prompt is cut into blocks of bs slots scattered
    through the table; slots past a row's table (the ragged pad tail, a
    short prompt's empty window slots) land in the trash block
    ``pad_block``, as do blocks the table masks."""
    leaves = _leaves(fresh)
    b, sp = leaves[0][2].shape[1:3]
    bs = _leaves(cache)[0][2].shape[2]
    spb = -(-sp // bs)
    st = torch.full((b, spb), pad_block, dtype=torch.long,
                    device=tables.device)
    k = min(spb, tables.shape[1])
    st[:, :k] = tables[:, :k]
    for lk, kk, c_new in leaves:
        pad = spb * bs - sp
        if pad:
            c_new = torch.cat([c_new, c_new.new_zeros(
                (*c_new.shape[:2], pad, *c_new.shape[3:]))], 2)
        # [n, B, spb * bs, ...] -> [n, B, spb, bs, ...] blocks
        cache[lk][kk][:, st] = c_new.reshape(
            *c_new.shape[:2], spb, bs, *c_new.shape[3:])


def write_prefill_rows(cache, fresh, rows: torch.Tensor) -> None:
    """Write a prefill pass's K/V into contiguous cache rows, in place
    (the reference's ``c_all.at[:, rows, :sp].set(c_new)``): ``fresh``
    leaves [groups, B, Sp, ...] (``prefill_fn``'s cache; Sp = W for a
    rolling row), ``cache`` leaves [groups, R, S, ...], ``rows`` [B]."""
    r = rows.long()
    for lk, kk, c_new in _leaves(fresh):
        cache[lk][kk][:, r, :c_new.shape[2]] = c_new


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    pp_degree: int = 2
    max_batch: int = 4              # per microbatch
    max_seq_len: int = 128
    n_samplers: int = 2
    cpu_sampling: bool = True       # False -> in-stage sampling (baseline)
    tsem: bool = True               # False -> synchronous prepare+execute
    sat: bool = True                # False -> structure-unaware transmission
    channel_round_latency_s: float = 0.0   # inject per-round cost for benches
    # per-iteration token budget for span scheduling policies (None =
    # monolithic whole-prompt prefill, the seed behavior)
    prefill_chunk_tokens: Optional[int] = None
    # scheduling policy: "auto" (budget -> chunked, else monolithic),
    # "monolithic", "chunked", "disaggregated" (TD-Pipe-style phase
    # scheduling), or "adaptive" (TPOT-SLO adaptive budget); see
    # docs/scheduling.md §Scheduling policies
    scheduling_policy: str = "auto"
    # disaggregated decode->prefill switch threshold in pending prefill
    # tokens per paused decode slot (None = the token budget)
    phase_hysteresis_tokens: Optional[int] = None
    # adaptive policy: target mean inter-token latency (None = the policy
    # self-calibrates from the first observed window)
    tpot_slo_s: Optional[float] = None
    # hybrid serving (docs/hybrid.md): in the disaggregated policy's
    # DECODE phase, offline-tier decodes may enlarge the batch beyond
    # max_batch up to max_batch * factor, but only at pow2 rungs (2x, 4x,
    # ...) so each rung is exactly one extra stage-step shape (an XLA
    # compile in the reference, a CUDA graph once the port captures them)
    # — the same discipline max_table_buckets applies to block-table
    # widths.  1
    # (default) disables enlargement; > 1 requires the disaggregated
    # policy.
    decode_enlarge_factor: int = 1
    # bound on retained per-request latency records (the window online
    # metrics percentiles are computed over)
    keep_recent_requests: int = 2048
    # ---- KV memory substrate (docs/memory.md) ----------------------------
    # "paged": vLLM-style block tables over a [n_blocks, block_size, ...]
    # physical cache; admission is block-budget accounting, decode growth
    # under pressure preempts (and later recomputes) the lowest-priority
    # sequence.  Attention runs through the block table.  "contiguous":
    # one dense [max_seq_len] (or [W]) cache row per sequence from a pool
    # of max_batch * pp rows.  "auto" resolves to paged, or to contiguous
    # for a window that is not a multiple of kv_block_size.
    kv_layout: str = "auto"
    kv_block_size: int = 16
    # total physical blocks (None = the same slot budget contiguous rows
    # would reserve: max_batch * pp * max_seq_len / block_size)
    kv_blocks: Optional[int] = None
    # cap on distinct padded block-table widths padded_tables may emit
    # (each width is one stage-step shape — see BlockSpaceManager's
    # ladder); None = unbounded pow2 widths
    max_table_buckets: Optional[int] = 2
    # hash-based prompt-prefix caching (paged layout, non-rolling caches
    # only — silently off otherwise): new requests whose leading full
    # prompt blocks hash-match cached blocks share them by refcount and
    # prefill only the unshared tail; see docs/memory.md "Prefix caching
    # & CoW forks"
    enable_prefix_caching: bool = True
    # sample iteration n on a host-side worker thread while the device
    # runs n+1 (SiPipe: sampling off the critical path); token streams
    # are identical to synchronous sampling (single FIFO worker + the
    # per-slot autoregressive gate)
    overlap_sampling: bool = True
    seed: int = 0
    # decode steps captured once per shape as CUDA graphs and replayed
    # (core/step_graphs.py; the reference's jit-compiled stage step).
    # None: on for a CUDA device, off for the CPU; True on the CPU raises.
    # False runs every step eagerly, op by op
    cuda_graphs: Optional[bool] = None


@dataclasses.dataclass
class StageMetrics:
    busy: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    prep_s: float = 0.0
    exec_s: float = 0.0
    sample_s: float = 0.0



class _StageWorker:
    """One pipeline stage: communicator + CPU executor + device executor."""

    def __init__(self, stage: PPStage, engine: "PPEngineBase"):
        self.stage = stage
        self.engine = engine
        self.metrics = StageMetrics()
        cfg = engine.cfg
        if engine.paged:
            # physical cache [groups, n_blocks + 1, block_size, ...] per
            # leaf: logical slot p of a sequence lives at
            # (block_table[p // bs], p % bs); the extra final block is the
            # trash block padded table entries point at (writes discarded,
            # reads position-masked)
            self.cache = engine.model.paged_cache(
                stage.n_groups, engine.kv_manager.n_blocks + 1,
                cfg.kv_block_size, device=engine.device, dtype=engine.dtype)
        else:
            # contiguous rows [groups, max_batch * pp, S, ...] per leaf
            self.cache = engine.model.row_cache(
                stage.n_groups, cfg.max_batch * cfg.pp_degree,
                cfg.max_seq_len, device=engine.device, dtype=engine.dtype)
        self.meta_cache = BatchMetadataCache(cfg.pp_degree)
        self.graphs = (StepGraphs(CudaGraphs(engine.device))
                       if cfg.cuda_graphs else None)
        ch = StructureAwareChannel if cfg.sat else StructureUnawareChannel
        self.out_channel = ch(cfg.channel_round_latency_s) if not stage.is_last else None
        # device step used by the executor
        if cfg.tsem:
            self.executor = TokenSafeExecutor(self._prepare, self._execute,
                                              name=f"stage{stage.index}")
            self.executor.start()
        else:
            self.executor = SynchronousExecutor(self._prepare, self._execute,
                                                name=f"stage{stage.index}")

    # -- CPU executor side ---------------------------------------------------
    def _prepare(self, sched: SchedulingOutput, bufs: Dict[str, np.ndarray]):
        eng = self.engine
        if eng.paged:
            # placement is the scheduler's block-table snapshot; rows are
            # meaningless (the batch dim is positional) and the dirty-slot
            # write-back mapping is derived in the stage from the table +
            # positions — nothing else to stage
            rows = np.zeros(len(sched.seq_ids), np.int32)
        else:
            rows = np.array([eng.seq_cache.lookup(s).cache_row
                             for s in sched.seq_ids], np.int32)
        meta = self.meta_cache.update(sched, rows)
        np.copyto(bufs["tokens"], meta.tokens)
        np.copyto(bufs["positions"], meta.positions)
        np.copyto(bufs["rows"], meta.rows)
        if meta.n_blocks:
            np.copyto(bufs["block_tables"], meta.block_tables)
        if meta.width > 1:
            np.copyto(bufs["pack_tokens"], meta.pack_tokens)
            np.copyto(bufs["pack_positions"], meta.pack_positions)
            np.copyto(bufs["pack_seq"], meta.pack_seq)
            np.copyto(bufs["last_index"], meta.last_index)
            bufs["n_valid"][0] = meta.n_valid
        # SAT: pre-post this stage's incoming receive while the producer is
        # still in its forward — the leading dim (packed bucket or batch
        # size) is known from the scheduling output alone (§5.3)
        if not self.stage.is_first:
            ch = self.engine.stages[self.stage.index - 1].out_channel
            if isinstance(ch, StructureAwareChannel):
                ch.post_recv(meta.width if meta.width > 1
                             else len(sched.seq_ids))

    # -- device executor side -----------------------------------------------
    def apply_copies(self, copies: np.ndarray):
        """Apply queued CoW block copies [K, 2] (src, dst) to this stage's
        physical cache.  Runs on the stage's device thread immediately
        before the iteration that drained them: per-stage FIFO puts it
        after every in-flight write to ``src`` (shared blocks are never
        written, so src content is stable) and before any reader of
        ``dst``."""
        src = self._dev(copies[:, 0]).long()
        dst = self._dev(copies[:, 1]).long()
        for _, _, leaf in _leaves(self.cache):
            leaf[:, dst] = leaf[:, src]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a staged host buffer (TSEM reuses the
        buffer for a later iteration, so it is never aliased)."""
        return torch.tensor(a, device=self.engine.device)

    def _execute(self, desc: ModelInputDescriptor, bufs: Dict[str, np.ndarray]):
        t0 = time.monotonic()
        stage, eng = self.stage, self.engine
        if desc.sched.block_copies is not None:
            self.apply_copies(desc.sched.block_copies)
        if desc.width == 1 and self.graphs is not None:
            out = self._graph_decode(desc, bufs)
        else:
            out = self._eager_step(desc, bufs)
        self.metrics.busy.append((t0, time.monotonic()))
        if stage.is_last:
            eng.emit_logits(desc, out)
        else:
            eng.send_hidden(stage.index, desc.iteration, out)
        return True

    def _graph_decode(self, desc: ModelInputDescriptor,
                      bufs: Dict[str, np.ndarray]) -> np.ndarray:
        """A decode step through the stage's graphs, keyed by (B, nb)
        paged and (B,) over rows, as the reference's ``decode_fn``
        compiles.  The staged host buffers and the hidden state received
        from the previous stage (host fp32, as in the reference) are
        copied into the graph's statics."""
        stage, eng = self.stage, self.engine
        inputs = {"x": (bufs["tokens"] if stage.is_first
                        else eng.recv_hidden(stage.index, desc.iteration)),
                  "positions": bufs["positions"]}
        if eng.paged:
            inputs["tables"] = bufs["block_tables"]
            key = (desc.batch, desc.n_blocks)
        else:
            inputs["rows"] = bufs["rows"]
            key = (desc.batch,)
        return self.graphs.run(key, inputs, self._decode_step)

    def _decode_step(self, x, positions, tables=None, rows=None):
        """The captured decode step: the stage's ``decode_fn`` on device
        inputs, its output in fp32 (the host hand-off's type)."""
        stage = self.stage
        if not stage.is_first:
            x = x.to(self.engine.dtype)
        return stage.decode_fn(stage.params, self.cache, x, positions,
                               tables=tables, rows=rows).float()

    def _eager_step(self, desc: ModelInputDescriptor,
                    bufs: Dict[str, np.ndarray]) -> np.ndarray:
        """A chunk step, or a decode step without graphs, op by op."""
        stage, eng = self.stage, self.engine
        x_in = (self._dev(bufs["pack_tokens"] if desc.width > 1
                          else bufs["tokens"]) if stage.is_first
                else torch.tensor(eng.recv_hidden(stage.index,
                                                  desc.iteration),
                                  dtype=eng.dtype, device=eng.device))
        # paged-native path: the physical block-major cache and the
        # [B, nb] table go straight into the stage — attention reads K/V
        # through the table (the paged CUDA kernels; no gathered
        # [B, nb * bs] view).  Contiguous rows: the whole [R, S] cache and
        # the batch's rows, read by the contiguous kernels in place where
        # the reference gathers and scatters the rows around the step.
        # Either way only the slots this iteration's tokens dirtied are
        # written, in place
        if eng.paged:
            place = {"tables": self._dev(bufs["block_tables"])}
        else:
            place = {"rows": self._dev(bufs["rows"])}
        if desc.width > 1:
            out = stage.chunk_fn(
                stage.params, self.cache, x_in,
                self._dev(bufs["pack_positions"]),
                self._dev(bufs["pack_seq"]),
                self._dev(bufs["last_index"]),
                span_starts=self._dev(bufs["positions"]),
                n_valid=int(bufs["n_valid"][0]), **place)
        else:
            out = stage.decode_fn(stage.params, self.cache, x_in,
                                  self._dev(bufs["positions"]), **place)
        return out.float().cpu().numpy()          # waits for the device

    def run_prefill(self, x_or_tokens: torch.Tensor, pos0: int,
                    last_idx: np.ndarray, place: np.ndarray) -> np.ndarray:
        """Pipeline prefill pass for newly admitted sequences: runs the
        stage on the right-padded batch and writes the prompts' K/V into
        the cache in place.  Paged: block by block through ``place``, the
        tables [B, nb] from ``padded_tables(mask_shared=True)``; slots past
        a row's table (the ragged pad tail) and blocks shared through a
        prefix hit land in the trash block.  Contiguous: into the cache
        rows ``place`` [B], slots [0, S_prompt) (a rolling row: all W)."""
        stage, eng = self.stage, self.engine
        t0 = time.monotonic()
        out, cache = stage.prefill_fn(stage.params, x_or_tokens, pos0,
                                      self._dev(last_idx))
        if eng.paged:
            write_prefill(self.cache, cache, self._dev(place),
                          eng.kv_manager.pad_block)
        else:
            write_prefill_rows(self.cache, cache, self._dev(place))
        out = out.float().cpu().numpy()          # waits for the device
        self.metrics.busy.append((t0, time.monotonic()))
        return out

    def stop(self):
        if isinstance(self.executor, TokenSafeExecutor):
            self.executor.stop()
        self.metrics.prep_s = self.executor.prep_time
        self.metrics.exec_s = self.executor.exec_time


class PPEngineBase:
    """Shared orchestration for both engines."""

    def __init__(self, model: Model, params, cfg: EngineConfig):
        self.model = model
        self.arch: ArchConfig = model.cfg
        # the engine runs where the parameters live (one card, or the CPU)
        # and in their dtype (bf16; fp32 serves parity runs on the CPU)
        self.device = params["embed"].device
        self.dtype = params["embed"].dtype
        if cfg.kv_layout not in ("auto", "contiguous", "paged"):
            raise ValueError(
                f"unknown kv_layout {cfg.kv_layout!r}; choose from "
                "('auto', 'contiguous', 'paged')")
        if self.arch.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {self.arch.family!r} runs through the model API "
                "(build_model(cfg).prefill / .decode); the reference's "
                "engine does not serve it, and this one serves the dense "
                "and moe families")
        if cfg.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, "
                             f"got {cfg.kv_block_size}")
        window = self.arch.window or None
        if cfg.cuda_graphs is None:
            cfg = dataclasses.replace(
                cfg, cuda_graphs=self.device.type == "cuda")
        elif cfg.cuda_graphs and self.device.type != "cuda":
            raise ValueError(
                f"cuda_graphs=True needs the parameters on a CUDA device, "
                f"not {self.device}")
        if cfg.kv_layout == "auto":
            # paged, except that rolling caches need whole-block windows:
            # the reference falls back to contiguous rows there (explicit
            # kv_layout='paged' raises in BlockSpaceManager instead)
            cfg = dataclasses.replace(cfg, kv_layout="contiguous" if (
                window and window % cfg.kv_block_size) else "paged")
        self.cfg = cfg
        self.paged = cfg.kv_layout == "paged"
        self.kv_manager = None
        if self.paged:
            n_blocks = cfg.kv_blocks
            if n_blocks is None:
                # equal budget to contiguous rows: rows x the blocks ONE
                # worst-case sequence needs (a window's worth for rolling
                # caches)
                n_blocks = (cfg.max_batch * cfg.pp_degree *
                            -(-(window or cfg.max_seq_len)
                              // cfg.kv_block_size))
            self.kv_manager = BlockSpaceManager(
                n_blocks, cfg.kv_block_size, slot_cap=window,
                max_slots=cfg.max_seq_len,
                max_table_buckets=cfg.max_table_buckets,
                # rolling caches index slots by pos % window, so a block's
                # content is position-dependent: not shareable
                prefix_cache=cfg.enable_prefix_caching and window is None)
            if n_blocks < self.kv_manager.blocks_for(cfg.max_seq_len):
                raise ValueError(
                    f"kv_blocks={n_blocks} x block_size={cfg.kv_block_size}"
                    " cannot hold even one max_seq_len sequence — "
                    "preemption could never free enough")
        # the id allocator doubles as the scheduler's fork-child id source
        # (SamplingParams.n > 1): child seq ids draw from the same
        # monotonic space as request ids, so they can never collide with
        # a future request's worker-side state
        self._alloc = RequestIdAllocator()
        if cfg.decode_enlarge_factor > 1 and not self.paged:
            # enlargement admits offline members beyond max_batch whose
            # eviction must free KV capacity on demand — only the paged
            # layout's preemption-by-recompute supports that (contiguous
            # SequenceCache rows leak on drop_entry)
            raise ValueError(
                "decode_enlarge_factor > 1 requires the paged KV layout")
        self.scheduler = Scheduler(max_batch=cfg.max_batch, pp_degree=cfg.pp_degree,
                                   max_seq_len=cfg.max_seq_len,
                                   token_budget=cfg.prefill_chunk_tokens,
                                   policy=cfg.scheduling_policy,
                                   hysteresis_tokens=cfg.phase_hysteresis_tokens,
                                   tpot_slo_s=cfg.tpot_slo_s,
                                   kv_manager=self.kv_manager,
                                   decode_enlarge_factor=cfg.decode_enlarge_factor,
                                   seq_id_fn=self._alloc.next)
        if self.scheduler.chunked and window and \
                self.scheduler.token_budget > window:
            # rolling caches scatter one slot per span token (slot = pos %
            # W): a chunk wider than the window would write conflicting
            # values into one slot, so the budget must fit the window
            raise ValueError(
                f"prefill_chunk_tokens budget {self.scheduler.token_budget} "
                f"exceeds the sliding window {window}; chunks must fit the "
                "rolling KV cache")
        self.seq_cache = SequenceCache(cfg.max_batch * cfg.pp_degree,
                                       kv=self.kv_manager)
        self.stages = [_StageWorker(s, self)
                       for s in split_for_pp(model, params, cfg.pp_degree)]
        self.bic_i = LocalRing(max(8, 2 * cfg.pp_degree), "BIC-I")
        self.bic_o = SubSlotRing(cfg.n_samplers, max(8, 2 * cfg.pp_degree))
        self._hidden: Dict[Tuple[int, int], Any] = {}
        self._hcv = threading.Condition()
        self._logits: Dict[int, np.ndarray] = {}
        self.samplers = [
            ColumnWiseSampler(self.arch.vocab_size, cfg.max_batch,
                              pp_degree=cfg.pp_degree,
                              max_len=cfg.max_seq_len, seed=cfg.seed + i)
            if cfg.cpu_sampling else
            NaiveSampler(self.arch.vocab_size, seed=cfg.seed + i)
            for i in range(cfg.n_samplers)
        ]
        self.sample_time = 0.0
        # SiPipe overlapped CPU sampling: the last stage hands logits to
        # this FIFO worker and launches the next iteration immediately;
        # the worker mutates sampler state in submission (= iteration)
        # order, so streams are token-identical to synchronous sampling
        self.sampling_worker = (SamplingWorker(self._dispatch_sampling)
                                if cfg.overlap_sampling else None)
        # completion times of iterations still (possibly) being awaited;
        # pruned each step once older than every in-flight iteration —
        # the running max survives in _t_last_done (long-run memory bound)
        self.iter_done_t: Dict[int, float] = {}
        self._t_last_done = 0.0
        self.t_start = 0.0
        # -- continuous-serving request layer (docs/serving.md) ------------
        self.requests: Dict[int, Request] = {}        # active only
        self._request_stats: Deque[RequestMetrics] = deque(
            maxlen=cfg.keep_recent_requests)
        self._n_submitted = 0
        self._n_finished = 0
        self._n_aborted = 0
        self._tokens_finished = 0
        # step-driven loop state (run() is a thin wrapper over step())
        self._it = 0
        self._inflight: List[SchedulingOutput] = []
        # aborted-but-in-flight sequences: KV rows / sampler columns are
        # reclaimed only after every referencing iteration has retired
        self._pending_release: set = set()
        self._stopped = False

    # -- inter-stage hidden-state transport ------------------------------------
    def send_hidden(self, from_stage: int, iteration: int, h: np.ndarray):
        ch = self.stages[from_stage].out_channel
        ch.send({"hidden": h})
        with self._hcv:
            self._hidden[(from_stage + 1, iteration)] = ch
            self._hcv.notify_all()

    def recv_hidden(self, stage: int, iteration: int) -> np.ndarray:
        """The previous stage's output for ``iteration``, host fp32."""
        deadline = time.monotonic() + 60
        with self._hcv:
            while (stage, iteration) not in self._hidden:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"hidden for stage {stage} iter {iteration}")
                self._hcv.wait(1.0)
            ch = self._hidden.pop((stage, iteration))
        return ch.recv()["hidden"]

    # -- sampling ----------------------------------------------------------------
    def emit_logits(self, desc: ModelInputDescriptor, logits: np.ndarray):
        """Final stage output; SiPipe ships via BIC-L to the sampler pool.
        With overlapped sampling the hand-off is a queue put — the last
        stage's device thread goes straight to its next microbatch while
        the sampling worker processes this one (intra-stage bubble
        closed); otherwise sampling runs inline on this thread."""
        if self.sampling_worker is not None:
            self.sampling_worker.submit(desc.sched, logits)
        else:
            self._dispatch_sampling(desc.sched, logits)

    def _dispatch_sampling(self, sched: SchedulingOutput, logits: np.ndarray):
        t0 = time.monotonic()
        # drop in-progress prefill columns up front: their samples would be
        # discarded anyway, and vocab-wide sampling is the expensive part
        eligible = sched.sample_indices()
        if len(eligible) != logits.shape[0]:
            logits = logits[eligible]
        if logits.shape[0] == 0:       # nothing to sample this iteration
            self._on_sampled(sched, np.zeros(0, np.int32))
            return
        eligible_ids = [sched.seq_ids[i] for i in eligible]
        # per-request sampling params are an API contract: each column
        # samples with ITS OWN request's params, even in mixed batches
        # (the pre-redesign engine applied seq_ids[0]'s params batch-wide)
        params = [self.scheduler.seqs[sid].params for sid in eligible_ids]
        out = self._pool_sample(sched.iteration, sched.slot, eligible_ids,
                                logits, params)
        self.sample_time += time.monotonic() - t0
        self._on_sampled(sched, out)

    def _pool_sample(self, iteration: int, slot: int, seq_ids: List[int],
                     logits: np.ndarray,
                     params: List[SamplingParams]) -> np.ndarray:
        """Fan a batch's logits out over the sampler pool.

        ``params`` is per-sequence, aligned with ``seq_ids``; each pool
        member receives the param slice of its own columns.  Columns are
        partitioned by ``seq_id % n_samplers`` — a pure function of the
        sequence, not its batch column — so a sequence's incremental
        penalty state (freq/pres/output history) always lives in the same
        sampler instance, surviving batch recomposition and
        chunked-prefill phase changes (the per-sequence carryover in
        ColumnWiseSampler._replica is per instance).
        """
        k = self.cfg.n_samplers
        b = logits.shape[0]

        def run(j):
            cols = np.array([i for i, sid in enumerate(seq_ids)
                             if sid % k == j], np.int64)
            if cols.size:
                ids = self.samplers[j].sample(
                    logits[cols], [params[c] for c in cols], slot=slot,
                    seq_ids=[seq_ids[c] for c in cols])
            else:
                ids = np.zeros(0, np.int32)
            self.bic_o.put(iteration, j, (cols, ids))

        threads = [threading.Thread(target=run, args=(j,)) for j in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out = np.zeros(b, np.int32)
        for cols, ids in self.bic_o.get(iteration):
            out[cols] = ids
        return out

    def _on_sampled(self, sched: SchedulingOutput, token_ids: np.ndarray):
        now = time.monotonic()
        # chunked prefill: only sequences whose span reached a sampling
        # point (decode steps + prompt-completing chunks) take a token;
        # ``token_ids`` is already aligned to sample_indices()
        sampled_ids = [sched.seq_ids[i] for i in sched.sample_indices()]
        epochs = ([sched.epochs[i] for i in sched.sample_indices()]
                  if sched.epochs is not None else None)
        finished = self.scheduler.complete(
            sched.iteration, sampled_ids, token_ids, epochs)
        for sid in finished:
            self.seq_cache.release(sid)
        # batch recomposition (finishes, chunk phases) needs no sampler
        # eviction: ColumnWiseSampler carries per-sequence penalty columns
        # across replica rebuilds, keyed by seq id (§5.1 + chunked prefill)
        for sid in sampled_ids:
            if sid not in finished:
                self.seq_cache.advance(sid)
        # publish completion LAST: _await_iteration releases the driver to
        # schedule n+p, which must see this iteration's sequence updates
        self.iter_done_t[sched.iteration] = now

    # -- public API ------------------------------------------------------------
    def add_request(self, prompt_ids: List[int], params: SamplingParams,
                    arrival_t: Optional[float] = None) -> int:
        """Admit a request; returns its monotonic request id.  Callable at
        any point of the serving loop — between ``step()`` calls new
        arrivals join the waiting queue and are scheduled continuously.

        ``arrival_t`` (time.monotonic clock) backdates the request's
        arrival for latency accounting — trace replays pass the nominal
        arrival time so TTFT/queue-delay include time spent waiting
        outside the engine (e.g. behind a long blocking step)."""
        if params.n < 1:
            raise ValueError(f"SamplingParams.n must be >= 1, got {params.n}")
        if params.n > 1 and not self.paged:
            raise ValueError(
                "SamplingParams.n > 1 (parallel sampling) forks the prompt "
                "KV copy-on-write, which requires kv_layout='paged'")
        if params.tier == "offline" and not self.paged:
            # offline sequences are preempted-by-recompute the moment
            # online traffic needs their seats; contiguous SequenceCache
            # rows have no recompute path (drop_entry leaks the row)
            raise ValueError(
                "tier='offline' (hybrid serving, docs/hybrid.md) relies on "
                "preemption-by-recompute, which requires kv_layout='paged'")
        rid = self._alloc.next()
        seq = Sequence(rid, list(prompt_ids), params,
                       arrival_t=arrival_t or 0.0)
        self.scheduler.add_request(seq)      # validates; may raise
        self.requests[rid] = Request(rid, seq)
        self._n_submitted += 1
        return rid

    def abort(self, request_id: int, fork: Optional[int] = None) -> bool:
        """Cancel a request.  QUEUED requests are dropped immediately;
        RUNNING ones stop decoding at once (in-flight iterations discard
        their sampled column) and their KV row + sampler penalty columns
        are reclaimed as soon as the last referencing iteration retires —
        surviving sequences' tokens are never perturbed.  The final
        ABORTED RequestOutput (with any tokens produced so far) is
        delivered by the next ``step()``.  Returns False when the id is
        unknown or already finished.

        With parallel sampling the abort covers the primary AND every
        fork child; ``fork=i`` (1-based completion index) instead aborts
        only that one fork — its refcounted blocks are released (shared
        ones by refcount decrement only) while siblings keep decoding
        undisturbed."""
        req = self.requests.get(request_id)
        if req is None:
            return False
        if fork is not None:
            if fork < 1 or fork > len(req.forks):
                return False
            targets = [req.forks[fork - 1]]
        else:
            targets = list(req.all_seqs)
            # children spawned by the scheduler (first token landed) but
            # not yet adopted by _attach_forks live only in scheduler
            # state — an abort in that window must cover them too, or
            # they keep decoding as orphans holding blocks the request
            # believes it released (tests/test_http.py regression)
            known = {s.seq_id for s in targets}
            for child in self.scheduler.fork_children_of(request_id):
                if child.seq_id not in known:
                    targets.append(child)
        any_aborted = False
        for seq in targets:
            if self.scheduler.abort(seq.seq_id) is None:
                continue      # already finished (or never entered: a
            any_aborted = True  # finished-at-spawn fork child)
            sid = seq.seq_id
            if any(sid in d.seq_ids for d in self._inflight):
                self._pending_release.add(sid)
            else:
                self._release_worker_state(sid)
        self._reap_aborted()
        return any_aborted

    @property
    def has_work(self) -> bool:
        """True while any request is queued, scheduled, in flight, or has
        a final output not yet delivered by ``step()`` (e.g. a request
        aborted straight out of the queue)."""
        return (self.scheduler.has_work or bool(self._inflight)
                or bool(self._pending_release) or bool(self.requests))

    def _drop_sampler_state(self, sid: int):
        for smp in self.samplers:
            drop = getattr(smp, "drop_seq", None)
            if drop is not None:
                drop(sid)

    def _release_worker_state(self, sid: int):
        """Reclaim worker-side resources of a retired sequence: the KV
        cache row and every sampler's penalty columns."""
        self.seq_cache.release(sid)
        self._drop_sampler_state(sid)

    def _reap_preempted(self):
        """Drop the worker-side handles of sequences the scheduler just
        preempted (paged layout).  Their blocks are already back on the
        free list; in-flight iterations still referencing them stage
        all-trash tables and their sampled tokens are discarded.  Sampler
        penalty state is deliberately KEPT — the sequence resumes under
        the same id and its recomputed tokens continue the same stream
        (see docs/memory.md for the penalties caveat)."""
        for sid in self.scheduler.drain_preempted():
            self.seq_cache.drop_entry(sid)

    def _reap_aborted(self):
        """Release aborted sequences no longer referenced by any
        in-flight iteration."""
        if not self._pending_release:
            return
        live: set = set()
        for d in self._inflight:
            live.update(d.seq_ids)
        for sid in [s for s in self._pending_release if s not in live]:
            self._release_worker_state(sid)
            self._pending_release.discard(sid)


    def _admit_and_prefill(self, sched: SchedulingOutput):
        """Prefill newly admitted sequences through all stages."""
        if sched.block_copies is not None:
            # CoW copies ride the admitting sched; the monolithic path
            # drained every in-flight iteration before this call, so the
            # inline application cannot race the device threads
            for w in self.stages:
                w.apply_copies(sched.block_copies)
        # fork children skip the prefill pass entirely: their prompt KV
        # already lives in the shared blocks (the lazy seq-cache admission
        # in step() registers their worker-side handles)
        new = [sid for sid in sched.seq_ids
               if self.seq_cache.lookup(sid) is None
               and not self.scheduler.seqs[sid].forked]
        if not new:
            return
        seqs = [self.scheduler.seqs[s] for s in new]
        rows = np.array([self.seq_cache.admit(s.seq_id,
                                              len(s.prompt_ids)).cache_row
                         for s in seqs], np.int32)
        # mask_shared: the monolithic prefill recomputes the WHOLE prompt
        # (prefill_fn cannot resume mid-prompt from cache), so a
        # prefix-cache hit's shared blocks — and any fork-shared block —
        # are write-masked to the trash block; the recomputed values are
        # identical to the cached ones, only the write is suppressed
        place = (self.kv_manager.padded_tables(new, mask_shared=True)
                 if self.paged else rows)
        max_len = max(s.length for s in seqs)
        toks = np.zeros((len(seqs), max_len), np.int32)
        for i, s in enumerate(seqs):
            ids = s.prompt_ids + s.output_ids
            toks[i, :len(ids)] = ids  # right-pad (positions mask the tail)
        last_idx = np.array([s.length - 1 for s in seqs], np.int32)
        x = torch.tensor(toks, device=self.device)
        for w in self.stages:
            x_np = w.run_prefill(x, 0, last_idx, place)
            if not w.stage.is_last:
                # inter-stage hidden, in the stages' dtype
                x = torch.tensor(x_np, dtype=self.dtype, device=self.device)
        # last stage output = logits at each sequence's final position;
        # sample through the pool partition so each sequence's penalty
        # state starts in (and stays with) its own sampler instance
        ids = self._pool_sample(sched.iteration, sched.slot, new, x_np,
                                [s.params for s in seqs])
        # same-thread with the admitting schedule call: epochs are current
        finished = self.scheduler.complete(
            sched.iteration, new, ids,
            [s.preemptions for s in seqs] if self.paged else None)
        for sid in finished:
            self.seq_cache.release(sid)
        for sid in new:
            if sid not in finished:
                self.seq_cache.advance(sid)

    def step(self) -> List[RequestOutput]:
        """One scheduler iteration: gate, schedule, submit, retire.

        Re-entrant core of the serving loop — callers interleave
        ``add_request``/``abort`` with ``step()`` and receive the
        incremental :class:`RequestOutput` stream of every request that
        progressed (new tokens, finishes, aborts).  The iteration logic
        is policy-agnostic thanks to the span interface: monolithic
        admission (``is_prefill``) drains in-flight iterations and runs
        the pipeline-blocking prefill; span policies admit KV rows lazily
        on a sequence's first chunk.  Disaggregated phase boundaries need
        no special casing: prefill phases emit chunk-only spans at the
        full token budget, decode phases emit pure 1-token spans
        (``max_span == 1``) that take the flat ``decode_fn`` path and
        TSEM's incremental n/n+p metadata fast path; a slot with no
        schedulable work in the current phase yields ``sched is None``
        and simply idles.
        """
        if self._stopped:
            raise RuntimeError("engine is shut down; build a new one")
        if self.t_start == 0.0:
            self.t_start = time.monotonic()
        it = self._it
        inflight = self._inflight
        # opportunistically retire chunk-only iterations that already
        # completed: they carry no sampling to gate on, and an abort can
        # orphan them (a mid-prefill sequence that will never reach its
        # sampling chunk) — without this they'd pin the in-flight list
        # (and their members' KV rows) until full drain
        for d in [d for d in inflight
                  if not d.sample_indices() and d.iteration in self.iter_done_t]:
            inflight.remove(d)
        # autoregressive gate: this slot's prior SAMPLING iterations
        # must land before building its next batch (their tokens and
        # finishes feed the spans); chunk-only iterations (empty
        # sample set — the body of a disaggregated prefill phase)
        # don't gate, so phase chunks stream through the pipeline
        # back-to-back like training microbatches
        for d in [d for d in inflight
                  if d.slot == it % self.cfg.pp_degree
                  and d.sample_indices()]:
            self._await_iteration(d)
            inflight.remove(d)
        sched = self.scheduler.schedule(it)
        self._reap_preempted()
        while sched is not None and sched.is_prefill:
            # monolithic path (chunking off): drain in-flight iterations
            # first — run_prefill writes stage caches on this thread and
            # must not race the device threads' cache writes.  Loop: the
            # rebuild may admit again (capacity freed by finishes during
            # the prefill).
            while inflight:
                self._await_iteration(inflight.pop(0))
            self._admit_and_prefill(sched)
            sched = self.scheduler.schedule(it)  # rebuilt after prefill
            self._reap_preempted()
        if sched is not None:
            # span policies admit KV rows lazily, on first chunk.  An
            # admission may need the row of a just-aborted sequence
            # whose release is still deferred behind in-flight
            # iterations — retire those first (oldest-first) until the
            # reap frees a row; the KV pool has exactly max_batch * p
            # rows, so scheduler admission implies one will free
            self._reap_aborted()
            for sid in sched.seq_ids:
                if self.seq_cache.lookup(sid) is None:
                    while (self.seq_cache.free_rows == 0
                            and self._pending_release and inflight):
                        self._await_iteration(inflight.pop(0))
                        self._reap_aborted()
                    self.seq_cache.admit(
                        sid, self.scheduler.seqs[sid].prompt_len)
            self.bic_i.put(sched)
            self._submit(sched)
            inflight.append(sched)
        # retire in order once the pipeline depth is reached; a
        # chunk-only head (no sampled columns) streams instead of
        # gating, bounded at 4p so the executor queues stay shallow.
        # Streaming holds even when THIS slot yielded no work (a
        # prefill phase routinely idles decode-deferred slots): a
        # chunk-only iteration in flight implies a mid-prefill slot
        # member, so its slot keeps producing output and the loop
        # cannot spin — only sampling heads must gate on completion
        while len(inflight) >= (self.cfg.pp_degree if sched is not None else 1):
            if (inflight[0].spans
                    and not inflight[0].sample_indices()
                    and len(inflight) < 4 * self.cfg.pp_degree):
                break
            done = inflight.pop(0)
            self._await_iteration(done)
        self._reap_aborted()
        # prune completion stamps of fully retired iterations (nothing can
        # await them anymore); keep the running max for metrics' wall time
        if self.iter_done_t:
            floor = min((d.iteration for d in inflight), default=it + 1)
            # snapshot keys first: device threads insert stamps concurrently
            for k in [k for k in list(self.iter_done_t) if k < floor]:
                self._t_last_done = max(self._t_last_done,
                                        self.iter_done_t.pop(k))
        self._it = it + 1
        return self._drain_outputs()

    def _attach_forks(self):
        """Adopt the fork children the scheduler spawned since the last
        step into their parent requests (per-fork output streams)."""
        for child in self.scheduler.drain_spawned_forks():
            req = self.requests.get(child.fork_parent)
            if req is None:
                # parent request already retired — defensive: abort the
                # orphan and reclaim whatever it holds
                if child.status not in (SeqStatus.FINISHED,
                                        SeqStatus.ABORTED):
                    self.scheduler.abort(child.seq_id)
                self._release_worker_state(child.seq_id)
                continue
            req.forks.append(child)
            req.fork_streamed.append(0)

    def _drain_outputs(self) -> List[RequestOutput]:
        """Emit the incremental output of every request that progressed;
        retire requests whose final increment is being delivered."""
        self._attach_forks()
        outs: List[RequestOutput] = []
        for rid in list(self.requests):
            req = self.requests[rid]
            seq = req.seq
            status = seq.status
            primary_done = status in (SeqStatus.FINISHED, SeqStatus.ABORTED)
            # the request closes when the primary AND every fork are done
            # — and, for n > 1, only once the spawned children have been
            # attached (the spawn happens with the primary's first token;
            # a pre-first-token abort legitimately closes fork-less)
            if primary_done and seq.forks_spawned \
                    and len(req.forks) < seq.params.n - 1:
                closed = False           # spawned, not yet drained
            else:
                closed = primary_done and all(
                    f.status in (SeqStatus.FINISHED, SeqStatus.ABORTED)
                    for f in req.forks)
            if closed and any(s.seq_id in self._pending_release
                              for s in req.all_seqs):
                continue     # aborted but still in flight; emit post-reap
            n = len(seq.output_ids)
            fns = [len(f.output_ids) for f in req.forks]
            progressed = (n > req.streamed
                          or any(fn > st for fn, st
                                 in zip(fns, req.fork_streamed)))
            if not progressed and not closed:
                continue
            # delta-only emission: copy just the new tokens; the
            # cumulative stream is a zero-copy TokenStream view bounded at
            # n (output_ids only ever grows, so the view is a stable
            # snapshot — no O(len) slice per increment)
            new = seq.output_ids[req.streamed:n]
            cum = TokenStream(seq.output_ids, n)
            req.streamed = n
            forks = None
            if req.forks:
                forks = []
                for i, (f, fn) in enumerate(zip(req.forks, fns)):
                    forks.append(ForkOutput(
                        i + 1, f.output_ids[req.fork_streamed[i]:fn],
                        TokenStream(f.output_ids, fn),
                        f.status in (SeqStatus.FINISHED, SeqStatus.ABORTED),
                        f.finish_reason, f))
                    req.fork_streamed[i] = fn
            if not closed:
                outs.append(RequestOutput(
                    rid, new, cum, False, RequestState.of(seq),
                    None, None, seq, forks=forks))
                continue
            rm = RequestMetrics.of(seq)
            outs.append(RequestOutput(
                rid, new, cum, True, rm.state, seq.finish_reason, rm, seq,
                forks=forks))
            self._retire(rid, req, rm)
        return outs

    def _retire(self, rid: int, req: Request, rm: RequestMetrics):
        """Final bookkeeping once a request's last output is delivered."""
        self.requests.pop(rid, None)
        self._request_stats.append(rm)
        for s in req.all_seqs:
            if s.status == SeqStatus.FINISHED:
                self._tokens_finished += len(s.output_ids)
            # finished sequences released their KV in _on_sampled; strip
            # sampler penalty columns too so long-run state stays bounded
            # by the live batch (idempotent with the abort-path release)
            self._drop_sampler_state(s.seq_id)
        if req.seq.status == SeqStatus.FINISHED:
            self._n_finished += 1
        else:
            self._n_aborted += 1

    def generate(self, prompts: List[List[int]],
                 params: Union[SamplingParams, List[SamplingParams]],
                 ) -> Iterator[RequestOutput]:
        """Streaming entry point: admit ``prompts`` (one SamplingParams
        shared, or one per prompt) and yield their RequestOutput
        increments as tokens land, until all of them finish.  Outputs of
        OTHER concurrent requests are not consumed — drive ``step()``
        directly for a multi-consumer serving loop."""
        if isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError(
                f"{len(prompts)} prompts but {len(params)} sampling params")
        want = {self.add_request(p, sp)
                for p, sp in zip(prompts, params)}
        while want:
            for out in self.step():
                if out.request_id in want:
                    if out.finished:
                        want.discard(out.request_id)
                    yield out

    def run(self, max_iterations: int = 10_000) -> List[Sequence]:
        """Offline-batch compatibility wrapper: drive ``step()`` until
        every admitted request finishes, then shut the stage workers
        down.  Token-identical to the pre-redesign blocking ``run()``
        under greedy sampling — the step loop is the same loop."""
        self.t_start = time.monotonic()
        done: List[Sequence] = []
        start_it = self._it      # cap counts THIS call's iterations
        while self._it - start_it < max_iterations:
            for out in self.step():
                if out.finished and out.state == RequestState.FINISHED:
                    done.append(out.seq)
            if not self.has_work:
                break
        self.shutdown()
        return done

    def shutdown(self):
        """Stop the stage executors (terminal — engines are not
        restartable; finish or abort outstanding requests first)."""
        if self._stopped:
            return
        self._stopped = True
        for w in self.stages:
            w.stop()
        if self.sampling_worker is not None:
            # the FIFO drains before the sentinel, so every emitted
            # iteration's sampling lands before the worker exits
            self.sampling_worker.stop()

    # engine-specific:
    def _submit(self, sched: SchedulingOutput):
        raise NotImplementedError

    def _await_iteration(self, sched: SchedulingOutput):
        deadline = time.monotonic() + 120
        while sched.iteration not in self.iter_done_t:
            if self.sampling_worker is not None:
                self.sampling_worker.check()   # surface sampler crashes
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"iteration {sched.iteration} never completed")
            time.sleep(0.0005)

    def load(self) -> Dict[str, int]:
        """Cheap load snapshot for routing decisions (serving/router.py):
        live request count, waiting-queue depth, and KV block occupancy.
        Unlike :meth:`metrics` this allocates nothing proportional to
        history — safe to poll per-request.  Host counters only: it never
        touches the device, so the router's and the HTTP handlers' threads
        may poll it while a stage captures a graph."""
        if self.paged:
            total = self.kv_manager.n_blocks
            free = (self.kv_manager.free_blocks
                    + self.kv_manager.reclaimable_cached_blocks)
        else:
            total = self.seq_cache.max_rows
            free = self.seq_cache.free_rows
        return {
            "active_requests": len(self.requests),
            # online waiting only — the router balances SLO traffic; the
            # offline backlog is reported separately so it never repels
            # online placements from an engine with deep batch work
            "queue_depth": len(self.scheduler.waiting),
            "offline_queue_depth": len(self.scheduler.waiting_offline),
            "kv_blocks_total": total,
            "kv_blocks_free": free,
        }

    def metrics(self) -> Dict[str, Any]:
        t_end = max([self._t_last_done, *list(self.iter_done_t.values())]) \
            or self.t_start
        wall = max(t_end - self.t_start, 1e-9)
        toks = self._tokens_finished + sum(
            len(r.seq.output_ids) for r in self.requests.values()
            if r.seq.status == SeqStatus.FINISHED)   # finished, not yet drained
        per_stage = []
        for w in self.stages:
            busy = sum(e - s for s, e in w.metrics.busy)
            g = w.graphs
            per_stage.append({
                "busy_s": busy,
                "prep_s": w.executor.prep_time,
                "exec_s": w.executor.exec_time,
                "bubble_frac": max(0.0, 1.0 - busy / wall),
                # decode steps as CUDA graphs: captured, replayed, and the
                # seconds the captures took (0 without graphs)
                "graphs": 0 if g is None else len(g),
                "graph_replays": 0 if g is None else g.replays,
                "graph_capture_s": 0.0 if g is None else g.capture_s,
            })
        stats = list(self._request_stats)
        # latency percentiles are ONLINE-tier only (docs/hybrid.md):
        # offline rows would drag the SLO metrics the admission layer and
        # the adaptive policy steer by; they get their own offline_* keys
        online = [r for r in stats if r.tier != "offline"]
        offline = [r for r in stats if r.tier == "offline"]
        tpots = [r.tpot_s for r in online if r.tpot_s is not None]
        ttfts = [r.ttft_s for r in online if r.ttft_s is not None]
        queues = [r.queue_s for r in online if r.queue_s is not None]
        off_tpots = [r.tpot_s for r in offline if r.tpot_s is not None]
        off_ttfts = [r.ttft_s for r in offline if r.ttft_s is not None]

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else 0.0

        out = {
            "wall_s": wall,
            "tokens": toks,
            "throughput_tok_s": toks / wall,
            "tpot_mean_s": float(np.mean(tpots)) if tpots else 0.0,
            "tpot_p50_s": pct(tpots, 50),
            "tpot_p99_s": pct(tpots, 99),
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "queue_mean_s": float(np.mean(queues)) if queues else 0.0,
            "queue_p99_s": pct(queues, 99),
            # hybrid tier (docs/hybrid.md): offline latency tracked apart
            # from the online SLO percentiles above, plus the slack ledger
            # (bubble seats offered / sold) and offline preemption count
            "offline_tpot_mean_s": float(np.mean(off_tpots)) if off_tpots else 0.0,
            "offline_tpot_p99_s": pct(off_tpots, 99),
            "offline_ttft_mean_s": float(np.mean(off_ttfts)) if off_ttfts else 0.0,
            "offline_ttft_p99_s": pct(off_ttfts, 99),
            "offline_requests_seen": len(offline),
            "slack_seats_seen": self.scheduler.slack.seats_seen,
            "slack_tokens_sold": self.scheduler.slack.tokens_sold,
            "slack_offers": self.scheduler.slack.offers,
            "offline_preemptions": self.scheduler.n_offline_preemptions,
            "requests_submitted": self._n_submitted,
            "requests_finished": self._n_finished,
            "requests_aborted": self._n_aborted,
            "requests_active": len(self.requests),
            "queue_depth": len(self.scheduler.waiting),
            "offline_queue_depth": len(self.scheduler.waiting_offline),
            # per-request latency records over the retained window
            "requests": {r.request_id: r.as_dict() for r in stats},
            "sample_s": self.sample_time,
            "stages": per_stage,
            "incremental_hits": sum(w.meta_cache.incremental_hits for w in self.stages),
            "meta_rebuilds": sum(w.meta_cache.rebuilds for w in self.stages),
            "policy": self.scheduler.policy.name,
            "kv_layout": self.cfg.kv_layout,
        }
        if self.paged:
            out["kv_block_size"] = self.cfg.kv_block_size
            out["kv_blocks_total"] = self.kv_manager.n_blocks
            # "free" counts reclaimable capacity: the free list PLUS
            # cached prefix blocks held only by their pin (admission and
            # growth evict those on demand) — so an idle engine with a
            # warm prefix cache still reports blocks_free == blocks_total
            cached = self.kv_manager.reclaimable_cached_blocks
            out["kv_blocks_free"] = self.kv_manager.free_blocks + cached
            out["kv_blocks_cached"] = cached
            out["kv_preemptions"] = self.scheduler.n_preemptions
            out["kv_fork_children"] = self.scheduler.n_forks
            out["kv_fork_demotions"] = self.scheduler.n_fork_demotions
            out["kv_table_widths"] = self.kv_manager.table_widths
            for k, v in self.kv_manager.prefix_stats().items():
                out[f"kv_{k}"] = v
        out.update(self.compile_stats())
        for k, v in self.scheduler.policy.metrics().items():
            out[f"policy_{k}"] = v
        return out

    def compile_stats(self) -> Dict[str, int]:
        """The reference's executable count (repro/core/engine.py:1150):
        here the decode-step graphs captured over all stages, one per
        (batch, table width) shape a stage ran; 0 without graphs (the
        CPU).  Chunk and prefill steps run eagerly and add none."""
        return {"jit_executables": sum(len(w.graphs) for w in self.stages
                                       if w.graphs is not None)}


class SiPipeEngine(PPEngineBase):
    """TSEM executors run stages asynchronously; sampling on CPU pool."""

    def _submit(self, sched: SchedulingOutput):
        for w in self.stages:
            if isinstance(w.executor, TokenSafeExecutor):
                w.executor.submit(sched)
            else:
                threading.Thread(target=w.executor.run, args=(sched,),
                                 daemon=True).start()


class NaivePPEngine(PPEngineBase):
    """Synchronous baseline: stages run in order on the caller thread; the
    final stage performs sampling *inside* its critical path (overlapped
    sampling is forced off — it's the SiPipe technique being ablated)."""

    def __init__(self, model: Model, params, cfg: EngineConfig):
        cfg = dataclasses.replace(cfg, tsem=False, sat=False,
                                  cpu_sampling=False,
                                  overlap_sampling=False)
        super().__init__(model, params, cfg)

    def _submit(self, sched: SchedulingOutput):
        for w in self.stages:
            w.executor.run(sched)
