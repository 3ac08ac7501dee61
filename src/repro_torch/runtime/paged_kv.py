"""Paged KV-cache substrate (vLLM-style block tables) for the engine.

Physical cache: [n_blocks, block_size, kv_heads, head_dim] per layer.
Each sequence owns a list of physical block ids; logical position p lives
at (block_table[p // bs], p %% bs).  Allocation is O(1) from a free list;
freeing a finished sequence returns all its blocks.  Copy-on-write
support (for beam/parallel sampling forks) refcounts blocks.

This substrate manages *placement* and is host code, copied from the JAX
package with only its imports changed.  The engine's attention reads K/V
through the block tables it hands out (the paged CUDA kernels in
:mod:`repro_torch.kernels`); the tensor helpers at the end of this module
are the torch counterparts of the reference's jnp helpers.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class PagedAllocator:
    n_blocks: int
    block_size: int

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}
        # prefix-cache holds: block -> number of cache pins.  A pinned
        # block is refcounted like a table reference, so it survives the
        # release of every sequence that wrote it — its contents stay
        # valid for future prefix matches until the cache unpins it.
        self._pins: Dict[int, int] = {}
        # device-side CoW work queue: (src, dst) physical pairs appended by
        # cow(); the BlockSpaceManager drains them into the iteration that
        # must copy block contents on every stage before computing.
        self._pending_copies: List[Tuple[int, int]] = []

    # -- allocation ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, length: int) -> int:
        return (length + self.block_size - 1) // self.block_size

    def can_allocate(self, seq_len: int) -> bool:
        return self.blocks_needed(seq_len) <= self.free_blocks

    def allocate(self, seq_id: int, seq_len: int) -> List[int]:
        need = self.blocks_needed(seq_len)
        if need > self.free_blocks:
            raise MemoryError(
                f"paged KV exhausted: need {need}, free {self.free_blocks}")
        blocks = [self._free.pop() for _ in range(need)]
        for b in blocks:
            self._refs[b] = 1
        self._tables[seq_id] = blocks
        return blocks

    def append_token(self, seq_id: int, new_len: int) -> Optional[int]:
        """Grow by one token; returns a newly allocated block id or None.

        The token lands at slot ``new_len - 1``: if that block is shared
        (a live fork or a cached prefix holds a reference), it is CoW'd
        first — writing through a shared block would corrupt every other
        holder.  The copy pair is queued in ``_pending_copies``."""
        table = self._tables[seq_id]
        created = None
        if self.blocks_needed(new_len) > len(table):
            if not self._free:
                raise MemoryError("paged KV exhausted on append")
            b = self._free.pop()
            self._refs[b] = 1
            table.append(b)
            created = b
        wb = (new_len - 1) // self.block_size
        if wb < len(table) and self._refs[table[wb]] > 1:
            nb, _ = self.cow(seq_id, wb)      # may raise on exhaustion
            if created is None:
                created = nb
        return created

    def grow_to(self, seq_id: int, n_slots: int,
                write_slot: Optional[int] = None) -> bool:
        """All-or-nothing growth: extend ``seq_id``'s table to cover
        ``n_slots`` logical slots AND guarantee the caller's next write —
        slot ``write_slot`` (default ``n_slots - 1``) — targets an
        exclusively-owned block, CoW-ing a shared one.  Returns False,
        allocating and copying nothing, when the sequence is unknown or
        the free list cannot cover growth + CoW together (the
        scheduler's preempt-and-retry path)."""
        table = self._tables.get(seq_id)
        if table is None:
            return False
        grow = self.blocks_needed(n_slots) - len(table)
        wb = (n_slots - 1 if write_slot is None else write_slot) \
            // self.block_size
        need_cow = wb < len(table) and self._refs[table[wb]] > 1
        if max(grow, 0) + (1 if need_cow else 0) > len(self._free):
            return False
        for _ in range(max(grow, 0)):
            b = self._free.pop()
            self._refs[b] = 1
            table.append(b)
        if need_cow:
            self.cow(seq_id, wb)              # free list pre-checked above
        return True

    def has(self, seq_id: int) -> bool:
        return seq_id in self._tables

    def free(self, seq_id: int):
        for b in self._tables.pop(seq_id, []):
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)

    # -- copy-on-write forks -------------------------------------------------
    def fork(self, src_seq: int, dst_seq: int):
        """Share all blocks (refcounted); writes must call cow() first."""
        table = self._tables[src_seq]
        for b in table:
            self._refs[b] += 1
        self._tables[dst_seq] = list(table)

    def cow(self, seq_id: int, logical_block: int) -> Tuple[int, Optional[int]]:
        """Ensure exclusive ownership of one logical block before a write.
        Returns (physical_block, copied_from or None); when a copy
        happened the (src, dst) pair is queued in ``_pending_copies`` for
        the device-side content copy."""
        table = self._tables[seq_id]
        b = table[logical_block]
        if self._refs[b] == 1:
            return b, None
        if not self._free:
            raise MemoryError("paged KV exhausted on CoW")
        nb = self._free.pop()
        self._refs[b] -= 1
        self._refs[nb] = 1
        table[logical_block] = nb
        self._pending_copies.append((b, nb))
        return nb, b

    def adopt(self, seq_id: int, shared: List[int], n_fresh: int):
        """Build a table from ``shared`` existing blocks (refcount + 1
        each — the prefix-cache admission path) followed by ``n_fresh``
        newly popped blocks.  All-or-nothing on the free list."""
        assert seq_id not in self._tables, f"seq {seq_id} already has a table"
        if n_fresh > len(self._free):
            raise MemoryError(
                f"paged KV exhausted: need {n_fresh}, free {len(self._free)}")
        for b in shared:
            self._refs[b] += 1
        fresh = [self._free.pop() for _ in range(n_fresh)]
        for b in fresh:
            self._refs[b] = 1
        self._tables[seq_id] = list(shared) + fresh

    # -- prefix-cache pins ---------------------------------------------------
    def pin(self, block: int):
        """Hold a block on behalf of the prefix cache: one extra ref, so
        it outlives every sequence table that contains it."""
        self._refs[block] = self._refs.get(block, 0) + 1
        self._pins[block] = self._pins.get(block, 0) + 1

    def unpin(self, block: int):
        self._pins[block] -= 1
        if not self._pins[block]:
            del self._pins[block]
        self._refs[block] -= 1
        if self._refs[block] == 0:
            del self._refs[block]
            self._free.append(block)

    def drain_copies(self) -> List[Tuple[int, int]]:
        out, self._pending_copies = self._pending_copies, []
        return out

    def table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    # -- invariant helpers (used by property tests) -------------------------
    def check_invariants(self):
        owned = [b for t in self._tables.values() for b in t]
        held = set(owned) | set(self._pins)
        assert len(set(self._free) & held) == 0, "block both free+held"
        for b, r in self._refs.items():
            occ = sum(1 for t in self._tables.values() for x in t if x == b)
            assert r == occ + self._pins.get(b, 0), \
                f"block {b}: refs {r} != tables {occ} + pins " \
                f"{self._pins.get(b, 0)}"
        assert len(self._free) + len(held) == self.n_blocks


@dataclasses.dataclass
class _PrefixEntry:
    block: int                  # physical block holding the cached K/V
    tokens: Tuple[int, ...]     # the block's token ids (collision guard)
    parent: Optional[int]       # chain key of the preceding block's entry
    tick: int                   # LRU clock


#: registration sentinel: this sequence's hash chain hit a (vanishingly
#: rare) collision — stop registering its blocks rather than corrupt the
#: chain with wrong-content entries.
_CHAIN_BROKEN = object()


class PrefixCache:
    """Hash-based block-granular prompt-prefix index (vLLM-style).

    Each FULL prompt block is keyed by the *cumulative* hash of
    ``(parent_key, block token tuple)``, so a chain of matches is
    position-aware for free: block i of one prompt can only match block i
    of an identical leading prefix.  Entries store the token tuple and
    verify it on match — a hash collision degrades to a miss, never to
    wrong K/V.  Matched/registered blocks are *pinned* in the
    :class:`PagedAllocator` (one extra refcount), so cached content
    survives the sequences that produced it; eviction is LRU over entries
    whose pin is the only remaining reference.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._entries: Dict[int, _PrefixEntry] = {}
        self._by_block: Dict[int, int] = {}       # physical block -> key
        self._tick = 0
        self.hits = 0              # admissions that matched >= 1 block
        self.misses = 0            # admissions that matched none
        self.evictions = 0
        self.tokens_served = 0     # prompt tokens mapped instead of computed

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(parent: Optional[int], tokens: Tuple[int, ...]) -> int:
        return hash((parent, tokens))

    def match(self, token_ids: Sequence[int]) -> List[int]:
        """Physical blocks of the longest cached chain covering the
        leading full blocks of ``token_ids`` (touches LRU ticks)."""
        bs = self.block_size
        out: List[int] = []
        parent: Optional[int] = None
        for i in range(len(token_ids) // bs):
            tok = tuple(int(t) for t in token_ids[i * bs:(i + 1) * bs])
            key = self._key(parent, tok)
            e = self._entries.get(key)
            if e is None or e.tokens != tok:
                break
            self._tick += 1
            e.tick = self._tick
            out.append(e.block)
            parent = key
        return out

    def register(self, parent: Optional[int], tokens: Tuple[int, ...],
                 block: int) -> Tuple[Optional[int], bool]:
        """Insert one block into the chain.  Returns ``(chain_key,
        created)``; ``(None, False)`` on a content-mismatched hash
        collision (the caller stops chaining this sequence)."""
        key = self._key(parent, tokens)
        e = self._entries.get(key)
        if e is not None:
            if e.tokens != tokens:
                return None, False
            return key, False      # identical content already cached
        self._tick += 1
        self._entries[key] = _PrefixEntry(block, tokens, parent, self._tick)
        self._by_block[block] = key
        return key, True

    def key_of(self, block: int) -> Optional[int]:
        return self._by_block.get(block)

    def pop(self, key: int) -> _PrefixEntry:
        e = self._entries.pop(key)
        self._by_block.pop(e.block, None)
        self.evictions += 1
        return e


class BlockSpaceManager:
    """Block-budget accounting + placement shared by the scheduler and the
    engine's worker side (the engine memory mode ``kv_layout="paged"``).

    The scheduler consults it for admission (``can_admit``) and growth
    (``ensure``: a decode step writing position ``length-1`` may need a new
    block) and frees a preempted/finished sequence's blocks (``release``);
    the engine's CPU executors snapshot per-batch padded block tables
    (``padded_tables``) at schedule time for the device-side gather/scatter.
    Mutations come from the driver thread (schedule/admission/preemption)
    while stage CPU threads read tables concurrently — all entry points
    take the manager lock.

    ``slot_cap`` bounds the logical slots per sequence for sliding-window
    models with rolling caches (slot = pos %% W): a sequence never needs
    more than ``ceil(W / block_size)`` blocks regardless of length.

    ``max_slots``/``max_table_buckets`` shape the *ladder* of padded
    table widths ``padded_tables`` may emit.  Each distinct width is one
    XLA compile of the whole stage function, so the engine wants a
    handful of steady-state widths, not one per pow2 growth step.  The
    ladder is the powers of two strictly below the per-sequence block
    ceiling plus the exact ceiling itself (``slot_cap // block_size``
    for rolling models — the rolling kernels' stored-position modulus
    requires a wrapped row's width to be *exactly* the window), and
    ``max_table_buckets`` keeps only the largest N rungs.  With neither
    bound set the ladder is unbounded pow2s (the pre-capping behavior).
    """

    def __init__(self, n_blocks: int, block_size: int,
                 slot_cap: Optional[int] = None, *,
                 max_slots: Optional[int] = None,
                 max_table_buckets: Optional[int] = None,
                 prefix_cache: bool = False):
        if slot_cap is not None and slot_cap % block_size:
            raise ValueError(
                f"block_size {block_size} must divide the sliding window "
                f"{slot_cap}: rolling slot arithmetic needs whole blocks")
        if prefix_cache and slot_cap is not None:
            raise ValueError(
                "prefix caching requires a non-rolling cache: with "
                "slot = pos % window a block's content is position-"
                "dependent and cannot be shared across prompts")
        self.block_size = block_size
        self.slot_cap = slot_cap
        self.alloc = PagedAllocator(n_blocks, block_size)
        self._lock = threading.Lock()
        self._prefix = PrefixCache(block_size) if prefix_cache else None
        # per-seq registration watermark: (full blocks registered, chain
        # key of the last one) — registration resumes from here; dropped
        # (NOT the cached entries, which are pinned) on release
        self._reg: Dict[int, Tuple[int, Optional[int]]] = {}
        self.ladder_extensions = 0
        self.cow_copies = 0
        self.forks = 0
        if slot_cap is not None:
            cap = slot_cap // block_size
        elif max_slots is not None:
            cap = -(-max_slots // block_size)
        else:
            cap = None
        self._ladder: Optional[List[int]] = None
        if cap is not None:
            ladder = []
            w = 1
            while w < cap:
                ladder.append(w)
                w <<= 1
            ladder.append(cap)
            if max_table_buckets is not None and max_table_buckets >= 1:
                ladder = ladder[-max_table_buckets:]
            self._ladder = ladder

    @property
    def table_widths(self) -> Optional[List[int]]:
        """The padded-table width ladder (None = unbounded pow2s)."""
        return list(self._ladder) if self._ladder is not None else None

    # -- budget arithmetic ---------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.alloc.n_blocks

    @property
    def pad_block(self) -> int:
        """Physical id of the trash block: the engine allocates one block
        past ``n_blocks`` that padded table entries point at — writes to it
        are discarded, reads from it are position-masked."""
        return self.alloc.n_blocks

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return self.alloc.free_blocks

    def slots_for(self, length: int) -> int:
        """Logical KV slots a sequence of ``length`` tokens occupies."""
        if self.slot_cap is not None:
            return min(length, self.slot_cap)
        return length

    def blocks_for(self, length: int) -> int:
        return max(1, self.alloc.blocks_needed(self.slots_for(length)))

    # -- prefix cache ---------------------------------------------------------
    @property
    def prefix_enabled(self) -> bool:
        return self._prefix is not None

    def _matchable(self, length: int, chain: List[int]) -> List[int]:
        """Cap a matched chain so at least one prompt token is always
        computed — the admitted sequence needs logits at its last
        position, which only a real prefill/chunk produces."""
        return chain[:min(len(chain), (length - 1) // self.block_size)]

    def _evict_cached(self, need: int, exclude=()) -> int:
        """Evict up to ``need`` LRU cache entries whose pin is the only
        remaining reference; their blocks return to the free list.
        Returns the number of blocks freed.  (Caller holds the lock.)"""
        if self._prefix is None or need <= 0:
            return 0
        skip = set(exclude)
        cands = sorted(
            (e.tick, k) for k, e in self._prefix._entries.items()
            if self.alloc._refs.get(e.block, 0) == 1 and e.block not in skip)
        freed = 0
        for _, key in cands:
            if freed >= need:
                break
            e = self._prefix.pop(key)
            self.alloc.unpin(e.block)
            freed += 1
        return freed

    def register_prefix(self, seq_id: int, token_ids: Sequence[int],
                        upto: int):
        """Register ``seq_id``'s full prompt blocks below token ``upto``
        (its K/V-written watermark) into the prefix index, pinning each
        newly cached block.  Idempotent and incremental per sequence."""
        if self._prefix is None:
            return
        bs = self.block_size
        with self._lock:
            if not self.alloc.has(seq_id):
                return
            table = self.alloc._tables[seq_id]
            done, parent = self._reg.get(seq_id, (0, None))
            if parent is _CHAIN_BROKEN:
                return
            nfull = min(min(upto, len(token_ids)) // bs, len(table))
            for i in range(done, nfull):
                tok = tuple(int(t) for t in token_ids[i * bs:(i + 1) * bs])
                key, created = self._prefix.register(parent, tok, table[i])
                if key is None:            # hash collision: stop chaining
                    self._reg[seq_id] = (i, _CHAIN_BROKEN)
                    return
                if created:
                    self.alloc.pin(table[i])
                parent = key
            if nfull > done:
                self._reg[seq_id] = (nfull, parent)

    def prefix_stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "cow_copies": self.cow_copies,
                "ladder_extensions": self.ladder_extensions,
                "forks": self.forks,
            }
            if self._prefix is not None:
                px = self._prefix
                out.update(
                    prefix_hits=px.hits, prefix_misses=px.misses,
                    prefix_evictions=px.evictions,
                    prefix_cached_blocks=len(px),
                    prefix_tokens_served=px.tokens_served)
            return out

    @property
    def reclaimable_cached_blocks(self) -> int:
        """Cached blocks held ONLY by their pin — reclaimed on demand by
        admission/growth eviction, so they count as available capacity."""
        with self._lock:
            if self._prefix is None:
                return 0
            return sum(1 for e in self._prefix._entries.values()
                       if self.alloc._refs.get(e.block, 0) == 1)

    # -- scheduler-side operations ------------------------------------------
    def can_admit(self, length: int, token_ids=None,
                  evict_cached: bool = True) -> bool:
        """``evict_cached=False`` counts only genuinely free blocks as
        supply (no cached-prefix reclamation): admission that passes this
        stricter gate is guaranteed not to evict anything from the prefix
        cache — used for offline-tier admission and for the scheduler's
        baseline-equivalence reclaim loop (docs/hybrid.md)."""
        with self._lock:
            need = self.blocks_for(length)
            supply = self.alloc.free_blocks
            if self._prefix is not None:
                matched = []
                if token_ids is not None:
                    matched = self._matchable(
                        length, self._prefix.match(token_ids))
                ms = set(matched)
                need -= len(matched)
                if evict_cached:
                    supply += sum(
                        1 for e in self._prefix._entries.values()
                        if self.alloc._refs.get(e.block, 0) == 1
                        and e.block not in ms)
            return need <= supply

    def admit(self, seq_id: int, length: int, token_ids=None) -> int:
        """Reserve blocks for an admitted sequence.  With the prefix
        cache enabled and ``token_ids`` given, leading full blocks whose
        hash chain is cached are *shared* (refcount + 1) instead of
        allocated — the return value is the number of leading tokens
        whose K/V is already in cache (0 on a miss / cache off), i.e.
        where the sequence's prefill may start."""
        with self._lock:
            if self.alloc.has(seq_id):
                return 0
            need = max(1, self.blocks_for(length))
            shared: List[int] = []
            if self._prefix is not None and token_ids is not None:
                shared = self._matchable(
                    length, self._prefix.match(token_ids))
                if shared:
                    self._prefix.hits += 1
                    self._prefix.tokens_served += len(shared) * self.block_size
                else:
                    self._prefix.misses += 1
            fresh = need - len(shared)
            if fresh > self.alloc.free_blocks:
                self._evict_cached(fresh - self.alloc.free_blocks,
                                   exclude=shared)
            self.alloc.adopt(seq_id, shared, fresh)   # raises when short
            if shared:
                # the shared prefix is already registered: resume the
                # chain from its last cached block
                self._reg[seq_id] = (len(shared),
                                     self._prefix.key_of(shared[-1]))
            return len(shared) * self.block_size

    def ensure(self, seq_id: int, length: int,
               evict_cached: bool = True) -> bool:
        """Grow ``seq_id``'s table to cover ``length`` tokens and make
        the write-target block (the decode writes slot ``length - 1``)
        exclusively owned, CoW-ing a fork-shared tail.  Cached prefix
        blocks are evicted under pressure before giving up; returns
        False (allocating nothing) only when growth + CoW still cannot
        be covered — the caller preempts and retries.

        ``evict_cached=False`` grows from genuinely free blocks only,
        failing instead of touching the prefix cache — used for
        offline-tier growth and the scheduler's baseline-equivalence
        path (docs/hybrid.md)."""
        with self._lock:
            if not self.alloc.has(seq_id):
                return False
            slots = self.slots_for(length)
            ws = ((length - 1) % self.slot_cap if self.slot_cap is not None
                  else length - 1)
            while not self.alloc.grow_to(seq_id, slots, write_slot=ws):
                if not evict_cached or self._evict_cached(1) == 0:
                    return False
            return True

    def fork(self, src_seq: int, dst_seq: int) -> bool:
        """Share all of ``src_seq``'s blocks with ``dst_seq`` (refcounted
        CoW fork).  Returns False when the source holds no table."""
        with self._lock:
            if not self.alloc.has(src_seq) or self.alloc.has(dst_seq):
                return False
            self.alloc.fork(src_seq, dst_seq)
            self.forks += 1
            return True

    def drain_copies(self) -> Optional[np.ndarray]:
        """Pop the pending CoW (src, dst) block pairs as an [K, 2] int32
        array (None when empty).  The scheduler attaches them to the next
        SchedulingOutput; every stage copies block contents device-side
        before computing that iteration."""
        with self._lock:
            pc = self.alloc.drain_copies()
            if not pc:
                return None
            self.cow_copies += len(pc)
            return np.asarray(pc, np.int32)

    def release(self, seq_id: int):
        with self._lock:
            self.alloc.free(seq_id)          # idempotent: no-op when absent
            self._reg.pop(seq_id, None)

    def has(self, seq_id: int) -> bool:
        with self._lock:
            return self.alloc.has(seq_id)

    def table(self, seq_id: int) -> Optional[List[int]]:
        with self._lock:
            return (self.alloc.table(seq_id) if self.alloc.has(seq_id)
                    else None)

    # -- engine-side snapshot ------------------------------------------------
    def padded_tables(self, seq_ids: Sequence[int],
                      mask_shared: bool = False) -> np.ndarray:
        """[B, nb] int32 block tables padded with the trash block.

        ``nb`` is the smallest rung of the width ladder covering the
        batch's longest table (unbounded pow2 rounding when no ladder is
        configured), so the engine compiles one executable per
        (batch, nb) pair — and with ``max_table_buckets`` set, only a
        capped handful of nb values ever occur.  A table that outgrows
        the capped ladder EXTENDS it deterministically with the next
        power-of-two rung (recorded in ``table_widths`` /
        ``metrics()["kv_table_widths"]``) instead of emitting a one-off
        off-ladder width — each distinct width is an XLA compile, so a
        silent ``max(nbp, nb)`` escape would compile once per growth
        step.  A sequence with no table (released between schedule and
        prepare — e.g. preempted with an iteration in flight) pads to an
        all-trash row: its writes land in the trash block and its
        sampled token is discarded by the scheduler.

        ``mask_shared`` replaces every block with refcount > 1 (prefix-
        shared or fork-shared) by the trash block: the *write-masked*
        view ``run_prefill`` scatters through, so a monolithic prefill
        recomputing a shared prompt never writes a block other holders
        read (the recomputed values are bit-identical anyway; masking
        removes the write hazard entirely)."""
        with self._lock:
            tables = [self.alloc.table(sid) if self.alloc.has(sid) else []
                      for sid in seq_ids]
            nb = max(1, max((len(t) for t in tables), default=1))
            if self._ladder is not None:
                if nb > self._ladder[-1]:
                    w = 1
                    while w < nb:
                        w <<= 1
                    self._ladder.append(w)
                    self.ladder_extensions += 1
                nbp = next(w for w in self._ladder if w >= nb)
            else:
                nbp = 1
                while nbp < nb:
                    nbp <<= 1
            out = np.full((len(tables), nbp), self.pad_block, np.int32)
            for i, t in enumerate(tables):
                if mask_shared:
                    t = [b if self.alloc._refs.get(b, 0) == 1
                         else self.pad_block for b in t]
                out[i, :len(t)] = t
            return out


def init_paged_cache(n_layers: int, n_blocks: int, block_size: int,
                     kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                     device=None):
    """Zeroed [n_layers, n_blocks, bs, kv, hd] K and V pools on
    ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    shape = (n_layers, n_blocks, block_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_token(cache, layer: int, block: int, offset: int, k, v):
    """Write one token's K/V into its physical slot (in place)."""
    cache["k"][layer, block, offset] = k
    cache["v"][layer, block, offset] = v
    return cache


def gather_cache(cache, layer: int, block_table: np.ndarray, length: int,
                 block_size: int):
    """Materialize a contiguous [length, kv, hd] view for one sequence."""
    bt = torch.as_tensor(np.asarray(block_table), dtype=torch.long,
                         device=cache["k"].device)
    k = cache["k"][layer][bt].reshape(-1, *cache["k"].shape[3:])[:length]
    v = cache["v"][layer][bt].reshape(-1, *cache["v"].shape[3:])[:length]
    return k, v
