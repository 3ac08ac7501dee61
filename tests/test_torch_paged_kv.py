"""The port's copy of the paged KV substrate against the reference's: the
op sequences of tests/test_paged_kv.py (and seeded random churn) are
replayed through both ``PagedAllocator``s / ``BlockSpaceManager``s, and
after every op the results, block ids, refcounts, pins, CoW pairs, prefix
cache entries and table widths must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import paged_kv as ref_kv
from repro_torch.runtime import paged_kv as port_kv


def _plain(x):
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _alloc_state(a):
    return (list(a._free), {k: list(v) for k, v in a._tables.items()},
            dict(a._refs), dict(a._pins), list(a._pending_copies))


def _manager_state(m):
    px = m._prefix
    return (_alloc_state(m.alloc), dict(m._reg), m._ladder,
            m.ladder_extensions, m.cow_copies, m.forks,
            None if px is None else (sorted(px._entries), dict(px._by_block),
                                     px.hits, px.misses, px.evictions,
                                     px.tokens_served))


class Twin:
    """Applies each call to the reference object and the port's, and
    checks that both return the same (or raise the same) and end in the
    same state."""

    def __init__(self, ref, port, state):
        self.ref, self.port, self.state = ref, port, state
        self.calls = 0

    def __getattr__(self, name):
        def call(*args, **kw):
            outs = []
            for obj in (self.ref, self.port):
                try:
                    outs.append(("ok", _plain(getattr(obj, name)(*args, **kw))))
                except (MemoryError, ValueError, KeyError) as e:
                    outs.append(("raise", type(e).__name__))
            assert outs[0] == outs[1], (name, args, outs)
            assert self.state(self.ref) == self.state(self.port), (name, args)
            self.calls += 1
            if outs[0][0] == "raise":
                raise {"MemoryError": MemoryError, "ValueError": ValueError,
                       "KeyError": KeyError}[outs[0][1]]()
            return outs[0][1]
        return call

    def get(self, attr):
        a, b = getattr(self.ref, attr), getattr(self.port, attr)
        assert _plain(a) == _plain(b), attr
        return a


def allocators(n_blocks, bs):
    return Twin(ref_kv.PagedAllocator(n_blocks, bs),
                port_kv.PagedAllocator(n_blocks, bs), _alloc_state)


def managers(*args, **kw):
    return Twin(ref_kv.BlockSpaceManager(*args, **kw),
                port_kv.BlockSpaceManager(*args, **kw), _manager_state)


def test_allocator_scenarios():
    a = allocators(8, 4)
    a.allocate(0, 10)
    a.free(0)
    a.allocate(0, 4)
    a.append_token(0, 5)
    a.append_token(0, 6)
    a.fork(0, 1)
    a.cow(1, 0)
    a.free(0)
    a.free(1)
    a.allocate(2, 32)
    with pytest.raises(MemoryError):
        a.allocate(3, 1)
    a.can_allocate(1)
    a.check_invariants()
    # grow_to counts a shared write block's CoW with the growth
    g = allocators(3, 4)
    g.allocate(0, 8)
    g.fork(0, 1)
    g.grow_to(1, 9, write_slot=7)
    g.grow_to(1, 8)
    g.drain_copies()
    g.grow_to(0, 9)
    g.free(1)
    g.grow_to(0, 9)
    g.check_invariants()


def test_manager_fork_cow_and_exhaustion():
    m = managers(8, 4)
    m.admit(0, 8)
    m.fork(0, 1)
    m.fork(0, 1)
    m.fork(9, 2)
    m.ensure(1, 8)
    m.drain_copies()
    m.drain_copies()
    m.prefix_stats()
    m.release(0)
    m.release(1)
    e = managers(4, 4)
    e.admit(0, 8)
    e.fork(0, 1)
    e.admit(2, 8)
    e.ensure(1, 8)
    e.release(2)
    e.ensure(1, 8)
    e.drain_copies()
    assert e.get("free_blocks") == 1


def test_manager_prefix_cache():
    m = managers(8, 4, prefix_cache=True)
    toks = list(range(100, 116))
    m.admit(0, 16, token_ids=toks)
    m.register_prefix(0, toks, 16)
    m.register_prefix(0, toks, 16)
    m.release(0)
    m.get("reclaimable_cached_blocks")
    m.admit(1, 16, token_ids=toks)
    m.admit(2, 16, token_ids=toks[:8] + [999] * 8)
    m.release(1)
    m.release(2)
    m.can_admit(24, token_ids=[7] * 24)
    m.admit(3, 24, token_ids=[7] * 24)
    m.prefix_stats()
    m.release(3)
    for kv in (ref_kv, port_kv):
        with pytest.raises(ValueError, match="rolling"):
            kv.BlockSpaceManager(8, 4, slot_cap=16, prefix_cache=True)
        with pytest.raises(ValueError, match="divide"):
            kv.BlockSpaceManager(8, 3, slot_cap=16)


def test_manager_tables_ladder_and_caps():
    m = managers(16, 8, max_slots=32, max_table_buckets=2)
    m.get("table_widths")
    m.admit(0, 8)
    m.padded_tables([0])
    m.admit(1, 40)
    m.padded_tables([0, 1])
    m.padded_tables([1])
    m.get("table_widths")
    s = managers(8, 4)
    s.admit(0, 8)
    s.fork(0, 1)
    s.ensure(1, 8)
    s.ensure(1, 9)
    s.drain_copies()
    s.padded_tables([1], mask_shared=True)
    s.padded_tables([1])
    c = managers(8, 4, slot_cap=16)
    for n in (3, 17, 1000):
        c.blocks_for(n)
    c.admit(0, 6)
    c.ensure(0, 9)
    c.ensure(0, 100)
    c.admit(1, 16)
    c.ensure(2, 4)
    c.release(0)
    c.release(0)
    c.padded_tables([1, 0])
    n = managers(4, 2)
    n.admit(0, 2)
    n.admit(1, 6)
    n.ensure(0, 8)
    n.release(1)
    n.ensure(0, 8)


@pytest.mark.parametrize("seed", range(6))
def test_random_churn_allocator(seed):
    """Seeded alloc/free/append/fork/cow/grow churn (the property tests'
    op mix), replayed through both allocators."""
    rng = np.random.default_rng(seed)
    a = allocators(int(rng.integers(4, 24)), 4)
    lens, next_id = {}, 0
    for _ in range(60):
        op = rng.choice(["alloc", "free", "append", "fork", "cow", "grow"])
        arg = int(rng.integers(0, 8))
        try:
            if op == "alloc":
                a.allocate(next_id, arg % 8 + 1)
                lens[next_id] = arg % 8 + 1
                next_id += 1
            elif not lens:
                continue
            else:
                sid = sorted(lens)[arg % len(lens)]
                if op == "free":
                    a.free(sid)
                    del lens[sid]
                elif op == "append":
                    lens[sid] += 1
                    a.append_token(sid, lens[sid])
                elif op == "fork":
                    a.fork(sid, next_id)
                    lens[next_id] = lens[sid]
                    next_id += 1
                elif op == "cow":
                    a.cow(sid, 0)
                elif a.grow_to(sid, lens[sid] + 4, write_slot=lens[sid]):
                    lens[sid] += 4
        except MemoryError:
            pass
        a.check_invariants()
    assert a.calls > 30


@pytest.mark.parametrize("seed", range(6))
def test_random_churn_manager(seed):
    """Seeded admit/ensure/fork/release/register churn through both
    BlockSpaceManagers, prefix caching on, tables drained as the engine
    drains them."""
    rng = np.random.default_rng(100 + seed)
    m = managers(int(rng.integers(8, 32)), 4, max_slots=64,
                 max_table_buckets=2, prefix_cache=True)
    prompts = [rng.integers(0, 6, 24).tolist() for _ in range(3)]
    lens, next_id = {}, 0
    for _ in range(60):
        op = rng.choice(["admit", "ensure", "fork", "release", "register",
                         "tables"])
        arg = int(rng.integers(0, 16))
        if op == "admit":
            toks = prompts[arg % 3][:arg + 4]
            if m.can_admit(len(toks), token_ids=toks):
                m.admit(next_id, len(toks), token_ids=toks)
                lens[next_id] = (len(toks), toks)
            next_id += 1
        elif not lens:
            continue
        else:
            sid = sorted(lens)[arg % len(lens)]
            n, toks = lens[sid]
            if op == "ensure" and n < 64 and m.ensure(sid, n + 1):
                lens[sid] = (n + 1, toks)
            elif op == "fork":
                if m.fork(sid, next_id):
                    lens[next_id] = lens[sid]
                next_id += 1
            elif op == "release":
                m.release(sid)
                del lens[sid]
            elif op == "register":
                m.register_prefix(sid, toks, min(n, len(toks)))
            elif op == "tables":
                m.padded_tables(sorted(lens))
                m.drain_copies()
        m.prefix_stats()
    assert m.calls > 30


def test_tensor_helpers_match_reference():
    """init_paged_cache / write_token / gather_cache round trip, as
    tests/test_paged_kv.py runs it, in both packages."""
    rng = np.random.default_rng(0)
    ks = rng.normal(size=(6, 2, 8)).astype(np.float32)
    table = ref_kv.PagedAllocator(6, 4).allocate(0, 6)
    ref_cache = ref_kv.init_paged_cache(2, 6, 4, 2, 8)
    cache = port_kv.init_paged_cache(2, 6, 4, 2, 8, device="cpu")
    assert cache["k"].shape == ref_cache["k"].shape
    assert cache["k"].dtype == torch.bfloat16
    for pos in range(6):
        blk, off = table[pos // 4], pos % 4
        ref_cache = ref_kv.write_token(ref_cache, 1, blk, off,
                                       jnp.asarray(ks[pos], jnp.bfloat16),
                                       jnp.asarray(ks[pos] * 2, jnp.bfloat16))
        cache = port_kv.write_token(cache, 1, blk, off,
                                    torch.tensor(ks[pos]).bfloat16(),
                                    torch.tensor(ks[pos] * 2).bfloat16())
    rk, rv = ref_kv.gather_cache(ref_cache, 1, np.array(table), 6, 4)
    k, v = port_kv.gather_cache(cache, 1, np.array(table), 6, 4)
    np.testing.assert_array_equal(k.float().numpy(), np.asarray(rk, np.float32))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(rv, np.float32))


def test_init_paged_cache_refuses_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_kv.init_paged_cache(2, 6, 4, 2, 8)
