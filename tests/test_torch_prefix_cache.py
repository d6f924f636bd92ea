"""The port's paged pool with prefix caching (``repro_torch.serve.
PagedCachePool``) against the reference pool (``repro.serve.cache_pool.
PagedCachePool``) over the smoke llama3_1b, driven through the same seeded
random sequence of admissions with digests, prefill chunks, prefix
registrations, decode writes, frees and index invalidations: block tables,
refcounts, free lists, the cached LRU (in order), the index and every
counter equal after each operation, digests equal byte for byte, and the
port's ``check_consistency`` clean. Then the port's counterparts of the
reference's pool tests (digest chain, refcounts and copy-on-write, partial
match, the fork on tensors, LRU reclaim, churn), and ``paged_copy_block``
against the reference's on attention K/V and MLA latents."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.serve.cache_pool import PagedCachePool as JPool  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import PagedCachePool  # noqa: E402

DENSE_MLA = dict(moe_layers=(), mtp_depth=0, mla_absorb_decode=True)


@pytest.fixture(scope="module")
def model():
    return get_model("llama3_1b", smoke=True)


@pytest.fixture(scope="module")
def jmodel():
    return jget("llama3_1b", smoke=True)


def _pool(model, **kw):
    return PagedCachePool(model, device="cpu", **kw)


def _books(pool, port: bool) -> dict:
    """Everything the allocator decides, in one comparable form."""
    if port:
        free, cached, index = pool._free_blocks, pool._cached, pool._index
        reserved = pool._reserved
    else:
        free, cached = pool._free_blocks_by_shard[0], pool._cached_by_shard[0]
        index, reserved = pool._index_by_shard[0], pool._reserved
    return {"tables": pool.block_tables.tolist(), "ref": dict(pool._ref),
            "free": list(free), "cached": list(cached), "index": dict(index),
            "reserved": reserved, "slot_reserve": dict(pool._slot_reserve),
            "borrowed": {s: sorted(b) for s, b in
                         pool._slot_borrowed.items()},
            "matched": dict(pool._slot_matched),
            "counters": (pool.prefix_hit_requests, pool.prefix_hit_blocks,
                         pool.prefix_hit_tokens, pool.cow_forks,
                         pool.reclaimed_cached_blocks),
            "free_slots": pool.n_free_slots, "in_use": pool.blocks_in_use}


@pytest.mark.parametrize("seed", range(6))
def test_pool_matches_reference_pool_step_by_step(model, jmodel, seed):
    """A seeded random stream over prompts drawn from three shared-prefix
    families (full-prompt hits, partial hits, misses), under block
    pressure (LRU reclaims), with a rare index invalidation."""
    kw = dict(n_slots=3, max_len=32, block_size=4, n_blocks=14)
    pool, ref = _pool(model, **kw), JPool(jmodel, **kw)
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, 50, size=16).astype(np.int32) for _ in range(3)]
    live = {}            # slot -> [tokens, prefilled, decode pos, end pos]
    ops = Counter()

    def same():
        assert _books(pool, True) == _books(ref, False)
        assert pool.check_consistency()["ok"]

    for _ in range(120):
        r = rng.random()
        if r < 0.3 and pool.n_free_slots:
            fam = fams[int(rng.integers(3))]
            plen = int(rng.integers(1, 17))
            cut = int(rng.integers(0, plen + 1))
            toks = np.concatenate([fam[:cut], rng.integers(
                0, 50, size=plen - cut).astype(np.int32)])
            mnew = int(rng.integers(1, 6))
            dig = pool.prefix_digests(toks)
            assert dig == ref.prefix_digests(toks)
            ok = pool.can_admit(plen, mnew, digests=dig)
            assert ok == ref.can_admit(plen, mnew, digests=dig)
            if ok:
                s = pool.alloc_slot(plen, mnew, digests=dig)
                assert s == ref.alloc_slot(plen, mnew, digests=dig)
                m = pool.matched_tokens(s)
                assert m == ref.matched_tokens(s)
                live[s] = [toks, m, plen, plen + mnew - 1]
                ops["admit"] += 1
        elif r < 0.6 and any(v[1] < len(v[0]) for v in live.values()):
            pend = [s for s, v in sorted(live.items()) if v[1] < len(v[0])]
            s = pend[int(rng.integers(len(pend)))]
            toks, start = live[s][0], live[s][1]
            end = min(len(toks), start + int(rng.integers(1, 7)))
            pool.ensure_range(s, start, end)
            ref.ensure_range(s, start, end)
            pool.register_prefix(s, end)
            ref.register_prefix(s, end)
            live[s][1] = end
            ops["chunk"] += 1
        elif r < 0.8 and any(v[1] == len(v[0]) and v[2] < v[3]
                             for v in live.values()):
            s = [s for s, v in sorted(live.items())
                 if v[1] == len(v[0]) and v[2] < v[3]][0]
            pool.ensure_block(s, live[s][2])
            ref.ensure_block(s, live[s][2])
            live[s][2] += 1
            ops["decode"] += 1
        elif r < 0.98 and live:
            s = sorted(live)[int(rng.integers(len(live)))]
            pool.free_slot(s)
            ref.free_slot(s)
            del live[s]
            ops["free"] += 1
        elif r >= 0.98:
            pool.invalidate_prefix_index()
            ref.invalidate_prefix_index()
            ops["invalidate"] += 1
        same()
    for s in sorted(live):
        pool.free_slot(s)
        ref.free_slot(s)
    same()
    assert pool.blocks_in_use == 0 and pool._reserved == 0 and not pool._ref
    assert ops["admit"] >= 10 and ops["chunk"] >= 10 and ops["free"] >= 5


def test_prefix_digest_chain(model):
    pool = _pool(model, n_slots=1, max_len=32, block_size=4)
    t = np.arange(11, dtype=np.int32)
    d = pool.prefix_digests(t)
    assert len(d) == 2                      # only full blocks hash
    assert pool.prefix_digests(t[:8]) == d  # same prefix, same chain
    t2 = t.copy()
    t2[1] += 1                              # early divergence poisons the chain
    d2 = pool.prefix_digests(t2)
    assert d2[0] != d[0] and d2[1] != d[1]
    t3 = t.copy()
    t3[6] += 1                              # block 0 equal, block 1 differs
    d3 = pool.prefix_digests(t3)
    assert d3[0] == d[0] and d3[1] != d[1]
    # int32 bytes whatever the input dtype, as in the reference
    assert pool.prefix_digests(t.astype(np.int64)) == d


def test_prefix_sharing_refcount_cow_invariants(model):
    """A full-prompt hit claims the parent's blocks (refcount 2), prefills
    only the final token, and forks the last shared block: the parent
    chain is never mutated, and freeing both slots strands nothing."""
    pool = _pool(model, n_slots=2, max_len=32, block_size=4, n_blocks=13)
    prompt = np.random.default_rng(0).integers(0, 500, 12).astype(np.int32)
    dig = pool.prefix_digests(prompt)
    assert len(dig) == 3
    a = pool.alloc_slot(12, 3, digests=dig)
    assert pool.matched_tokens(a) == 0      # cold index: no hit
    pool.ensure_range(a, 0, 12)
    pool.register_prefix(a, 12)
    blks_a = [int(b) for b in pool.block_tables[a, :3]]
    b = pool.alloc_slot(12, 3, digests=dig)
    # a full-prompt hit is capped at P-1: the tail chunk still runs (it
    # produces the first token), so one token of block 2 is prefilled again
    assert pool.matched_tokens(b) == 11
    assert pool.prefix_hit_requests == 1 and pool.prefix_hit_blocks == 3
    assert pool.prefix_hit_tokens == 11
    assert [int(x) for x in pool.block_tables[b, :3]] == blks_a
    assert all(pool._ref[x] == 2 for x in blks_a)
    pool.ensure_range(b, 11, 12)            # tail chunk -> fork of page 2
    assert pool.cow_forks == 1
    assert [int(x) for x in pool.block_tables[b, :2]] == blks_a[:2]
    forked = int(pool.block_tables[b, 2])
    assert forked != blks_a[2]
    assert pool._ref[blks_a[2]] == 1 and pool._ref[forked] == 1
    pool.register_prefix(b, 12)             # first writer wins: no re-index
    assert pool._index[dig[2]] == blks_a[2]
    pool.free_slot(a)
    # blocks 0/1 still referenced by b; a's page-2 block is indexed, so it
    # is cached instead of freed
    assert pool._ref[blks_a[0]] == 1 and blks_a[2] not in pool._ref
    assert pool.n_cached_blocks == 1
    pool.free_slot(b)
    assert pool.blocks_in_use == 0 and pool._reserved == 0
    assert pool.n_free_blocks == 12 and not pool._ref
    assert pool.check_consistency()["ok"]
    with pytest.raises(RuntimeError, match="shared page"):
        s = pool.alloc_slot(12, 3, digests=dig)
        pool.ensure_block(s, 4)             # decode into a borrowed page


def test_prefix_partial_match_no_cow(model):
    """A shared-prefix-then-divergent prompt borrows only the matched full
    blocks and never forks: its first fresh write lands past the prefix."""
    pool = _pool(model, n_slots=2, max_len=32, block_size=4, n_blocks=13)
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 500, 12).astype(np.int32)
    p2 = np.concatenate([p1[:8], rng.integers(0, 500, 4).astype(np.int32)])
    a = pool.alloc_slot(12, 3, digests=pool.prefix_digests(p1))
    pool.ensure_range(a, 0, 12)
    pool.register_prefix(a, 12)
    b = pool.alloc_slot(12, 3, digests=pool.prefix_digests(p2))
    assert pool.matched_tokens(b) == 8      # blocks 0-1 shared, 2 diverges
    pool.ensure_range(b, 8, 12)             # fresh block for page 2
    assert pool.cow_forks == 0
    assert int(pool.block_tables[b, 2]) != int(pool.block_tables[a, 2])
    assert (pool.block_tables[b, :2] == pool.block_tables[a, :2]).all()
    pool.free_slot(a)
    pool.free_slot(b)
    assert pool.blocks_in_use == 0 and not pool._ref


@pytest.mark.parametrize("arch", ["llama3_1b", "deepseek_v3_671b"])
def test_cow_fork_copies_block_and_preserves_parent(arch):
    """The fork copies the source block bit for bit into the destination on
    every cache leaf (K/V, or MLA latents), in place: the pool's tensors
    keep their identity (the decode graph is bound to them), the parent is
    untouched and no other block moves."""
    kw = DENSE_MLA if arch != "llama3_1b" else {}
    pool = _pool(get_model(arch, smoke=True, **kw), n_slots=2, max_len=16,
                 block_size=4, n_blocks=13)
    prompt = np.arange(8, dtype=np.int32)
    dig = pool.prefix_digests(prompt)
    a = pool.alloc_slot(8, 1, digests=dig)
    pool.ensure_range(a, 0, 8)
    pool.register_prefix(a, 8)
    b = pool.alloc_slot(8, 1, digests=dig)
    assert pool.matched_tokens(b) == 7
    src = int(pool.block_tables[b, 1])
    leaves = {(layer, name): t for layer, d in pool.caches.items()
              for name, t in d.items()}
    for t in leaves.values():       # ramp contents make the copy observable
        t.copy_(torch.arange(t.numel(), dtype=torch.float32)
                .reshape(t.shape))
    before = {k: t.clone() for k, t in leaves.items()}
    pool.ensure_range(b, 7, 8)              # tail chunk -> fork
    dst = int(pool.block_tables[b, 1])
    assert dst != src and pool.cow_forks == 1
    for (layer, name), t in leaves.items():
        assert pool.caches[layer][name] is t, (layer, name)
        x0 = before[(layer, name)]
        assert torch.equal(t[src], x0[src]), f"parent mutated: {layer}"
        assert torch.equal(t[dst], t[src]), f"copy incomplete: {layer}"
        rest = [i for i in range(pool.n_blocks) if i != dst]
        assert torch.equal(t[rest], x0[rest]), f"other block moved: {layer}"


def test_cached_lru_reclaim_deindexes(model):
    """Refcount-0 indexed blocks stay resident and are reclaimed only once
    the free list is empty, oldest released first, de-indexing their
    chain; the trash block is never handed out."""
    pool = _pool(model, n_slots=1, max_len=32, block_size=4, n_blocks=9)
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 500, 8).astype(np.int32)
    p2 = rng.integers(0, 500, 8).astype(np.int32)
    d1, d2 = pool.prefix_digests(p1), pool.prefix_digests(p2)
    for dig in (d1, d2):
        s = pool.alloc_slot(8, 1, digests=dig)
        pool.ensure_range(s, 0, 8)
        pool.register_prefix(s, 8)
        pool.free_slot(s)
    assert pool.n_cached_blocks == 4 and pool.n_free_blocks == 8
    # 6 blocks needed, 4 free: reclaims the 2 oldest cached blocks (p1's,
    # released first); p2's chain survives
    s = pool.alloc_slot(24, 1)
    pool.ensure_range(s, 0, 24)
    assert pool.reclaimed_cached_blocks == 2
    assert pool._match_blocks(d1) == []
    assert len(pool._match_blocks(d2)) == 2
    assert 0 not in pool.block_tables[s] and pool.check_consistency()["ok"]
    pool.free_slot(s)


def test_prefix_churn_invariants(model):
    """Random admit/free churn over prompts from two shared-prefix
    families: after every operation each block's refcount equals the number
    of tables that map it, free and cached blocks are in no table, and the
    final frees strand nothing."""
    pool = _pool(model, n_slots=3, max_len=32, block_size=4, n_blocks=16)
    rng = np.random.default_rng(3)
    fams = [rng.integers(0, 500, size=12).astype(np.int32) for _ in range(2)]

    def make_prompt():
        fam = fams[int(rng.integers(2))]
        cut = int(rng.integers(0, 13))
        tail = rng.integers(0, 500, size=12 - cut).astype(np.int32)
        return np.concatenate([fam[:cut], tail]).astype(np.int32)

    def check():
        mat = [int(x) for s in live for x in pool.block_tables[s] if x >= 0]
        assert len(set(mat)) == pool.blocks_in_use
        assert Counter(mat) == pool._ref
        assert all(v >= 1 for v in pool._ref.values())
        assert not (set(pool._free_blocks) | set(pool._cached)) & set(mat)
        assert pool.check_consistency()["ok"]

    live = []
    for _ in range(40):
        if live and (len(live) == 3 or rng.random() < 0.45):
            pool.free_slot(live.pop(int(rng.integers(len(live)))))
        else:
            p, mn = make_prompt(), int(rng.integers(1, 5))
            dig = pool.prefix_digests(p)
            if pool.can_admit(12, mn, digests=dig):
                s = pool.alloc_slot(12, mn, digests=dig)
                pool.ensure_range(s, pool.matched_tokens(s), 12)
                pool.register_prefix(s, 12)
                for pos in range(12, 12 + mn - 1):
                    pool.ensure_block(s, pos)
                live.append(s)
        check()
    for s in live:
        pool.free_slot(s)
    assert pool.blocks_in_use == 0 and pool._reserved == 0 and not pool._ref


def test_invalidate_prefix_index_frees_cached_blocks(model):
    pool = _pool(model, n_slots=2, max_len=32, block_size=4, n_blocks=9)
    p = np.arange(8, dtype=np.int32)
    dig = pool.prefix_digests(p)
    a = pool.alloc_slot(8, 1, digests=dig)
    pool.ensure_range(a, 0, 8)
    pool.register_prefix(a, 8)
    b = pool.alloc_slot(8, 3, digests=dig)
    pool.free_slot(a)
    pool.invalidate_prefix_index()
    assert pool.n_cached_blocks == 0 and not pool._index
    assert pool._match_blocks(dig) == []
    pool.free_slot(b)                   # de-indexed: back to the free list
    assert pool.n_cached_blocks == 0 and pool.n_free_blocks == 8
    assert pool.check_consistency()["ok"]


@pytest.mark.parametrize("arch", ["llama3_1b", "deepseek_v3_671b"])
def test_paged_copy_block_matches_reference(arch):
    """``LM.paged_copy_block`` in place against the reference's functional
    copy, on the same random caches."""
    kw = DENSE_MLA if arch != "llama3_1b" else {}
    tm, jm = get_model(arch, smoke=True, **kw), jget(arch, smoke=True, **kw)
    jc = jm.init_paged_cache(2, 7, 4)
    rng = np.random.default_rng(4)
    jc = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype), jc)
    tc = tm.init_paged_cache(2, 7, 4, "cpu")
    for layer, d in tc.items():
        for name, t in d.items():
            t.copy_(torch.from_numpy(np.asarray(jc[layer][name],
                                                np.float32)))
    leaves = [t for d in tc.values() for t in d.values()]
    want = jm.paged_copy_block(jc, 2, 5)
    got = tm.paged_copy_block(tc, 2, 5)
    assert got is tc
    assert all(a is b for a, b in zip(
        (t for d in got.values() for t in d.values()), leaves))
    for layer, d in got.items():
        for name, t in d.items():
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(want[layer][name], np.float32))
