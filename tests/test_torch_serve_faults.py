"""Fault injection and containment in the port (``repro_torch.serve.faults``,
the pool's quarantine, the engine's containment) against the reference
(``repro.serve``): the injector's schedules and hooks, the pool's
quarantine, poison, consistency check, ``reconcile`` and ``size_n_blocks``,
the tripwire's reductions, the fault matrix of ``tests/test_faults.py``
(every kind, lockstep and pipelined) on the same float32 weights, the
retry budget, the fused -> gather degradation, the impossible request
after quarantine and the launcher's flags.

The bar is the reference's: every request ends with a result, every
``ok`` or ``retried`` request's tokens equal the port's fault-free drain
bit for bit, and a ``failed`` one keeps a prefix of them. Against the JAX
engine the statuses, the fault counters and the completed requests' tokens
are equal; in the lockstep drain the kept token counts and the quarantined
blocks too (in the pipelined drain they depend on when the consumer thread
lands a flag)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FaultInjector as JInjector  # noqa: E402
from repro.serve import FaultSpec as JSpec  # noqa: E402
from repro.serve import PagedCachePool as JPool  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import (FAULT_KINDS, ContinuousBatchingEngine,  # noqa: E402
                               FaultInjector, FaultSpec, InjectedFault,
                               PagedCachePool, Request)
from repro_torch.serve.faults import poison_logit_rows  # noqa: E402

# the counters of counters["faults"] held to the reference's in both drains
FAULT_COUNTERS = ("injected", "seen", "contained", "retries", "failed",
                  "kernel_faults", "degraded_paged_attn")


@pytest.fixture(scope="module")
def pair():
    """(reference model, params, port model, the same params) of the
    float32 smoke llama3_1b: in bf16 the smoke logits tie often enough that
    the two frameworks break a tie apart."""
    jm = jget("llama3_1b", smoke=True, dtype="float32")
    jp = jm.init(jax.random.key(0))
    tm = get_model("llama3_1b", smoke=True, dtype="float32")
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def prompts():
    """``tests/test_faults.py``'s prompts: two shared-prefix pairs, so that
    prefix caching and copy-on-write are live."""
    rng = np.random.default_rng(42)
    fam = rng.integers(0, 500, size=8).astype(np.int32)
    out = [np.concatenate([fam, rng.integers(0, 500, 4).astype(np.int32)])
           for _ in range(2)]
    out += [rng.integers(0, 500, size=12).astype(np.int32) for _ in range(2)]
    return out


def _reqs(prompts, cls=Request, max_new=6):
    return [cls(rid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(pair, prompts):
    """The port's fault-free drain: the tokens every contained request is
    held to."""
    _, _, tm, tp = pair
    summ = _engine(tm, n_slots=4, max_len=32).serve(tp, _reqs(prompts))
    assert all(r.status == "ok" for r in summ.results.values())
    return {i: np.asarray(r.tokens) for i, r in summ.results.items()}


def _assert_contained(summ, ref, allow=("ok", "retried", "failed")):
    assert set(summ.results) == set(ref)
    for i, r in summ.results.items():
        assert r.status in allow, (i, r.status)
        if r.status in ("ok", "retried"):
            np.testing.assert_array_equal(r.tokens, ref[i])
        else:
            np.testing.assert_array_equal(np.asarray(r.tokens),
                                          ref[i][:len(r.tokens)])


def _books_clean(eng):
    pool = eng._pool
    assert pool.check_consistency()["ok"]
    assert pool.blocks_in_use == 0 and pool._reserved == 0


def _both(pair, prompts, specs, sync, max_new=6, reqs=None, **kw):
    """The JAX engine's and the port's drain of the same requests under
    the same schedule; the counters and statuses held equal."""
    jm, jp, tm, tp = pair
    jeng = JEngine(jm, faults=JInjector([JSpec(**s) for s in specs]), **kw)
    want = jeng.serve(jp, reqs[0] if reqs else _reqs(prompts, JRequest,
                                                     max_new), sync=sync)
    teng = _engine(tm, faults=FaultInjector([FaultSpec(**s) for s in specs]),
                   **kw)
    got = teng.serve(tp, reqs[1] if reqs else _reqs(prompts, Request,
                                                    max_new), sync=sync)
    wf, gf = want.counters["faults"], got.counters["faults"]
    for key in FAULT_COUNTERS:
        assert gf[key] == wf[key], (key, gf[key], wf[key])
    for rid, w in want.results.items():
        g = got.results[rid]
        assert g.status == w.status, rid
        if g.status in ("ok", "retried"):
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    if sync:
        assert gf["quarantined_blocks"] == wf["quarantined_blocks"]
        for rid, w in want.results.items():
            assert len(got.results[rid].tokens) == len(w.tokens), rid
    return want, got, teng


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

SPEC = ("nan_page@step=3,slot=0,page=1;alloc_failure@step=5,slot=2;"
        "hung_step@step=1,phase=prefill,hang_s=0.5;consumer_error@4")


def test_injector_parse_matches_reference():
    assert FAULT_KINDS == __import__("repro.serve", fromlist=["x"]).FAULT_KINDS
    got, want = FaultInjector.parse(SPEC), JInjector.parse(SPEC)
    assert [vars(s) for s in got.specs] == [vars(s) for s in want.specs]
    assert got.specs[2].hang_s == pytest.approx(0.5)
    for bad in ("bogus_kind@step=1", "", "hung_step@phase=sideways"):
        with pytest.raises(ValueError):
            FaultInjector.parse(bad)
        with pytest.raises(ValueError):
            JInjector.parse(bad)
    assert FaultSpec("nan_page").slot == JSpec("nan_page").slot == 0


@pytest.mark.parametrize("seed", range(5))
def test_random_schedule_matches_reference(seed):
    kw = dict(max_step=12, n_slots=3, max_pages=3)
    got = FaultInjector.random(seed, 6, **kw)
    assert [vars(s) for s in got.specs] == \
        [vars(s) for s in JInjector.random(seed, 6, **kw).specs]
    assert [vars(s) for s in got.specs] == \
        [vars(s) for s in FaultInjector.random(seed, 6, **kw).specs]


def _drive(inj, exc):
    """One fixed sequence of hook calls; what each returned or raised, and
    the tally."""
    out = []
    for now in range(8):
        inj.tick(now)
        for call in (lambda: inj.on_step("decode"),
                     lambda: inj.on_step("prefill"),
                     lambda: inj.on_alloc(now % 3),
                     lambda: [s.kind for s in inj.take_poisons()],
                     lambda: inj.on_deliver(7, now % 4)):
            try:
                out.append(call())
            except exc as e:
                out.append(("raised", str(e)))
    return out, dict(inj.fired), inj.exhausted


def test_hooks_fire_once_on_the_clock_as_the_reference():
    specs = [dict(kind="step_exception", step=4),
             dict(kind="step_exception", step=2, phase="prefill"),
             dict(kind="alloc_failure", step=2, slot=1),
             dict(kind="hung_step", step=1, hang_s=0.0),
             dict(kind="nan_page", step=3), dict(kind="nan_logits", step=3),
             dict(kind="consumer_error", step=5, slot=1),
             dict(kind="consumer_stall", step=0, hang_s=0.0)]
    got = _drive(FaultInjector([FaultSpec(**s) for s in specs]),
                 InjectedFault)
    from repro.serve import InjectedFault as JFault
    want = _drive(JInjector([JSpec(**s) for s in specs]), JFault)
    assert got == want
    assert got[2] and got[1] == {k: (2 if k == "step_exception" else 1)
                                 for k in FAULT_KINDS}
    inj = FaultInjector([FaultSpec("alloc_failure", step=2, slot=1)])
    inj.tick(3)
    inj.on_alloc(0)                             # another slot: no fire
    with pytest.raises(InjectedFault, match="allocation failure"):
        inj.on_alloc(1)
    inj.on_alloc(1)                             # fired once


# ---------------------------------------------------------------------------
# the pool: quarantine, poison, consistency, reconcile, size_n_blocks
# ---------------------------------------------------------------------------


def _qbooks(pool, port: bool) -> dict:
    from test_torch_prefix_cache import _books
    q = pool._quarantined if port else pool._quarantined_by_shard[0]
    return dict(_books(pool, port), quarantined=sorted(q),
                pending=sorted(pool._quarantine_pending),
                n_quarantined=pool.n_quarantined_blocks,
                tally=pool.quarantined_blocks,
                allocatable=pool.allocatable_blocks)


def _same_report(got, want):
    assert {k: got[k] for k in want} == want


@pytest.fixture(scope="module")
def jmodel():
    return jget("llama3_1b", smoke=True)


@pytest.fixture(scope="module")
def model():
    return get_model("llama3_1b", smoke=True)


def _pools(model, jmodel, **kw):
    return PagedCachePool(model, device="cpu", **kw), JPool(jmodel, **kw)


def test_quarantine_matches_reference_pool(model, jmodel):
    """A slot's prefix blocks quarantined while another slot borrows two of
    them (forked off), then a pool so short that a fork finds no block
    (the borrower keeps it, quarantined on its release): the same books,
    reports and returned counts after every step."""
    rng = np.random.default_rng(1)
    p = rng.integers(0, 500, 12).astype(np.int32)
    for n_blocks in (16, 7):
        pool, ref = _pools(model, jmodel, n_slots=2, max_len=32,
                           block_size=4, n_blocks=n_blocks)

        def both(fn, *a):
            got, want = fn(pool, *a), fn(ref, *a)
            assert got == want
            assert _qbooks(pool, True) == _qbooks(ref, False)
            _same_report(pool.check_consistency(), ref.check_consistency())
            return got

        dig = pool.prefix_digests(p)
        s0 = both(lambda x: x.alloc_slot(12, 4, digests=dig))
        both(lambda x: x.ensure_range(s0, 0, 12))
        both(lambda x: x.register_prefix(s0, 12))
        if n_blocks == 7:
            both(lambda x: x.alloc_slot(4, 4))     # takes what is left
            both(lambda x: x.ensure_range(1, 0, 4))
            both(lambda x: x.ensure_block(1, 4))
            both(lambda x: x.quarantine_slot(s0))
            both(lambda x: x.free_slot(s0))
            both(lambda x: x.free_slot(1))
            assert pool.n_quarantined_blocks == 3
            continue
        s1 = both(lambda x: x.alloc_slot(12, 4, digests=dig))
        hit = pool.matched_tokens(s1)
        assert hit >= 8
        both(lambda x: x.ensure_range(s1, hit, 12))
        n = both(lambda x: x.quarantine_slot(s0))
        assert n >= 3
        both(lambda x: x.free_slot(s0))
        for pos in range(12, 15):
            both(lambda x: x.ensure_block(s1, pos))
        both(lambda x: x.free_slot(s1))
        # the chain was de-indexed: the prompt misses now, and never gets a
        # quarantined block
        s2 = both(lambda x: x.alloc_slot(12, 4, digests=dig))
        assert pool.matched_tokens(s2) == 0
        both(lambda x: x.ensure_range(s2, 0, 12))
        assert not set(pool._quarantined) & set(
            int(b) for b in pool.block_tables[s2])
        both(lambda x: x.free_slot(s2))
        assert pool.blocks_in_use == 0 and pool._reserved == 0


@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3", "fp8_e5m2"])
def test_poison_block_fills_nan_in_every_kv_leaf(kv):
    """NaN in every floating block-major leaf of the block, fp8 included
    (stored as NaN, not saturated), nothing else touched: as the
    reference's poison on its own pool."""
    tm = get_model("llama3_1b", smoke=True, kv_cache_dtype=kv)
    jm = jget("llama3_1b", smoke=True, kv_cache_dtype=kv)
    pool, ref = _pools(tm, jm, n_slots=1, max_len=16, block_size=4,
                       n_blocks=6)
    for x in (pool, ref):
        s = x.alloc_slot(8, 2)
        x.ensure_range(s, 0, 8)
    blk = int(pool.block_tables[0][1])
    other = int(pool.block_tables[0][0])
    for layer in pool.caches.values():
        for t in layer.values():
            t.fill_(1.0)
    pool.poison_block(blk)
    ref.poison_block(blk)
    hit = 0
    for name, layer in pool.caches.items():
        for leaf, t in layer.items():
            want = np.asarray(ref.caches[name][leaf][blk], np.float32)
            assert np.isnan(want).all()
            got = t[blk].float().numpy()
            assert np.isnan(got).all(), (name, leaf)
            assert (t[other].float() == 1.0).all()
            hit += 1
    assert hit == 2 * tm.cfg.n_layers


def test_reconcile_returns_the_references_dict(model, jmodel):
    """Cooked refcounts, a stranded block and a stranded block pending
    quarantine: the port's ``reconcile`` returned None before; it now
    returns the reference's dict, with the same values and books."""
    pool, ref = _pools(model, jmodel, n_slots=2, max_len=32, block_size=4,
                       n_blocks=12)
    for x, free in ((pool, pool._free_blocks),
                    (ref, ref._free_blocks_by_shard[0])):
        s = x.alloc_slot(12, 2)
        x.ensure_range(s, 0, 12)
        x._ref[int(x.block_tables[s][0])] += 2
        orphan = free.pop()
        x._ref[orphan] = 1
        pending = free.pop()
        x._ref[pending] = 1
        x._quarantine_pending.add(pending)
        assert not x.check_consistency()["ok"]
    got, want = pool.reconcile(), ref.reconcile()
    assert got == want == {"ref_fixed": 1, "orphans_rerouted": 2,
                           "consistent": True}
    assert _qbooks(pool, True) == _qbooks(ref, False)
    pool.free_slot(0)
    assert pool.blocks_in_use == 0 and pool.n_quarantined_blocks == 1


@pytest.mark.parametrize("profile,n_slots,block_size", [
    ([(12, 6)] * 4, 4, 16), ([(128, 32)] * 8, 4, 16),
    ([(5, 1), (40, 9), (17, 30), (3, 3)], 2, 4),
    ([(100, 50)] * 3 + [(10, 2)] * 5, 3, 8), ([(1, 1)], 1, 16)])
def test_size_n_blocks_matches_reference(profile, n_slots, block_size):
    for kw in ({}, dict(percentile=50.0, headroom=1.0),
               dict(percentile=100.0, headroom=2.0)):
        assert PagedCachePool.size_n_blocks(profile, n_slots, block_size,
                                            **kw) == \
            JPool.size_n_blocks(profile, n_slots, block_size, **kw)
    with pytest.raises(ValueError):
        PagedCachePool.size_n_blocks([], 2, 4)


def test_tripwire_reductions_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 2, 33)).astype(np.float32)
    x[1, -1, 4] = np.nan
    x[3, -1, 0] = np.inf
    x[4, 0, 2] = np.nan                      # not the last position
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tsteps.nonfinite_rows(t).numpy(),
        np.asarray(__import__("repro.launch.steps", fromlist=["x"])
                   .nonfinite_rows(jnp.asarray(x))))
    from repro.launch.steps import shadow_logit_mse as jmse
    y = x + rng.normal(scale=0.1, size=x.shape).astype(np.float32)
    for row in (0, 2):
        got = float(tsteps.shadow_logit_mse(t, torch.from_numpy(y), row))
        want = float(jmse(jnp.asarray(x), jnp.asarray(y), row))
        assert got == pytest.approx(want, rel=1e-6)
    assert np.isnan(float(tsteps.shadow_logit_mse(
        t, torch.from_numpy(y), 1)))
    mask = np.array([False, True, False, False, True])
    from repro.serve.faults import poison_logit_rows as jpoison
    got = poison_logit_rows(t, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(
        jpoison(jnp.asarray(x), jnp.asarray(mask)))))
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


# ---------------------------------------------------------------------------
# the fault matrix: every kind x lockstep / pipelined
# ---------------------------------------------------------------------------

MATRIX = [
    ("step_exception", dict(step=2, phase="decode")),
    ("step_exception", dict(step=0, phase="prefill")),
    ("nan_page", dict(step=2, slot=0, page=0)),
    ("nan_logits", dict(step=2, slot=1)),
    ("alloc_failure", dict(step=1, slot=2)),
    ("consumer_error", dict(step=2, slot=3)),
    ("consumer_stall", dict(step=2, hang_s=0.001)),
    ("hung_step", dict(step=2, phase="decode", hang_s=0.001)),
]


@pytest.mark.parametrize("sync", [False, True], ids=["pipelined", "lockstep"])
@pytest.mark.parametrize("kind,kw", MATRIX,
                         ids=[f"{k}-{kw.get('phase', 'any')}"
                              for k, kw in MATRIX])
def test_fault_matrix_matches_reference(pair, prompts, reference, kind, kw,
                                        sync):
    want, got, eng = _both(pair, prompts, [dict(kind=kind, **kw)], sync,
                           n_slots=4, max_len=32)
    _assert_contained(got, reference)
    f = got.counters["faults"]
    assert f["injected"] == {kind: 1}, f
    if kind in ("nan_page", "nan_logits"):
        assert f["seen"].get("nonfinite_logits", 0) >= 1
        assert f["quarantined_blocks"] >= 1
        assert any(r.status == "retried" for r in got.results.values())
    if kind == "consumer_error":
        assert [r.status for r in got.results.values()].count("failed") == 1
    if kind in ("consumer_stall", "hung_step"):
        assert all(r.status == "ok" for r in got.results.values())
    _books_clean(eng)


def test_retry_budget_exhausted_fails(pair, prompts, reference):
    """``max_retries=0``: the poisoned request retires ``failed`` with the
    tokens before its fault; nothing else is touched."""
    _, got, _ = _both(pair, prompts, [dict(kind="nan_logits", step=3,
                                           slot=1)], True,
                      n_slots=4, max_len=32, max_retries=0)
    _assert_contained(got, reference)
    failed = [r for r in got.results.values() if r.status == "failed"]
    assert len(failed) == 1 and len(failed[0].tokens) < 6
    assert got.counters["faults"]["failed"] == 1


@pytest.mark.parametrize("kind", ["step_exception", "hung_step"])
def test_kernel_faults_degrade_to_gather(pair, prompts, reference, kind):
    """``kernel_fault_limit`` step faults switch fused paged attention to
    the gather path mid-drain, with the reference's counters; on the CPU
    the two paths give the same tokens."""
    specs = [dict(kind=kind, step=1, hang_s=0.001),
             dict(kind=kind, step=3, hang_s=0.001)]
    _, got, eng = _both(pair, prompts, specs, True, n_slots=4, max_len=32,
                        max_retries=3, kernel_fault_limit=2)
    _assert_contained(got, reference)
    f = got.counters["faults"]
    assert f["kernel_faults"] == 2 and f["degraded_paged_attn"]
    assert eng.paged_attn == "gather" and got.counters["paged_attn"] == \
        "gather"
    want = "retried" if kind == "step_exception" else "ok"
    assert all(r.status == want for r in got.results.values())


def test_impossible_after_quarantine_fails_gracefully(pair):
    """Quarantine shrinks the pool below the retry's worst-case need: the
    request retires ``failed`` instead of ending the drain, as in the
    reference."""
    prompt = np.random.default_rng(7).integers(0, 500, 12).astype(np.int32)
    reqs = ([JRequest(rid=0, tokens=prompt, max_new_tokens=8)],
            [Request(rid=0, tokens=prompt, max_new_tokens=8)])
    _, got, eng = _both(pair, None, [dict(kind="nan_logits", step=1,
                                          slot=0)], True, reqs=reqs,
                        n_slots=2, max_len=32, block_size=4, n_blocks=7,
                        max_retries=2)
    assert got.results[0].status == "failed"
    f = got.counters["faults"]
    assert f["quarantined_blocks"] >= 4
    assert f["seen"].get("impossible_request", 0) == 1
    pool = eng._pool
    assert pool.check_consistency()["ok"]
    assert pool.n_quarantined_blocks == f["quarantined_blocks"]
    assert pool.allocatable_blocks == 6 - pool.n_quarantined_blocks
    # a request that never fit stays a configuration error
    with pytest.raises(ValueError, match="needs .* KV blocks"):
        _engine(pair[2], n_slots=2, max_len=64, block_size=4,
                n_blocks=7).serve(pair[3], [Request(
                    rid=0, tokens=np.arange(40, dtype=np.int32),
                    max_new_tokens=8)])


def test_pool_reused_cleanly_after_a_fault(pair, prompts, reference):
    """A drain with a NaN page leaves quarantined blocks out of circulation
    and clean books; the next drain on the same engine (its pool and index
    kept) serves the fault-free tokens, and no quarantined block appears
    in its tables."""
    _, _, tm, tp = pair
    eng = _engine(tm, n_slots=4, max_len=32, block_size=4, faults=(
        FaultInjector([FaultSpec("nan_page", step=2, slot=1, page=1)])))
    first = eng.serve(tp, _reqs(prompts))
    _assert_contained(first, reference)
    pool = eng._pool
    gone = set(pool._quarantined)
    assert gone and pool.check_consistency()["ok"]
    assert pool.reconcile() == {"ref_fixed": 0, "orphans_rerouted": 0,
                                "consistent": True}
    seen = set()
    orig = pool.ensure_block

    def watch(slot, pos):
        orig(slot, pos)
        seen.update(int(b) for b in pool.block_tables[slot] if b >= 0)
    pool.ensure_block = watch
    again = eng.serve(tp, _reqs(prompts))
    assert all(r.status == "ok" for r in again.results.values())
    _assert_contained(again, reference, allow=("ok",))
    assert seen and not seen & gone
    assert again.counters["faults"]["quarantined_blocks"] == 0
    assert pool.n_quarantined_blocks == len(gone)
    _books_clean(eng)


@pytest.mark.parametrize("sync", [False, True], ids=["pipelined", "lockstep"])
def test_injected_consumer_error_is_not_a_callback_error(pair, prompts,
                                                         reference, sync):
    """An injected consumer error is contained per request (no retry) and
    the callback keeps firing for everyone else; an ``on_token`` that
    raises cancels every request and re-raises, fault injector or not."""
    _, _, tm, tp = pair
    seen = []
    eng = _engine(tm, n_slots=4, max_len=32, faults=FaultInjector(
        [FaultSpec("consumer_error", step=1, slot=2)]))
    out = eng.serve(tp, _reqs(prompts), sync=sync,
                    on_token=lambda rid, i, t: seen.append((rid, i, t)))
    _assert_contained(out, reference)
    failed = [r for r in out.results.values() if r.status == "failed"]
    assert len(failed) == 1
    rid = failed[0].rid
    assert [i for r, i, _ in seen if r == rid] == list(
        range(len(failed[0].tokens)))
    assert sum(r != rid for r, _, _ in seen) == 6 * 3

    def boom(rid, i, tok):
        raise KeyError("client went away")
    eng = _engine(tm, n_slots=4, max_len=32, faults=FaultInjector(
        [FaultSpec("consumer_stall", step=1, hang_s=0.001)]))
    with pytest.raises(KeyError, match="client went away"):
        eng.serve(tp, _reqs(prompts), sync=sync, on_token=boom)
    _books_clean(eng)


def test_random_fault_schedules(pair):
    """Seeded random schedules over random request mixes: every request
    ends, the unaffected and retried ones bit-equal to the fault-free
    drain, the books clean; the JAX engine's statuses and counters on the
    same schedule (lockstep) equal the port's."""
    _, _, tm, tp = pair
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        ps = [rng.integers(0, 500, size=int(rng.integers(6, 14)))
              .astype(np.int32) for _ in range(int(rng.integers(3, 6)))]
        spec = [(i, p, int(rng.integers(2, 7)), int(rng.integers(0, 6)))
                for i, p in enumerate(ps)]
        reqs = [[cls(rid=i, tokens=p, max_new_tokens=m, arrival=a)
                 for i, p, m, a in spec] for cls in (JRequest, Request)]
        clean = _engine(tm, n_slots=3, max_len=32).serve(tp, reqs[1])
        ref = {i: np.asarray(r.tokens) for i, r in clean.results.items()}
        specs = [dict(vars(s), hang_s=0.001) for s in FaultInjector.random(
            seed, int(rng.integers(1, 5)), max_step=12, n_slots=3,
            max_pages=3).specs]
        _, got, eng = _both(pair, None, specs, True, reqs=reqs, n_slots=3,
                            max_len=32, max_retries=2)
        _assert_contained(got, ref)
        _books_clean(eng)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_under_faults_and_auto_pool(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--continuous", "--requests", "4",
          "--prompt-len", "12", "--new-tokens", "6", "--n-blocks", "auto",
          "--inject-faults", "nan_page@step=3;hung_step@step=5",
          "--max-retries", "1"])
    out = capsys.readouterr().out
    assert "auto-sized paged pool: 9 blocks (worst case 9)" in out
    assert "fault injection: 2 scheduled" in out
    assert "faults: injected hung_stepx1, nan_pagex1" in out
    assert "1 retried" in out


@pytest.mark.parametrize("argv,msg", [
    (["--adaptive-tau", "0.01", "--continuous"],
     "--adaptive-tau re-solves under load and needs --calibration or "
     "--registry"),
    (["--inject-faults", "nan_page@2"],
     "--inject-faults/--guardrail-every drive the continuous engine; pass "
     "--continuous"),
    (["--guardrail-every", "4"],
     "--inject-faults/--guardrail-every drive the continuous engine; pass "
     "--continuous"),
    (["--continuous", "--dense-slots", "--n-blocks", "auto"],
     "--n-blocks auto sizes the paged pool; drop --dense-slots"),
])
def test_launcher_refuses_as_the_reference(monkeypatch, argv, msg):
    import sys
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main
    base = ["--smoke", "--requests", "2", "--prompt-len", "8",
            "--new-tokens", "2"]
    with pytest.raises(SystemExit) as want:
        monkeypatch.setattr(sys, "argv", ["serve"] + base + argv)
        jmain()
    with pytest.raises(SystemExit) as got:
        main(base + ["--device", "cpu"] + argv)
    assert str(got.value) == str(want.value) == msg
