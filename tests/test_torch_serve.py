"""Serving in the port: the continuous engine (fused and gather decode
attention) against the port's one-shot engine, the paged pool, the MP plan
handoff, the scheduler against the reference scheduler, and the one-shot
engine against the reference ``ServeEngine`` on the same weights.

Token agreement. Two correct paths may sum in different orders, and a
greedy choice taken at a near-tie can then flip; after a flip the contexts
differ and the sequences part. So tokens must agree up to the first
divergence, and a divergence may sit only where the reference's top-two
logit gap is below ``MARGIN_BOUND`` — the rule ``chip_smoke.py`` applies on
the card. The reference is the port's one-shot engine; its gaps are read off
its step closures here (``_record_gaps``), since the engines compute no
diagnostics of their own. Where equality is bitwise it is asserted bitwise:
the first token of the fused and the gather engine comes from one shared
prefill step, and on the CPU every product is an f32 sum over the same
operands, so the CPU runs here in fact agree on every token."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.mpconfig import MPPlan as JPlan  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core.mpconfig import MPPlan, as_assignment  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.nn.spec import default_generator  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, PagedCachePool,  # noqa: E402
                               Request, Scheduler, ServeEngine)

from torch_serve_common import (  # noqa: E402
    DENSE_MLA, DS, MARGIN_BOUND_MP, MP_ASSIGNMENT, _oneshot, _record_gaps,
    _scenario, assert_agree)


@pytest.fixture(scope="module")
def model():
    return get_model("llama3_1b", smoke=True)


@pytest.fixture(scope="module")
def params(model):
    return model.init(default_generator(0, "cpu"), "cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, 500, size=12).astype(np.int32) for _ in range(4)]


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    orig = tpa.paged_decode_attention

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tpa, "paged_decode_attention", counting)
    return calls


def _serve(model, params, prompts, max_new, **kw):
    eng = ContinuousBatchingEngine(model, device="cpu", **kw)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=max_new, arrival=2 * i)
            for i, p in enumerate(prompts)]
    return eng.serve(params, reqs)


@pytest.mark.parametrize("paged_attn", ["fused", "gather"])
def test_continuous_matches_oneshot_staggered_slot_reuse(
        model, params, prompts, kernel_calls, paged_attn):
    """Four requests arriving every two steps through two slots (mid-decode
    admission and slot reuse); the fused engine reaches the kernel wrapper
    once per layer per decode step, the gather engine never."""
    ref = _oneshot(model, params, prompts, 6)
    summ = _serve(model, params, prompts, 6, n_slots=2, max_len=32,
                  block_size=4, paged_attn=paged_attn)
    assert sorted(summ.results) == [0, 1, 2, 3]
    for i, (tok, gaps) in enumerate(ref):
        res = summ.results[i]
        assert res.status == "ok" and len(res.tokens) == 6
        assert res.tokens[0] == tok[0]
        assert_agree(res.tokens, tok, gaps)
    c = summ.counters
    n_layers = model.cfg.n_layers
    assert len(kernel_calls) == (summ.n_steps * n_layers
                                 if paged_attn == "fused" else 0)
    assert c["paged_attn"] == paged_attn and c["kernel_launches"] == 0
    assert c["n_decode_steps"] == summ.n_steps > 0
    assert c["peak_slots_in_use"] == 2 and c["peak_blocks_in_use"] > 0
    assert summ.tokens_per_s > 0 and c["ttft_p50_s"] > 0


def test_fused_and_gather_first_tokens_bitwise(model, params, prompts):
    ref = _oneshot(model, params, prompts, 4)
    f = _serve(model, params, prompts, 4, n_slots=4, max_len=32,
               block_size=4, paged_attn="fused")
    g = _serve(model, params, prompts, 4, n_slots=4, max_len=32,
               block_size=4, paged_attn="gather")
    for i, (tok, gaps) in enumerate(ref):
        assert f.results[i].tokens[0] == g.results[i].tokens[0]
        assert_agree(f.results[i].tokens, tok, gaps)
        assert_agree(g.results[i].tokens, tok, gaps)


def test_tight_block_budget_backpressures(model, params, prompts):
    """A pool that holds one request at a time: admissions queue behind the
    block budget, every request still completes with the one-shot tokens."""
    ref = _oneshot(model, params, prompts[:3], 5)
    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=32,
                                   block_size=4, n_blocks=5, device="cpu")
    reqs = [Request(rid=i, tokens=p, max_new_tokens=5)
            for i, p in enumerate(prompts[:3])]
    summ = eng.serve(params, reqs)
    assert summ.counters["blocked_admissions"] > 0
    assert summ.counters["peak_blocks_in_use"] <= 4
    for i, (tok, gaps) in enumerate(ref):
        assert_agree(summ.results[i].tokens, tok, gaps)
    with pytest.raises(ValueError, match="KV blocks"):
        ContinuousBatchingEngine(model, n_slots=1, max_len=64, block_size=4,
                                 n_blocks=3, device="cpu").serve(
            params, [Request(rid=0, tokens=prompts[0], max_new_tokens=8)])


def test_mp_plan_continuous_matches_oneshot(model, params, prompts,
                                            kernel_calls):
    """Under an MP plan whose layer-1 qk_matmul is fp8, layer 1 takes the
    gather path (exact quantized semantics) and layer 0 the kernel."""
    plan = MPPlan(assignment=dict(MP_ASSIGNMENT), groups=[], objective="ET",
                  tau=0.01, budget=1.0, predicted_loss_mse=0.5,
                  predicted_gain=1.0)
    ref = _oneshot(model, params, prompts, 5, mp=plan)
    del kernel_calls[:]
    summ = _serve(model, params, prompts, 5, n_slots=2, max_len=32,
                  block_size=4, mp=plan)
    assert len(kernel_calls) == summ.n_steps * (model.cfg.n_layers - 1)
    for i, (tok, gaps) in enumerate(ref):
        assert_agree(summ.results[i].tokens, tok, gaps, MARGIN_BOUND_MP)


def test_plan_saved_by_reference_loads_and_applies(tmp_path, model, params,
                                                   prompts):
    jplan = JPlan(assignment=dict(MP_ASSIGNMENT, **{"layers/0/mlp/up_proj":
                                                    "bf16"}),
                  groups=[("layers/0/attn/q_proj",), ["lm_head"]],
                  objective="ET", tau=0.01, budget=2e-3,
                  predicted_loss_mse=1e-3, predicted_gain=0.25, ip_gap=0.0,
                  meta={"gain_tier": "analytic"})
    path = tmp_path / "plan.json"
    jplan.save(str(path))
    plan = MPPlan.load(str(path))
    assert plan.assignment == jplan.assignment
    assert plan.groups == jplan.groups and plan.meta == jplan.meta
    assert as_assignment(plan) == MP_ASSIGNMENT
    assert not plan.unknown_ops(model.serving_op_names())
    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=32,
                                   block_size=4, mp=plan, device="cpu")
    assert eng.mp == MP_ASSIGNMENT
    back = tmp_path / "back.json"
    plan.save(str(back))
    assert JPlan.load(str(back)) == jplan
    tok, gaps = _oneshot(model, params, prompts[:1], 4, mp=MP_ASSIGNMENT)[0]
    summ = eng.serve(params, [Request(rid=0, tokens=prompts[0],
                                      max_new_tokens=4)])
    assert_agree(summ.results[0].tokens, tok, gaps, MARGIN_BOUND_MP)


def _scheduler_trace(sched_cls, req_cls, seed: int) -> list:
    """Drive a scheduler through a random stream (priorities, arrivals, a
    capacity gate, finishes) and record every admission decision."""
    rng = np.random.default_rng(seed)
    sched = sched_cls()
    n = 12
    for i in rng.permutation(n):
        sched.submit(req_cls(rid=int(i), tokens=np.zeros(3, np.int32),
                             max_new_tokens=2,
                             arrival=int(rng.integers(0, 6)),
                             priority=int(rng.integers(0, 3))))
    trace, live, slot = [], [], 0
    for now in range(40):
        cap = int(rng.integers(0, 3))
        while True:
            st = sched.pop_admissible(now, lambda r: len(live) < cap)
            if st is None:
                break
            sched.start_prefill(st, slot, now)
            live.append(st)
            trace.append((now, st.request.rid, slot))
            slot += 1
        if live and rng.random() < 0.6:
            st = live.pop(int(rng.integers(0, len(live))))
            sched.finish_prefill(st.slot, 0, now)
            sched.retire(st, now)
        peek = sched.peek_admissible(now)
        trace.append(("peek", None if peek is None else peek.request.rid,
                      sched.queue_depth))
    trace.append(("blocked", sched.blocked_admissions, sched.next_arrival()))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_admission_order_matches_reference(seed):
    assert (_scheduler_trace(Scheduler, Request, seed)
            == _scheduler_trace(JScheduler, JRequest, seed))


def test_oneshot_matches_reference_serve_engine(prompts):
    """End to end across frameworks: the reference ``ServeEngine.generate``
    and the port's one-shot engine on the same bridged bf16 weights and
    prompts (the port's top-two gaps stand in for the reference's)."""
    jm = jget("llama3_1b", smoke=True)
    jp = jm.init(jax.random.key(0))
    tm = get_model("llama3_1b", smoke=True)
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    batch = np.stack(prompts)
    want = np.asarray(JServeEngine(jm, donate=False).generate(
        jp, {"tokens": jnp.asarray(batch)}, max_new_tokens=6).tokens)
    eng = ServeEngine(tm, device="cpu")
    gaps = _record_gaps(eng)
    got = eng.generate(tp, {"tokens": batch}, max_new_tokens=6)
    gaps = np.stack(gaps, axis=1)
    for i in range(len(prompts)):
        assert_agree(want[i], got.tokens[i], gaps[i])


class _TwoDataRanks:
    """A mesh's axis names and sizes, no process group."""
    mesh_dim_names = ("data", "model")
    shape = (2, 1)


@pytest.mark.parametrize("kw", [{"mesh": _TwoDataRanks()}])
def test_later_slices_refuse(model, kw):
    """The engine and the trainer run over a mesh since A9b; what a later
    slice still has to write is refused by name: Adafactor over more than
    one rank (ROADMAP A9d), before any collective."""
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    with pytest.raises(NotImplementedError, match="ROADMAP item A9d"):
        Trainer(model, OptConfig(name="adafactor"), kw["mesh"],
                TrainerConfig(), device="cpu")


def test_pipelined_drain_refused(model, params):
    """The pipelined drain is the default now; what it refuses is a depth
    below one step in flight."""
    eng = ContinuousBatchingEngine(model, n_slots=1, max_len=16,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_in_flight"):
        eng.serve(params, [], max_in_flight=0)
    assert eng.serve(params, []).counters["sync"] is False
    with pytest.raises(ValueError, match="paged_attn"):
        ContinuousBatchingEngine(model, paged_attn="flash", device="cpu")


def test_paged_pool_accounting(model):
    pool = PagedCachePool(model, n_slots=2, max_len=16, block_size=4,
                          n_blocks=7, device="cpu")
    assert pool.allocatable_blocks == 6 and pool.blocks_in_use == 0
    assert pool.blocks_for_request(5, 4) == 2      # 5 + 3 writes -> 8 tokens
    s0 = pool.alloc_slot(5, 4)
    assert s0 == 0 and pool.can_admit(13, 4)       # 2 reserved + 4 <= 6
    assert not pool.can_admit(17, 4)               # 2 reserved + 5 > 6
    pool.ensure_range(s0, 0, 5)
    assert pool.block_tables[s0].tolist() == [1, 2, -1, -1]
    pool.ensure_block(s0, 8)                       # reservation exhausted
    assert pool.block_tables[s0, 2] == 3 and pool.blocks_in_use == 3
    dev = pool.block_tables_device()
    pool.free_slot(s0)
    assert dev[0].tolist() == [1, 2, 3, -1]        # a private copy
    assert pool.blocks_in_use == 0 and pool.n_free_slots == 2
    assert pool.alloc_slot(2, 1) == 0              # slot 0 is reused first
    with pytest.raises(ValueError):
        pool.free_slot(1)
    with pytest.raises(ValueError, match="allocatable"):
        pool.alloc_slot(40, 1)


def test_launcher_runs_on_the_host(tmp_path, capsys):
    from repro_torch.launch.serve import main
    path = tmp_path / "plan.json"
    MPPlan(assignment={"layers/9/attn/q_proj": "fp8_e4m3"}, groups=[],
           objective="ET", tau=0.0, budget=0.0, predicted_loss_mse=0.0,
           predicted_gain=0.0).save(str(path))
    main(["--smoke", "--device", "cpu", "--continuous", "--requests", "3",
          "--prompt-len", "10", "--new-tokens", "4", "--mp-plan", str(path),
          "--profile", str(tmp_path / "trace.json")])
    out = capsys.readouterr().out
    assert "WARNING: 1 plan ops not in this model" in out
    assert "continuous: 3 reqs via 4 slots" in out
    assert "profile: device busy 0.0 ms" in out           # no device here
    assert (tmp_path / "trace.json").stat().st_size > 0
    main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "10",
          "--new-tokens", "3"])
    assert "TTFT" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# prefix caching, priority preemption and chunked prefill
# ---------------------------------------------------------------------------

def test_uniform_priority_never_preempts(model, params, prompts):
    """At uniform priority the preemption path is inert: block pressure
    is head-of-line backpressure; with preemption off, priorities still
    admit in class order and never evict."""
    eng = ContinuousBatchingEngine(model, n_slots=4, max_len=32,
                                   block_size=4, n_blocks=9, device="cpu")
    assert eng.preemption
    reqs = [Request(rid=i, tokens=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    summ = eng.serve(params, reqs)
    assert summ.counters["preemptions"] == 0
    assert summ.counters["blocked_admissions"] > 0
    eng2 = ContinuousBatchingEngine(model, n_slots=4, max_len=32,
                                    block_size=4, n_blocks=9,
                                    preemption=False, device="cpu")
    reqs2 = [Request(rid=i, tokens=p, max_new_tokens=6, priority=i % 2)
             for i, p in enumerate(prompts)]
    summ2 = eng2.serve(params, reqs2)
    assert summ2.counters["preemptions"] == 0
    assert set(summ2.results) == set(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(summ.results[i].tokens,
                                      summ2.results[i].tokens)


def test_random_mix_respects_chunk_budget(model, params):
    """A random prompt-length mix never stalls a decoding slot for more
    than ``chunk_budget`` chunk steps in a row, and keeps the one-shot
    tokens."""
    rng = np.random.default_rng(19)
    lens = rng.integers(1, 30, size=6)
    ps = [rng.integers(0, 500, size=int(n)).astype(np.int32) for n in lens]
    ref = _oneshot(model, params, ps, 3)
    eng = ContinuousBatchingEngine(model, n_slots=3, max_len=40,
                                   block_size=4, chunk_len=8, chunk_budget=2,
                                   device="cpu")
    reqs = [Request(rid=i, tokens=p, max_new_tokens=3,
                    arrival=int(rng.integers(0, 4)))
            for i, p in enumerate(ps)]
    summ = eng.serve(params, reqs)
    for i, (tok, gaps) in enumerate(ref):
        assert_agree(summ.results[i].tokens, tok, gaps)
    assert summ.counters["max_decode_stall_run"] <= 2
    assert summ.counters["prefill_chunks"] >= sum(
        -(-int(n) // 8) for n in lens) / 3   # co-batching can merge, not skip
    assert "decode_stall_p99_s" in summ.counters


def test_second_drain_hits_the_prefix_cache(model, params):
    """The pool and its index outlive the drain: the same prompts served
    again hit every full block (and fork the tail), with the same tokens;
    other weights drop the index."""
    _, reqs = _scenario("share")
    rs = [Request(rid=rid, tokens=p, max_new_tokens=m, arrival=a)
          for rid, p, m, a, _ in reqs[:3]]
    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=40,
                                   block_size=4, device="cpu")
    first = eng.serve(params, rs)
    pool = eng._pool
    caches = {k: dict(d) for k, d in pool.caches.items()}
    second = eng.serve(params, rs)
    assert eng._pool is pool and all(
        pool.caches[k][n] is t for k, d in caches.items()
        for n, t in d.items())
    assert first.counters["prefix_hit_requests"] == 2
    assert second.counters["prefix_hit_requests"] == 3
    assert second.counters["cow_forks"] == 3
    assert second.counters["prefill_tokens"] == 3
    for rid in first.results:
        np.testing.assert_array_equal(second.results[rid].tokens,
                                      first.results[rid].tokens)
    other = model.init(default_generator(7, "cpu"), "cpu")
    third = eng.serve(other, rs)
    fresh = ContinuousBatchingEngine(model, n_slots=2, max_len=40,
                                     block_size=4, device="cpu").serve(
        other, rs)
    assert third.counters["prefix_hit_requests"] == 2
    for rid in fresh.results:
        np.testing.assert_array_equal(third.results[rid].tokens,
                                      fresh.results[rid].tokens)
    # a weight changed in place drops the index too
    other["layers"]["1"]["mlp"]["up_proj"]["w"].mul_(1.5)
    assert eng.serve(other, rs).counters["prefix_hit_requests"] == 2


def test_fork_leaves_the_parent_block_unchanged(model, params):
    """A full-prompt hit reads borrowed pages and writes its tail into a
    fresh fork: every block of the parent's prompt holds, after the drain,
    the bytes a drain of the parent alone leaves there."""
    p = np.random.default_rng(3).integers(0, 500, size=16).astype(np.int32)
    pools = []
    for n in (1, 2):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_len=32,
                                       block_size=4, device="cpu")
        summ = eng.serve(params, [Request(rid=i, tokens=p, max_new_tokens=4,
                                          arrival=3 * i) for i in range(n)])
        assert summ.counters["cow_forks"] == n - 1
        pools.append(eng._pool)
    blocks = pools[0]._match_blocks(pools[0].prefix_digests(p))
    assert len(blocks) == 4
    assert pools[1]._match_blocks(pools[1].prefix_digests(p)) == blocks
    for layer, d in pools[0].caches.items():
        for name, t in d.items():
            assert torch.equal(pools[1].caches[layer][name][blocks],
                               t[blocks]), (layer, name)


def test_engine_defaults_and_refusals(model):
    eng = ContinuousBatchingEngine(model, device="cpu")
    assert eng.prefix_cache and eng.preemption and eng.chunk_len is None
    assert eng.chunk_budget == 1
    assert not ContinuousBatchingEngine(model, prefix_cache=False,
                                        device="cpu").prefix_cache
    mla = get_model(DS, smoke=True, **DENSE_MLA)
    assert ContinuousBatchingEngine(mla, device="cpu").prefix_cache
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousBatchingEngine(model, paged=False, prefix_cache=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="chunk_len"):
        ContinuousBatchingEngine(model, chunk_len=0, device="cpu")


def test_prefill_bucket_clamped_to_chunk_len():
    from repro_torch.serve import prefill_bucket
    assert prefill_bucket(5) == 8 and prefill_bucket(9) == 16
    assert prefill_bucket(100, 100) == 100 and prefill_bucket(3, 4) == 4
    assert prefill_bucket(3, 6, min_bucket=2) == 4
    with pytest.raises(ValueError):
        prefill_bucket(9, 8)


def test_drain_that_raises_leaves_a_usable_engine(model, params, prompts):
    """A drain that raises with slots in use leaves books the next drain
    cannot trust: it gets a new pool with an empty index over the same
    cache tensors (zeroed), and serves as a fresh engine does."""
    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=24,
                                   block_size=4, device="cpu")
    too_long = np.zeros(20, np.int32)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.serve(params, [Request(rid=0, tokens=prompts[0], max_new_tokens=6),
                           Request(rid=1, tokens=too_long, max_new_tokens=6,
                                   arrival=2)])
    old = eng._pool
    assert old.n_free_slots < 2 and old._index
    leaves = [t for d in old.caches.values() for t in d.values()]
    reqs = [Request(rid=i, tokens=p, max_new_tokens=4, arrival=i)
            for i, p in enumerate(prompts[:3])]
    got = eng.serve(params, reqs)
    assert eng._pool is not old and got.counters["prefix_hit_requests"] == 0
    assert all(a is b for a, b in zip(
        (t for d in eng._pool.caches.values() for t in d.values()), leaves))
    want = ContinuousBatchingEngine(model, n_slots=2, max_len=24,
                                    block_size=4, device="cpu").serve(
        params, reqs)
    for rid in want.results:
        np.testing.assert_array_equal(got.results[rid].tokens,
                                      want.results[rid].tokens)
