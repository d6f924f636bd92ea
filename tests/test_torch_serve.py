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

MARGIN_BOUND = 0.125        # as chip_smoke.py: 8 bf16 ulps at |logit| ~ 2-4
MARGIN_BOUND_MP = 0.25      # as chip_smoke.py under an fp8 MP plan
MP_ASSIGNMENT = {"layers/0/attn/q_proj": "fp8_e4m3",
                 "layers/1/mlp/down_proj": "fp8_e4m3",
                 "layers/1/attn/qk_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}


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


def assert_agree(got, ref, ref_margins, bound=MARGIN_BOUND):
    """Equal up to the first divergence; a divergence only at a near-tie."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    diff = np.nonzero(got != ref)[0]
    if diff.size:
        i = int(diff[0])
        assert ref_margins[i] < bound, (i, ref_margins[i], got, ref)


def _record_gaps(eng) -> list:
    """Wrap a one-shot engine's step closures (instance attributes; the
    shared memoized steps stay as they are) so that every call appends the
    (B,) gap between the two largest last-position logits."""
    gaps = []

    def wrap(step):
        def recorded(*args):
            logits, caches = step(*args)
            top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).numpy())
            return logits, caches
        return recorded

    for name in ("prefill_step", "bucketed_prefill_step", "decode_step"):
        setattr(eng, name, wrap(getattr(eng, name)))
    return gaps


def _oneshot(model, params, prompts, max_new, mp=None):
    """(tokens, top-two gaps), each (max_new,), per prompt from the port's
    one-shot engine, one prompt at a time."""
    eng = ServeEngine(model, mp=mp, device="cpu")
    gaps = _record_gaps(eng)
    out = []
    for p in prompts:
        gaps.clear()
        r = eng.generate(params, {"tokens": p[None]}, max_new_tokens=max_new)
        out.append((r.tokens[0], np.concatenate(gaps)))
    return out


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


@pytest.mark.parametrize("kw", [
    {"paged": False}, {"prefix_cache": True}, {"preemption": True},
    {"chunk_len": 8}, {"adaptive": object()}, {"faults": object()},
    {"guardrail": object()}, {"mesh": object()}])
def test_later_slices_refuse(model, kw):
    with pytest.raises(NotImplementedError, match="slice"):
        ContinuousBatchingEngine(model, device="cpu", **kw)


def test_pipelined_drain_refused(model, params):
    eng = ContinuousBatchingEngine(model, n_slots=1, max_len=16,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="pipelined"):
        eng.serve(params, [], sync=False)
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
