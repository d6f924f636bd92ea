"""Load-adaptive MP and the numerical guardrail in the port
(``repro_torch.serve.adaptive`` and the engine's swap and shadow step)
against the reference (``repro.serve.adaptive``): the controller and the
guardrail driven by the same signal sequences (the cases of
``tests/test_adaptive.py`` and ``tests/test_faults.py``), the ladder's plans
solved from one bundle carried across the packages, and the engine: a
controller that never fires and a swap to the same plan give the
fixed-plan tokens, a downshift-restore cycle (its counters the JAX
engine's) drops the prefix index at each swap, a forced breach restores
mid-drain with and without a controller, an honest plan never breaches, and
a shadow step at every decode step leaves the tokens and the caches bit for
bit as they are without one (paged, fp8 KV, dense rings, windowed rings)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.core.mpconfig import MPPlan as JPlan  # noqa: E402
from repro.core.pipeline import CalibrationBundle as JBundle  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.serve import AdaptiveMPController as JController  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import NumericalGuardrail as JGuardrail  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core import pipeline as tpl  # noqa: E402
from repro_torch.core.mpconfig import MPPlan  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import (AdaptiveMPController,  # noqa: E402
                               ContinuousBatchingEngine, FaultInjector,
                               FaultSpec, NumericalGuardrail, Request)

MP_ASSIGNMENT = {"layers/0/attn/q_proj": "fp8_e4m3",
                 "layers/1/mlp/down_proj": "fp8_e4m3",
                 "lm_head": "fp8_e4m3"}


class FakeBundle:
    """Counts solves; plans by tau, or a stand-in dict."""

    def __init__(self, plans=None):
        self.plans = plans
        self.solved = []

    def solve(self, tau=None, objective=None, **kw):
        self.solved.append((tau, objective))
        if self.plans is not None:
            return self.plans[tau]
        return {"tau": tau, "objective": objective}


HOT = dict(queue_depth=99, blocked=0, occupancy=1.0)
COOL = dict(queue_depth=0, blocked=0, occupancy=0.0)
HOLD = dict(queue_depth=2, blocked=0, occupancy=0.7)


def _signals(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    out, blocked = [], 0
    for t in range(n):
        blocked += int(rng.integers(0, 2) * (rng.random() < 0.2))
        out.append((t, dict(queue_depth=int(rng.integers(0, 8)),
                            blocked=blocked,
                            occupancy=float(rng.random()),
                            stall_p99=float(rng.random() * 0.02))))
    return out


# (controller kwargs, [(now, signals)]): the cases of test_adaptive.py
# (escalate/hold/restore, one level per evaluation, cadence keeping the
# blocked signal, re-observing a tick, dwell under flip-flop load, a clock
# restart with a fresh blocked counter) and seeded random traces
SCENARIOS = {
    "escalate_hold_restore": ({}, [(0, HOT), (1, HOLD), (2, COOL),
                                   (3, COOL)]),
    "one_level_per_evaluation": ({}, [(t, HOT) for t in range(4)]),
    "cadence_keeps_blocked": (dict(every=4), [(0, COOL), (1, HOT), (2, HOT),
                                              (3, HOT), (4, dict(
                                                  queue_depth=0, blocked=2,
                                                  occupancy=0.0))]),
    "reobserve_tick": ({}, [(0, HOT), (0, HOT), (0, HOT)]),
    "dwell_flip_flop": (dict(dwell=5), [(t, (HOT, COOL)[t % 2])
                                        for t in range(30)]),
    "clock_restart": (dict(every=4, dwell=8), [
        (0, COOL), (4, HOT), (0, dict(queue_depth=0, blocked=1,
                                      occupancy=0.0)), (1, HOT), (9, COOL)]),
    "restart_then_restore": (dict(every=1, dwell=0), [(10, HOT),
                                                      (0, COOL)]),
    "random_0": (dict(every=2, dwell=3, stall_high_s=0.015), _signals(0)),
    "random_1": (dict(every=1, dwell=5, occ_high=0.8, occ_low=0.3),
                 _signals(1)),
}


def _ctrl_state(c) -> tuple:
    return (c.history, c.level, c.downshifts, c.restores,
            c.guardrail_restores, c._last_eval, c._last_swap,
            c._blocked_seen)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decides_as_the_reference(name):
    kw, trace = SCENARIOS[name]
    base = dict(taus=(0.01, 0.02, 0.04), every=1, dwell=0, queue_high=4,
                queue_low=0)
    base.update(kw)
    got = AdaptiveMPController(bundle=FakeBundle(), **base)
    want = JController(bundle=FakeBundle(), **base)
    for i, (now, sig) in enumerate(trace):
        a, b = got.observe(now, **sig), want.observe(now, **sig)
        assert a == b, (i, now)
        assert _ctrl_state(got) == _ctrl_state(want), (i, now)
        if name == "dwell_flip_flop" and i == 20:
            assert got.force_restore(now) == want.force_restore(now)
    assert _ctrl_state(got) == _ctrl_state(want)
    assert got.bundle.solved == want.bundle.solved
    if name == "dwell_flip_flop":
        ticks = [t for t, _, _ in got.history]
        assert ticks and got.guardrail_restores == 1


def test_controller_refusals_and_ladder_match_reference():
    for kw in (dict(taus=(0.02, 0.01)), dict(taus=()), dict(every=0),
               dict(dwell=-1), dict(queue_high=1, queue_low=2),
               dict(occ_high=0.3, occ_low=0.5)):
        full = dict(dict(taus=(0.01, 0.02)), **kw)
        with pytest.raises(ValueError):
            AdaptiveMPController(bundle=FakeBundle(), **full)
        with pytest.raises(ValueError):
            JController(bundle=FakeBundle(), **full)
    got = AdaptiveMPController.from_bundle(FakeBundle(), 0.01, n_levels=4,
                                           factor=3.0)
    assert got.taus == JController.from_bundle(
        FakeBundle(), 0.01, n_levels=4, factor=3.0).taus
    p = got.plan_for(2)
    assert got.plan_for(2) is p and len(got.bundle.solved) == 1


def _plan(cls, assignment, budget, tau=0.01):
    return cls(assignment=dict(assignment), groups=[list(assignment)],
               objective="ET", tau=tau, budget=budget,
               predicted_loss_mse=budget, predicted_gain=1.0)


def _grail_state(g) -> tuple:
    return (g.checks, g.breaches, g.last_mse, g.restored_at, g.history)


@pytest.mark.parametrize("kw", [dict(every=4, margin=2.0, max_breaches=2),
                                dict(budget=0.25), dict(margin=0.5)])
def test_guardrail_decides_as_the_reference(kw):
    got, want = NumericalGuardrail(**kw), JGuardrail(**kw)
    seq = [(0, 1.0, None), (4, float("nan"), 1e-6), (8, 1.0, 1e-6),
           (12, 1.0, 1e-6), (16, 1e-9, 1e-6), (20, 1.0, 1e-6),
           (24, 0.3, 0.1)]
    for now, mse, budget in seq:
        assert got.observe_mse(now, mse, budget) == \
            want.observe_mse(now, mse, budget)
        a, b = _grail_state(got), _grail_state(want)
        assert a[:2] == b[:2] and a[3:] == b[3:]
        assert (a[2] == b[2]) or (np.isnan(a[2]) and np.isnan(b[2]))
    for plan in (_plan(MPPlan, MP_ASSIGNMENT, 0.5), object(), {"a": 1}):
        jplan = (_plan(JPlan, MP_ASSIGNMENT, 0.5)
                 if isinstance(plan, MPPlan) else plan)
        assert got.budget_for(plan) == want.budget_for(jplan)
    for bad in (dict(every=0), dict(margin=0), dict(max_breaches=0)):
        with pytest.raises(ValueError):
            NumericalGuardrail(**bad)


@pytest.fixture(scope="module")
def pair():
    """The float32 smoke llama3_1b in both packages, same weights."""
    jm = jget("llama3_1b", smoke=True, dtype="float32")
    jp = jm.init(jax.random.key(0))
    tm = get_model("llama3_1b", smoke=True, dtype="float32")
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def bundle_path(pair, tmp_path_factory):
    """The port's calibration of the smoke model, saved: both packages load
    it."""
    _, _, tm, tp = pair
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, tm.cfg.vocab_size, (2, 32))
                .astype(np.int32),
                "labels": rng.integers(0, tm.cfg.vocab_size, (2, 32))
                .astype(np.int32)} for _ in range(2)]
    path = str(tmp_path_factory.mktemp("bundle") / "b.npz")
    tpl.calibrate(tm, tp, batches, tpl.AMPOptions()).save(path)
    return path


def test_ladder_plans_match_reference(bundle_path):
    """Every ladder level solves to the same assignment in both packages
    from the one bundle; the ladder reaches more quantized ops."""
    kw = dict(n_levels=3, factor=3.0, objective="ET")
    got = AdaptiveMPController.from_bundle(
        tpl.CalibrationBundle.load(bundle_path), 1e-4, **kw)
    want = JController.from_bundle(JBundle.load(bundle_path), 1e-4, **kw)
    sizes = []
    for level in range(3):
        a, b = got.plan_for(level), want.plan_for(level)
        assert a.assignment == b.assignment, level
        assert a.budget == pytest.approx(b.budget, rel=1e-12)
        sizes.append(a.n_quantized)
    assert sizes == sorted(sizes) and sizes[-1] > sizes[0]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, 500, size=12).astype(np.int32) for _ in range(4)]


def _reqs(prompts, cls=Request, max_new=5, arrivals=None):
    return [cls(rid=i, tokens=p, max_new_tokens=max_new,
                arrival=0 if arrivals is None else arrivals[i])
            for i, p in enumerate(prompts)]


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _tokens(summ) -> dict:
    return {i: np.asarray(r.tokens) for i, r in summ.results.items()}


def _same_tokens(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for i in a:
        np.testing.assert_array_equal(a[i], b[i], err_msg=str(i))


@pytest.fixture(scope="module")
def fixed_mp(pair, prompts):
    """The fixed-plan drain, all four at tick 0 and staggered."""
    _, _, tm, tp = pair
    out = {}
    for name, arr in (("burst", None), ("staggered", [0, 0, 4, 4])):
        eng = _engine(tm, n_slots=2, max_len=32, mp=MP_ASSIGNMENT)
        out[name] = _tokens(eng.serve(tp, _reqs(prompts, arrivals=arr)))
    return out


def test_engine_refuses_mp_with_adaptive(pair):
    ctrl = AdaptiveMPController(bundle=FakeBundle({0.01: {}}), taus=(0.01,))
    with pytest.raises(ValueError, match="not both"):
        _engine(pair[2], mp=MP_ASSIGNMENT, adaptive=ctrl)


def test_never_firing_controller_gives_the_fixed_plan(pair, prompts,
                                                      fixed_mp):
    _, _, tm, tp = pair
    ctrl = AdaptiveMPController(bundle=FakeBundle({0.01: MP_ASSIGNMENT}),
                                taus=(0.01,), every=1, dwell=0, queue_high=1)
    eng = _engine(tm, n_slots=2, max_len=32, adaptive=ctrl)
    assert eng.mp == MP_ASSIGNMENT
    summ = eng.serve(tp, _reqs(prompts))
    _same_tokens(_tokens(summ), fixed_mp["burst"])
    c = summ.counters["adaptive"]
    assert c["swaps"] == [] and c["downshifts"] == c["restores"] == 0
    assert c["final_level"] == 0 and c["taus"] == [0.01]


@pytest.mark.parametrize("sync", [False, True], ids=["pipelined", "lockstep"])
def test_swap_to_the_same_plan_gives_the_fixed_plan(pair, prompts, fixed_mp,
                                                    sync):
    """Two levels solving to the same assignment: the swaps run the whole
    machinery mid-drain (other memoized steps, the index dropped) and the
    tokens are the fixed plan's, bit for bit."""
    _, _, tm, tp = pair
    ctrl = AdaptiveMPController(
        bundle=FakeBundle({0.01: MP_ASSIGNMENT, 0.02: dict(MP_ASSIGNMENT)}),
        taus=(0.01, 0.02), every=1, dwell=2, queue_high=2)
    eng = _engine(tm, n_slots=2, max_len=32, adaptive=ctrl)
    summ = eng.serve(tp, _reqs(prompts, arrivals=[0, 0, 4, 4]), sync=sync)
    c = summ.counters["adaptive"]
    assert c["downshifts"] >= 1
    steps = [s["step"] for s in c["swaps"]]
    assert steps == sorted(steps) and len(set(steps)) == len(steps)
    assert all(b - a >= 2 for a, b in zip(steps, steps[1:]))
    _same_tokens(_tokens(summ), fixed_mp["staggered"])


def test_downshift_restore_cycle_matches_reference(pair, prompts):
    """A burst past the high watermark, then a drain below the low one: a
    full downshift -> restore cycle with the JAX engine's swaps, levels and
    statuses on the same weights; each swap drops the prefix index."""
    jm, jp, tm, tp = pair
    kw = dict(taus=(0.01, 0.04), every=1, dwell=1, queue_high=3,
              queue_low=0, occ_high=0.9, occ_low=0.5)
    plans = {0.01: {}, 0.04: dict(MP_ASSIGNMENT)}
    ekw = dict(n_slots=2, max_len=32, block_size=4, n_blocks=64)
    jeng = JEngine(jm, adaptive=JController(bundle=FakeBundle(plans), **kw),
                   **ekw)
    jeng.serve(jp, _reqs(prompts[:1], JRequest, 1))
    want = jeng.serve(jp, _reqs(prompts * 2, JRequest, 4), sync=True)
    ctrl = AdaptiveMPController(bundle=FakeBundle(plans), **kw)
    eng = _engine(tm, adaptive=ctrl, **ekw)
    dropped = []
    eng.serve(tp, _reqs(prompts[:1], max_new=1))      # makes the pool
    orig = eng._pool.invalidate_prefix_index

    def invalidate():
        dropped.append(len(eng._pool._index))
        orig()
        assert not eng._pool._index
    eng._pool.invalidate_prefix_index = invalidate
    summ = eng.serve(tp, _reqs(prompts * 2, max_new=4), sync=True)
    c, w = summ.counters["adaptive"], want.counters["adaptive"]
    assert c == w
    assert c["downshifts"] >= 1 and c["restores"] >= 1
    assert c["final_level"] == 0 and not eng.mp
    assert len(dropped) == len(c["swaps"]) and max(dropped) > 0
    for i, r in summ.results.items():
        assert r.status == want.results[i].status == "ok"
        assert len(r.tokens) == 4


@pytest.mark.parametrize("controller", [False, True])
def test_forced_breach_restores_mid_drain(pair, prompts, controller):
    """A plan whose budget is far below its real error breaches at the
    first shadow check; the engine restores the base plan (the unquantized
    one, or level 0 through the controller) mid-drain, with the JAX
    engine's checks, breaches and restore step; the next drain on the
    engine serves the plain tokens and checks nothing."""
    jm, jp, tm, tp = pair
    if controller:
        def plans(cls):
            return {0.01: {}, 0.04: _plan(cls, MP_ASSIGNMENT, 1e-14, 0.04)}
        ckw = dict(taus=(0.01, 0.04), every=1000, dwell=1000)
        jc = JController(bundle=FakeBundle(plans(JPlan)), **ckw)
        tc = AdaptiveMPController(bundle=FakeBundle(plans(MPPlan)), **ckw)
        jc.level = tc.level = 1
        jkw, tkw = dict(adaptive=jc), dict(adaptive=tc)
    else:
        jkw = dict(mp=_plan(JPlan, MP_ASSIGNMENT, 1e-14, 1e-7))
        tkw = dict(mp=_plan(MPPlan, MP_ASSIGNMENT, 1e-14, 1e-7))
    want = JEngine(jm, n_slots=4, max_len=32,
                   guardrail=JGuardrail(every=2, margin=2.0), **jkw).serve(
        jp, _reqs(prompts, JRequest), sync=True)
    grail = NumericalGuardrail(every=2, margin=2.0)
    eng = _engine(tm, n_slots=4, max_len=32, guardrail=grail, **tkw)
    summ = eng.serve(tp, _reqs(prompts), sync=True)
    g, wg = summ.counters["guardrail"], want.counters["guardrail"]
    for key in ("every", "margin", "checks", "breaches", "restored_at"):
        assert g[key] == wg[key], key
    assert g["breaches"] >= 1 and g["restored_at"] is not None
    assert [s["step"] for s in g["swaps"]] == [s["step"] for s in
                                               wg["swaps"]]
    assert g["swaps"][0]["mse"] > g["swaps"][0]["budget"]
    assert not eng.mp
    if controller:
        assert tc.level == 0 and tc.guardrail_restores == 1
    again = eng.serve(tp, _reqs(prompts))
    plain = _engine(tm, n_slots=4, max_len=32).serve(tp, _reqs(prompts))
    _same_tokens(_tokens(again), _tokens(plain))
    assert again.counters["guardrail"]["checks"] == g["checks"]


def test_honest_plan_never_breaches(pair, prompts):
    _, _, tm, tp = pair
    grail = NumericalGuardrail(every=3)
    eng = _engine(tm, n_slots=4, max_len=32,
                  mp=_plan(MPPlan, MP_ASSIGNMENT, 1e6), guardrail=grail)
    eng.serve(tp, _reqs(prompts))
    assert grail.checks >= 1 and grail.breaches == 0
    assert grail.last_mse is not None and np.isfinite(grail.last_mse)
    assert grail.last_mse > 0


def _caches(eng) -> dict:
    """Every cache tensor of the engine's pool but the trash block (vacant
    rows write there in no fixed order)."""
    out = {}
    for layer, leaves in eng._pool.caches.items():
        for leaf, t in leaves.items():
            out[(layer, leaf)] = (t[1:] if eng.paged else t).clone()
    return out


SHADOW_CASES = {
    "paged": (dict(), dict()),
    "paged_fp8_kv": (dict(kv_cache_dtype="fp8_e4m3"), dict()),
    "paged_gather": (dict(), dict(paged_attn="gather")),
    "dense": (dict(), dict(paged=False)),
    "dense_window": (dict(sliding_window=8), dict(paged=False, chunk_len=8)),
}


@pytest.mark.parametrize("case", sorted(SHADOW_CASES))
def test_shadow_at_every_step_changes_nothing(pair, prompts, case):
    """The shadow step writes the K/V of its inputs into the same cache
    slots as the active step, which runs after it and rewrites each of
    them before its attention reads it: with a shadow at every decode
    step (and no breach) the tokens, and the caches after the drain, are
    bit for bit those of the drain without one. A step that raises after
    the shadow would have run leaves the retried tokens as they are."""
    mkw, ekw = SHADOW_CASES[case]
    tm = get_model("llama3_1b", smoke=True, dtype="float32", **mkw)
    tp = pair[3]
    # K and V projections in fp8: the shadow's K/V differ from the active
    # step's, so a slot the active step did not rewrite would show
    kv_plan = dict(MP_ASSIGNMENT, **{"layers/0/attn/k_proj": "fp8_e4m3",
                                     "layers/1/attn/v_proj": "fp8_e4m3"})
    kw = dict(n_slots=2, max_len=32, mp=_plan(MPPlan, kv_plan, 1e6), **ekw)
    arrivals = [0, 1, 3, 6]
    base = _engine(tm, **kw)
    want = base.serve(tp, _reqs(prompts, arrivals=arrivals), sync=True)
    grail = NumericalGuardrail(every=1)
    eng = _engine(tm, guardrail=grail, **kw)
    got = eng.serve(tp, _reqs(prompts, arrivals=arrivals), sync=True)
    assert grail.checks == got.n_steps == want.n_steps
    assert grail.breaches == 0 and grail.last_mse > 0
    _same_tokens(_tokens(got), _tokens(want))
    a, b = _caches(eng), _caches(base)
    for key in b:
        assert torch.equal(a[key].view(torch.uint8) if a[key].dtype in (
            torch.float8_e4m3fn, torch.float8_e5m2) else a[key],
            b[key].view(torch.uint8) if b[key].dtype in (
                torch.float8_e4m3fn, torch.float8_e5m2) else b[key]), key
    if case == "paged":
        faulted = _engine(tm, guardrail=NumericalGuardrail(every=1),
                          faults=FaultInjector([FaultSpec(
                              "step_exception", step=3)]), **kw)
        out = faulted.serve(tp, _reqs(prompts, arrivals=arrivals))
        assert {r.status for r in out.results.values()} >= {"retried"}
        _same_tokens(_tokens(out), _tokens(want))


def test_launcher_drives_the_ladder_and_the_guardrail(bundle_path, capsys):
    from repro_torch.launch.serve import main
    base = ["--smoke", "--device", "cpu", "--continuous", "--n-slots", "2",
            "--requests", "6", "--arrival-every", "0", "--prompt-len", "12",
            "--new-tokens", "4", "--no-prefix-cache"]
    # the launcher's weights are seed 0 of the bf16 smoke model; the
    # bundle's op names are the same
    main(base + ["--calibration", bundle_path, "--adaptive-tau", "0.01",
                 "--adaptive-every", "1", "--adaptive-dwell", "2",
                 "--n-blocks", "64"])
    out = capsys.readouterr().out
    assert "adaptive MP: tau ladder ['0.01', '0.02', '0.04']" in out
    assert "adaptive MP: " in out and "downshifts" in out
    main(base + ["--calibration", bundle_path, "--tau", "0.05",
                 "--guardrail-every", "2"])
    out = capsys.readouterr().out
    assert "guardrail: shadow step every 2 decode steps" in out
    assert "guardrail: " in out and "shadow checks" in out
    with pytest.raises(SystemExit, match="pass --continuous"):
        main(["--smoke", "--device", "cpu", "--calibration", bundle_path,
              "--adaptive-tau", "0.01"])
