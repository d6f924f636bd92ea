"""The port's Algorithm 1 (``repro_torch.core``) against the reference
``repro.core``: probe-mode captures and gradients, sensitivities, the
partition, the TT/M/ET gain tables, the IP, bundles saved by either package,
the measured tier, the registry and the launcher's ``--calibration``.

Weights come from the reference's init and are bridged through numpy by
param path; batches are numpy arrays handed to both packages.

Tolerances: groups, OpInfo, gain tables, bundle plans, fingerprints and
calibration-set hashes are exact (the same integers and the same float64
arithmetic on both sides). Probe captures, gradients and sensitivities in a
float32 model differ by f32 summation order only: rtol 1e-4 on s_l (a
squared sum of products of two such tensors), 1e-5 on the loss moments.
In the bf16 working type an activation that rounds the other way moves its
s_l term by up to one bf16 ulp relative (2^-8) at every layer it feeds, so
s_l gets rtol 2^-4."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.pipeline as jpl  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.core.partition import partition_sequential as jpart  # noqa: E402
from repro.core.registry import BundleRegistry as JRegistry  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.kv_scales import calibrate_kv_scales as jkv  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.core.partition import partition_sequential as tpart  # noqa: E402
from repro_torch.core.registry import BundleRegistry  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.quant.kv_scales import calibrate_kv_scales as tkv  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402

# the reference prices its tables with the port's H100 profile
JH100 = JHW(**dataclasses.asdict(H100_SXM))
SENS_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}
LOSS_RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}


def _batches(vocab: int, n: int = 2, B: int = 2, T: int = 32) -> list:
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, T)).astype(np.int32)}
            for _ in range(n)]


def _jbatches(batches: list) -> list:
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def calibrated(request):
    """Both packages calibrated on the smoke llama, same weights and data."""
    dtype = request.param
    jm = jget("llama3_1b", smoke=True, dtype=dtype)
    jp = jm.init(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in flatten_paths(jp).items()}
    tm = tget("llama3_1b", smoke=True, dtype=dtype)
    tp = params_from_flat(flat, tm.cfg, "cpu")
    batches = _batches(tm.cfg.vocab_size)
    jb = jpl.calibrate(jm, jp, _jbatches(batches), jpl.AMPOptions(hw=JH100))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    return dtype, jm, jp, tm, tp, batches, jb, tb


def _plan_dict(plan) -> dict:
    return dataclasses.asdict(plan)


# ---------------------------------------------------------------------------
# partition, probes, sensitivities, tables
# ---------------------------------------------------------------------------


# besides the llama: QKV bias and a tied head (qwen2p5_3b), a non-gated
# relu2 MLP under layernorm (nemotron_4_15b)
OTHER_FAMILIES = ["qwen2p5_3b", "nemotron_4_15b"]


@pytest.mark.parametrize("arch_cfg", [
    pytest.param(("llama3_1b", "smoke_config"), id="smoke_config"),
    pytest.param(("llama3_1b", "config"), id="config")] + [
    pytest.param((arch, cfg), id=f"{arch}-{cfg}")
    for arch in OTHER_FAMILIES for cfg in ("smoke_config", "config")])
def test_groups_match_reference(arch_cfg):
    """Graphs need no weights: the full 16-layer llama3_1b partitions into
    the reference's 65 groups (per layer {q,k,v,qk,av}, {o}, {gate,up},
    {down}, then lm_head); the other families' graphs and partitions equal
    the reference's too."""
    import importlib
    arch, cfg = arch_cfg
    jc = importlib.import_module(f"repro.configs.{arch}")
    tc = importlib.import_module(f"repro_torch.configs.{arch}")
    jg = jgraphs.build_lm_graph(getattr(jc, cfg)())
    tg = tgraphs.build_lm_graph(getattr(tc, cfg)())
    assert tg.nodes == jg.nodes and tg.edges == jg.edges
    assert tg.residual_edges == jg.residual_edges
    for kw in (dict(drop_residual=True, max_group_size=8),
               dict(drop_residual=True, max_group_size=2),
               dict(drop_residual=False)):
        assert tpart(tg, **kw) == jpart(jg, **kw)
    groups = tpart(tg, drop_residual=True, max_group_size=8)
    if arch_cfg == ("llama3_1b", "config"):
        assert len(groups) == 65 and groups[-1] == ["lm_head"]
        assert set(groups[0]) == {f"layers/0/attn/{n}" for n in (
            "q_proj", "k_proj", "v_proj", "qk_matmul", "av_matmul")}


def test_build_graph_refuses_unported_families():
    from repro_torch.configs import llama3_1b as tc
    # scan_layers is ported (ROADMAP A9c): one scope per segment
    g = tgraphs.build_lm_graph(tc.smoke_config(scan_layers=True))
    assert "segments/0/attn/q_proj" in g.quantizable_nodes()
    assert not any(n.startswith("layers/") for n in g.nodes)
    # the encoder-decoder has its graph (ROADMAP A8); other objects are
    # refused as the reference refuses them
    from repro_torch.models.registry import get_model
    g = tgraphs.build_graph(get_model("whisper_base", smoke=True))
    assert "dec/1/cross/qk_matmul" in g.quantizable_nodes()
    with pytest.raises(TypeError):
        tgraphs.build_graph(object())
    # mamba and hybrid blocks have their graph (ROADMAP A8's SSM half)
    g = tgraphs.build_lm_graph(tc.smoke_config(block_types=("mamba",
                                                            "hybrid")))
    assert "layers/1/hybrid_merge" in g.nodes


def test_probe_captures_and_gradients_match_reference():
    """One probe-mode forward+backward on the float32 smoke llama: every op
    captures the same operands and the probes get the same gradients, the
    head once over the whole sequence (no loss chunks)."""
    jm = jget("llama3_1b", smoke=True, dtype="float32", loss_chunk=8)
    jp = jm.init(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in flatten_paths(jp).items()}
    tm = tget("llama3_1b", smoke=True, dtype="float32", loss_chunk=8)
    tp = params_from_flat(flat, tm.cfg, "cpu")
    batch = _batches(tm.cfg.vocab_size, n=1)[0]
    # operand shapes of the unchunked head: the reference's own trace of a
    # loss_chunk=8 model would record one 8-token chunk (its calibration
    # then fails on sequences longer than the chunk; see ROADMAP.md)
    jm_whole = jget("llama3_1b", smoke=True, dtype="float32")
    ops = jsens.collect_ops(lambda p, b, c: jm_whole.loss(p, b, c), jp,
                            _jbatches([batch])[0])
    shapes = {op.name: (op.lhs_shape, op.rhs_shape) for op in ops}

    def jloss(probes):
        ctx = JCtx(mode="probe", probes=probes, captures={})
        return jm.loss(jp, _jbatches([batch])[0], ctx), ctx.captures

    jprobes = jsens._zero_probes(shapes, ops)
    (jl, jcap), jgrads = jax.value_and_grad(jloss, has_aux=True)(jprobes)

    tprobes = tsens._zero_probes(shapes, ops, torch.device("cpu"))
    tctx = TCtx(mode="probe", probes=tprobes, captures={})
    tl = tm.loss(tp, tsens.batch_to(batch, torch.device("cpu")), tctx)
    names = list(tprobes)
    tgrads = torch.autograd.grad(tl, [p for n in names for p in tprobes[n]])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert sorted(tctx.captures) == sorted(jcap) == sorted(shapes)
    assert tctx.captures["lm_head"][0].shape == (2, 32, 128)
    for i, name in enumerate(names):
        for side in (0, 1):
            z_t = tctx.captures[name][side].detach().float().numpy()
            z_j = np.asarray(jcap[name][side], np.float32)
            np.testing.assert_allclose(z_t, z_j, rtol=1e-4, atol=1e-5)
            g_t = tgrads[2 * i + side].numpy()
            g_j = np.asarray(jgrads[name][side])
            scale = float(np.abs(g_j).max())
            # attention rounds scores and probabilities to bf16 even in an
            # f32 model, so a gradient through them may differ by one bf16
            # ulp (2^-8) of the largest gradient
            np.testing.assert_allclose(g_t, g_j, rtol=1e-3,
                                       atol=2.0 ** -8 * scale)


def test_calibrate_with_sequences_longer_than_the_loss_chunk(calibrated):
    """The port traces the op inventory with the head unchunked, as probe
    mode runs it, so a sequence longer than ``loss_chunk`` calibrates (and
    the head's MACs count every token): the same numbers as a model whose
    chunk covers the sequence."""
    dtype, _, _, tm, tp, batches, _, tb = calibrated
    chunked = tget("llama3_1b", smoke=True, dtype=dtype, loss_chunk=8)
    sens = tsens.calibrate_sensitivity(
        lambda p, b, c: chunked.loss(p, b, c), tp, batches)
    head = {op.name: op for op in sens.ops}["lm_head"]
    assert head.lhs_shape == (2, 32, 128) and head.macs == 2 * 32 * 128 * 512
    assert [dataclasses.asdict(o) for o in sens.ops] == [
        dataclasses.asdict(o) for o in tb.sens.ops]
    for name, s_l in tb.sens.sensitivity.items():
        assert sens.sensitivity[name] == pytest.approx(s_l, rel=1e-6)


def test_calibrate_matches_reference(calibrated):
    dtype, _, _, _, _, _, jb, tb = calibrated
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=SENS_RTOL[dtype]), name
    assert tb.sens.loss_mean == pytest.approx(jb.sens.loss_mean,
                                              rel=LOSS_RTOL[dtype])
    assert tb.sens.loss_sq_mean == pytest.approx(jb.sens.loss_sq_mean,
                                                 rel=2 * LOSS_RTOL[dtype])
    assert tb.meta == jb.meta          # fingerprint, calib hash, hw, options
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
        for a, b in zip(tb.objectives[obj]["gains"],
                        jb.objectives[obj]["gains"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_calibrate_matches_reference_on_other_families(arch):
    """Algorithm 1 end to end on a smoke model of each other family, f32
    weights bridged from the reference: the same ops, sensitivities within
    ``SENS_RTOL``, losses within ``LOSS_RTOL``, the same groups and gain
    tables, and the same plans (their budgets and predictions within
    ``SENS_RTOL``)."""
    jm = jget(arch, smoke=True, dtype="float32")
    jp = jm.init(jax.random.key(0))
    tm = tget(arch, smoke=True, dtype="float32")
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    batches = _batches(tm.cfg.vocab_size)
    jb = jpl.calibrate(jm, jp, _jbatches(batches), jpl.AMPOptions(hw=JH100))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name] == pytest.approx(js[name],
                                         rel=SENS_RTOL["float32"]), name
    assert tb.sens.loss_mean == pytest.approx(jb.sens.loss_mean,
                                              rel=LOSS_RTOL["float32"])
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
        for a, b in zip(tb.objectives[obj]["gains"],
                        jb.objectives[obj]["gains"]):
            np.testing.assert_array_equal(a, b)
        tplan, jplan = tb.solve(0.05, obj), jb.solve(0.05, obj)
        assert tplan.assignment == jplan.assignment
        assert [list(g) for g in tplan.groups] == [list(g)
                                                   for g in jplan.groups]
        for field in ("budget", "predicted_loss_mse", "predicted_gain"):
            assert getattr(tplan, field) == pytest.approx(
                getattr(jplan, field), rel=SENS_RTOL["float32"]), field


@pytest.mark.parametrize("ext", ["json", "npz"])
def test_bundles_cross_load_and_solve_identically(calibrated, tmp_path, ext):
    """A bundle saved by either package loads in the other and solves to the
    identical plan for every objective and tau."""
    _, _, _, _, _, _, jb, tb = calibrated
    jpath, tpath = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    jb.save(str(jpath))
    tb.save(str(tpath))
    in_port = tpl.CalibrationBundle.load(str(jpath))
    in_ref = jpl.CalibrationBundle.load(str(tpath))
    for objective in ("ET", "TT", "M"):
        for tau in (0.002, 0.02):
            assert _plan_dict(in_port.solve(tau, objective)) == _plan_dict(
                jb.solve(tau, objective))
            assert _plan_dict(in_ref.solve(tau, objective)) == _plan_dict(
                tb.solve(tau, objective))
    assert in_port.solve(0.02, "ET").meta["gain_tier"] == "roofline_fallback"


class _FakeClock:
    """Stands in for ``time.perf_counter``: a run advances it by a cost
    that depends only on the assignment, so both packages' measured tables
    are the same numbers."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def factory(self, assignment: dict):
        # dyadic costs keep every clock reading and difference exact
        cost = 1.0 - sum(1 for f in assignment.values()
                         if f != "bf16") / 1024
        cost += sum(len(n) for n in assignment) / 2 ** 20

        def run():
            self.t += cost
        return run


def test_measured_tier_matches_reference(calibrated, monkeypatch, tmp_path):
    _, _, _, _, _, _, jb, tb = calibrated
    clock = _FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    path = tmp_path / "b.npz"
    tb.save(str(path))
    t_bundle = tpl.CalibrationBundle.load(str(path))
    j_bundle = jpl.CalibrationBundle.load(str(path))
    assert tpl.tabulate_measured_gains(t_bundle, clock.factory, n_iters=2,
                                       n_warmup=1) == "ET_wall"
    jpl.tabulate_measured_gains(j_bundle, clock.factory, n_iters=2,
                                n_warmup=1)
    for a, b in zip(t_bundle.objectives["ET_wall"]["gains"],
                    j_bundle.objectives["ET_wall"]["gains"]):
        np.testing.assert_array_equal(a, b)
    plan = t_bundle.solve(0.02, "ET")
    assert plan.meta["gain_tier"] == "measured"
    assert _plan_dict(plan) == _plan_dict(j_bundle.solve(0.02, "ET"))
    assert t_bundle.solve(0.02, "TT").meta["gain_tier"] == "analytic"
    with pytest.raises(ValueError, match="measured"):
        tpl.tabulate_measured_gains(t_bundle, clock.factory,
                                    objective="ET_wall")


def test_registry_round_trip(calibrated, tmp_path):
    """The port files a bundle under its own keys; the port and the
    reference both find it by (arch, fingerprint); a wrong key is refused
    with what the registry holds."""
    tb = calibrated[-1]
    reg = BundleRegistry(str(tmp_path))
    path = reg.put(tb)
    assert path.endswith("bundle-0000.npz")
    assert reg.put(tb).endswith("bundle-0001.npz")
    arch, fp = tb.meta["arch"], tb.meta["params_fingerprint"]
    found = reg.find(arch, fp, calib_hash=tb.meta["calib_hash"])
    assert _plan_dict(found.solve()) == _plan_dict(tb.solve())
    assert _plan_dict(JRegistry(str(tmp_path)).find(arch, fp).solve()) == \
        _plan_dict(tb.solve())
    with pytest.raises(LookupError, match="registry holds"):
        reg.find("llama3_other", fp)
    with pytest.raises(LookupError, match="calib_hash"):
        reg.find(arch, fp, calib_hash="0" * 16)


def test_auto_mixed_precision_objectives(calibrated):
    """The one-call API equals calibrate + solve; plans respect the budget,
    the memory objective quantizes linear layers only, and the predicted
    MSE of the assignment is the solver's."""
    _, _, _, tm, tp, batches, _, tb = calibrated
    for objective in ("ET", "TT", "M"):
        opts = tpl.AMPOptions(tau=0.02, objective=objective)
        plan = tpl.auto_mixed_precision(tm, tp, batches, opts, sens=tb.sens)
        assert _plan_dict(plan) == _plan_dict(tb.solve(0.02, objective))
        assert plan.predicted_loss_mse <= plan.budget * (1 + 1e-9)
        assert plan.predicted_gain >= 0 and plan.n_quantized > 0
        if objective == "M":
            assert all("matmul" not in n for n in plan.assignment)
        assert np.isclose(tpl.predicted_loss_mse(tb.sens, plan.assignment),
                          plan.predicted_loss_mse, rtol=1e-6, atol=1e-12)


def test_calibrate_cache_resumes_without_recalibration(calibrated, tmp_path,
                                                       monkeypatch):
    _, _, _, tm, tp, batches, _, _ = calibrated
    path = tmp_path / "cache.npz"
    calls = {"n": 0}
    orig = tpl.calibrate_sensitivity

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tpl, "calibrate_sensitivity", counting)
    opts = tpl.AMPOptions(tau=0.01, objective="TT")
    first = tpl.calibrate(tm, tp, batches, opts, cache=str(path))
    second = tpl.calibrate(tm, tp, batches, opts, cache=str(path))
    assert calls["n"] == 1
    assert _plan_dict(second.solve()) == _plan_dict(first.solve())
    def scaled(tree):
        return ({k: scaled(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree * 1.5)

    tpl.calibrate(tm, scaled(tp), batches, opts, cache=str(path))
    assert calls["n"] == 2


def test_h100_profile():
    """The port's only profile: the H100 SXM data sheet at 700 W."""
    assert tpl.AMPOptions().hw is H100_SXM
    assert H100_SXM.flops("bf16") == 989.4e12
    assert H100_SXM.flops("fp8_e4m3") == H100_SXM.flops("fp4_e2m1") \
        == 1978.9e12
    assert H100_SXM.hbm_bw == 3.35e12 and H100_SXM.hbm_bytes == 80e9
    assert H100_SXM.delta_T("fp8_e4m3") > 0 == H100_SXM.delta_T("bf16")


# ---------------------------------------------------------------------------
# kv scales, data, launcher
# ---------------------------------------------------------------------------


def test_kv_scales_match_reference():
    """Per-layer K/V amax scales from a bf16-cache prefill: the cached K/V
    are bf16 in both, products summed in f32 in other orders, so a scale
    may differ by one bf16 rounding of the largest entry (rtol 2^-7)."""
    jm = jget("llama3_1b", smoke=True, dtype="float32")
    jp = jm.init(jax.random.key(1))
    flat = {k: np.asarray(v) for k, v in flatten_paths(jp).items()}
    tm = tget("llama3_1b", smoke=True, dtype="float32")
    tp = params_from_flat(flat, tm.cfg, "cpu")
    toks = [np.random.default_rng(i).integers(0, 512, (2, 16)).astype(
        np.int32) for i in range(2)]
    want = jkv(jm, jp, [{"tokens": jnp.asarray(t)} for t in toks])
    got = tkv(tm, tp, [{"tokens": t} for t in toks])
    assert len(got) == len(want) == tm.cfg.n_layers
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w] == ["k", "v"]
        for (_, gs), (_, ws) in zip(g, w):
            assert gs == pytest.approx(ws, rel=2.0 ** -7)


def test_synthetic_stream_is_step_seeded():
    cfg = SyntheticConfig(vocab_size=512, batch=3, seq_len=64, seed=4)
    a, b = SyntheticLM(cfg, "cpu"), SyntheticLM(cfg, "cpu")
    x, y = a.batch_at(7), b.batch_at(7)
    assert all(torch.equal(x[k], y[k]) for k in ("tokens", "labels"))
    assert not torch.equal(a.batch_at(8)["tokens"], x["tokens"])
    assert x["tokens"].shape == (3, 64) and x["tokens"].dtype == torch.int32
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert int(x["tokens"].min()) >= 0 and int(x["tokens"].max()) < 512
    # Zipf unigrams: the most frequent ids are the low ranks
    many = torch.cat([a.batch_at(s)["tokens"].flatten() for s in range(20)])
    assert float((many < 16).float().mean()) > 0.3
    assert len(list(a.batches(0, 3))) == 3


def _launch(argv, capsys) -> str:
    tserve.main(["--smoke", "--device", "cpu", "--prompt-len", "8",
                 "--new-tokens", "3", *argv])
    return capsys.readouterr().out


def test_launcher_serves_from_a_calibration_bundle(tmp_path, capsys,
                                                   monkeypatch):
    """``--calibration`` solves at serve time and flags a roofline-priced
    solve; a bundle with a measured table solves from it with no note;
    ``--registry`` finds the bundle calibrated on the launcher's weights; a
    bundle of another model is refused."""
    model, params = tserve.make_model_and_params("llama3_1b", True, "cpu")
    batches = [b for b in SyntheticLM(SyntheticConfig(
        vocab_size=model.cfg.vocab_size, batch=2, seq_len=16), "cpu"
    ).batches(0, 2)]
    bundle = tpl.calibrate(model, params, batches)
    path = tmp_path / "bundle.npz"
    bundle.save(str(path))
    out = _launch(["--continuous", "--requests", "2", "--n-slots", "2",
                   "--calibration", str(path), "--tau", "0.05",
                   "--objective", "ET"], capsys)
    assert "solved from" in out and "[roofline_fallback]" in out
    assert "no measured wall-clock gain table" in out
    assert "continuous: 2 reqs" in out

    clock = _FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    tpl.tabulate_measured_gains(bundle, clock.factory, n_iters=1,
                                n_warmup=0)
    monkeypatch.undo()
    bundle.save(str(path))
    out = _launch(["--calibration", str(path), "--tau", "0.05"], capsys)
    assert "[measured]" in out and "no measured" not in out
    assert "TTFT" in out

    BundleRegistry(str(tmp_path / "reg")).put(bundle)
    out = _launch(["--registry", str(tmp_path / "reg")], capsys)
    assert "registry match: arch llama3_smoke" in out and "[measured]" in out

    other = tpl.CalibrationBundle.load(str(path))
    other.sens.ops[0] = dataclasses.replace(other.sens.ops[0],
                                            name="layers/9/attn/q_proj")
    other.save(str(tmp_path / "other.json"))
    with pytest.raises(SystemExit, match="different arch"):
        _launch(["--calibration", str(tmp_path / "other.json")], capsys)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _launch(["--calibration", str(path), "--mp-plan", "p.json"], capsys)
    with pytest.raises(SystemExit, match="require --calibration"):
        _launch(["--tau", "0.1"], capsys)


def test_graphed_forward_factory_drives_the_measured_tier(calibrated):
    """The measured tier over ``launch.steps.GraphedForward``, the port's
    counterpart of the reference's ``jax.jit(lambda p, t: model.apply(p,
    t, ctx))`` (eager on the CPU, as the caller asked for the CPU): every
    group's combos are timed and tabulated over the analytic table's
    groups, each forward returns ``model.apply``'s logits under its
    assignment, and a released forward runs again."""
    from repro_torch.launch.steps import GraphedForward
    _, _, _, tm, tp, batches, _, tb = calibrated
    bundle = tpl.CalibrationBundle.from_dict(tb.to_dict())
    # three of the smoke llama's groups of at most two ops: every kind of
    # op the tier times, at a few forwards each
    entry = bundle.objectives["ET"]
    keep = [i for i, g in enumerate(entry["groups"]) if len(g) <= 2][-3:]
    bundle.objectives = {"ET": {k: [entry[k][i] for i in keep]
                                for k in ("groups", "gains")}}
    prompt = torch.from_numpy(batches[0]["tokens"][:, :16])
    seen = []

    def factory(assignment):
        ctx = TCtx(mode="mp", mp=dict(assignment), impl="kernel")
        fwd = GraphedForward(tm, ctx)
        seen.append((dict(assignment), fwd, ctx))

        def run():
            fwd(tp, prompt)
        return run

    key = tpl.tabulate_measured_gains(bundle, factory, n_iters=1,
                                      n_warmup=1)
    groups = bundle.objectives["ET"]["groups"]
    assert bundle.objectives[key]["groups"] == groups
    n_combos = sum(2 ** len(g) - 1 for g in groups)
    assert len(seen) == n_combos + 1                # + the base forward
    for assignment, fwd, ctx in seen[:3] + seen[-2:]:
        with torch.no_grad():
            want = tm.apply(tp, prompt, ctx)
        assert torch.equal(fwd(tp, prompt), want)
        fwd.release()
        assert torch.equal(fwd(tp, prompt), want)
        assert fwd.step.captures == 0                   # no graph on the CPU
    assert bundle.solve(0.02, "ET").meta["gain_tier"] == "measured"
