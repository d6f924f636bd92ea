"""The port's Mixture-of-Experts layer and multi-token prediction
(``repro_torch.nn.moe``, ``models.lm``) against the reference package on
the same inputs and weights, bridged through numpy.

Tolerances: float32 operands hold the algorithm to f32 summation-order
noise (1e-4 of the output's scale: routing, capacity and dispatch are exact,
only the combine and the expert GEMMs sum in another order); bfloat16 and
fp8 fake-quant cases to the rounding a one-ulp difference can flip (2^-6 and
2^-4 of the scale, as ``test_torch_model.py``). Capacity drops depend on
the other tokens of a chunk, so a token's output depends on what it is
batched with, in the reference as in the port: the same batches go through
both (``test_caveat_capacity_drops_depend_on_the_batch`` pins the effect).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.pipeline as jpl  # noqa: E402
from repro.core.graphs import build_graph as jbuild_graph  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.nn.spec import tree_from_flat as jtree_from_flat  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core.graphs import build_graph  # noqa: E402
from repro_torch.core.partition import partition_sequential  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn.spec import tree_from_flat  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, Request,  # noqa: E402
                               ServeEngine)

MOE_ARCHS = ["moonshot_v1_16b_a3b", "deepseek_v3_671b"]
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}
MP = {"layers/0/moe/router": "fp8_e4m3",
      "layers/1/moe/experts/up_proj": "fp8_e4m3",
      "layers/1/moe/experts/down_proj": "fp8_e4m3",
      "layers/1/attn/qk_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=atol)


def _jmoe(p, ctx, x, cfg):
    """The reference layer, compiled once (its op-by-op run compiles every
    primitive on its own, which takes longer on the CPU)."""
    return jax.jit(lambda p_, x_: jmoe.apply_moe(p_, ctx, "moe", x_, cfg))(
        p, x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# the layer alone
# ---------------------------------------------------------------------------

def _layer(cfg, d_model=32, seed=0, dtype="float32", zero_router=False):
    """(flat numpy params, reference tree, port tree) of one MoE layer."""
    specs = jmoe.moe_specs("moe", d_model, cfg)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, ps in sorted(specs.items()):
        w = rng.normal(size=ps.shape).astype(np.float32) / np.sqrt(
            ps.shape[-1])
        if path.endswith("router/w") and zero_router:
            w = np.zeros_like(w)
        flat[path] = w
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jflat = {k: jnp.asarray(v, jnp.float32 if k.endswith("router/w")
                            else jdt) for k, v in flat.items()}
    tflat = {k: _t(v).to(torch.float32 if k.endswith("router/w") else tdt)
             for k, v in flat.items()}
    return flat, jtree_from_flat(jflat)["moe"], tree_from_flat(tflat)["moe"]


CASES = {
    "plain": dict(ctx={}),
    "mp_per_tensor": dict(ctx=dict(mode="mp", mp={
        "moe/router": "fp8_e4m3", "moe/experts/gate_proj": "fp8_e4m3",
        "moe/experts/down_proj": "fp8_e4m3"}), tol="mp"),
    "mp_per_token": dict(ctx=dict(mode="mp", act_scale_token=True, mp={
        "moe/experts/gate_proj": "fp8_e4m3", "moe/experts/up_proj":
        "fp8_e4m3", "moe/shared/down_proj": "fp8_e4m3"}), tol="mp"),
    "chunks_and_drops": dict(ctx={}, cfg=dict(token_chunk=16,
                                              capacity_factor=1.0)),
    "shared_experts": dict(ctx={}, cfg=dict(n_shared_experts=2,
                                            d_shared_ff=24)),
    "bf16": dict(ctx={}, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case):
    spec = CASES[case]
    cfg_kw = dict(n_experts=8, top_k=2, d_expert_ff=24, token_chunk=64,
                  n_shared_experts=1, d_shared_ff=16)
    cfg_kw.update(spec.get("cfg", {}))
    jcfg = jmoe.MoEConfig(**cfg_kw)
    tcfg = tmoe.MoEConfig(**cfg_kw)
    dtype = spec.get("dtype", "float32")
    _, jp, tp = _layer(jcfg, dtype=dtype)
    x = np.random.default_rng(1).normal(size=(3, 20, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = _t(x).to(torch.float32 if dtype == "float32" else torch.bfloat16)
    jy, jaux = _jmoe(jp, JCtx(**spec["ctx"]), jx, jcfg)
    ty, taux = tmoe.apply_moe(tp, TCtx(**spec["ctx"]), "moe", tx, tcfg)
    tol = TOL[spec.get("tol", dtype)]
    _close(ty.float().numpy(), np.asarray(jy, np.float32), tol)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-9)
    if case == "chunks_and_drops":
        # four chunks of 16 tokens at 8 slots an expert a chunk
        assert tmoe.capacity(16, tcfg) == 8


def test_capacity_drops_the_same_tokens():
    """No shared experts, a tight capacity: the tokens whose every pick
    overflowed its expert give an all-zero output, the same ones in both."""
    cfg_kw = dict(n_experts=4, top_k=1, d_expert_ff=16, token_chunk=32,
                  capacity_factor=0.5)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    _, jp, tp = _layer(jcfg, d_model=32, seed=3)
    x = np.random.default_rng(5).normal(size=(2, 32, 32)).astype(np.float32)
    jy, _ = _jmoe(jp, JCtx(), jnp.asarray(x), jcfg)
    ty, _ = tmoe.apply_moe(tp, TCtx(), "moe", _t(x), tcfg)
    jdrop = np.all(np.asarray(jy) == 0, axis=-1)
    tdrop = np.all(ty.numpy() == 0, axis=-1)
    assert tmoe.capacity(32, tcfg) == 8
    assert jdrop.sum() > 0 and np.array_equal(jdrop, tdrop)
    _close(ty.numpy(), np.asarray(jy), TOL["float32"])


def test_tied_router_takes_the_lower_index_first():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1 in both packages (``jax.lax.top_k``'s order)."""
    cfg_kw = dict(n_experts=8, top_k=3, d_expert_ff=16, token_chunk=64)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    _, jp, tp = _layer(jcfg, seed=2, zero_router=True)
    probs = torch.full((5, 8), 0.125)
    _, idx = tmoe.route_top_k(probs, 3)
    _, jidx = jax.lax.top_k(jnp.full((5, 8), 0.125), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1, 2]
    x = np.random.default_rng(4).normal(size=(2, 8, 32)).astype(np.float32)
    jy, jaux = _jmoe(jp, JCtx(), jnp.asarray(x), jcfg)
    ty, taux = tmoe.apply_moe(tp, TCtx(), "moe", _t(x), tcfg)
    _close(ty.numpy(), np.asarray(jy), TOL["float32"])
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_probe_mode_runs_one_chunk_and_captures_3d_operands():
    """Probe mode routes every token in one chunk (as the reference does),
    captures the expert GEMMs' 3-D operands, and zero probes leave the
    output of that one chunk unchanged."""
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_expert_ff=16, token_chunk=8)
    _, _, tp = _layer(jmoe.MoEConfig(**dataclasses.asdict(cfg)))
    x = _t(np.random.default_rng(6).normal(size=(2, 12, 32)))
    names = ["moe/router", "moe/experts/gate_proj", "moe/experts/up_proj",
             "moe/experts/down_proj"]
    reg: list = []
    tmoe.apply_moe(tp, TCtx(registry=reg), "moe", x, cfg)
    shapes = {op.name: (op.lhs_shape, op.rhs_shape) for op in reg}
    cap = tmoe.capacity(24, cfg)
    assert shapes["moe/experts/gate_proj"] == ((4, cap, 32), (4, 16, 32))
    probes = {n: (torch.zeros(shapes[n][0], requires_grad=True),
                  torch.zeros(shapes[n][1], requires_grad=True))
              for n in names}
    ctx = TCtx(mode="probe", probes=probes, captures={})
    y, _ = tmoe.apply_moe(tp, ctx, "moe", x, cfg)
    one = dataclasses.replace(cfg, token_chunk=24)
    want, _ = tmoe.apply_moe(tp, TCtx(), "moe", x, one)
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=0)
    assert sorted(ctx.captures) == sorted(names)
    assert ctx.captures["moe/experts/down_proj"][1].dim() == 3
    grads = torch.autograd.grad(y.square().sum(),
                                [probes[n][1] for n in names])
    assert all(g.abs().sum() > 0 for g in grads)


def test_caveat_capacity_drops_depend_on_the_batch():
    """A token's output depends on the other tokens of its chunk once
    experts overflow: a sequence alone and the same sequence beside
    another give different outputs, in the reference as in the port (and
    the port equals the reference in both)."""
    cfg_kw = dict(n_experts=4, top_k=2, d_expert_ff=16, token_chunk=64,
                  capacity_factor=1.0)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    _, jp, tp = _layer(jcfg, seed=7)
    x = np.random.default_rng(8).normal(size=(2, 16, 32)).astype(np.float32)
    outs = {}
    for name, xs in (("alone", x[:1]), ("batched", x)):
        jy, _ = _jmoe(jp, JCtx(), jnp.asarray(xs), jcfg)
        ty, _ = tmoe.apply_moe(tp, TCtx(), "moe", _t(xs), tcfg)
        _close(ty.numpy(), np.asarray(jy), TOL["float32"])
        outs[name] = (ty[0].numpy(), np.asarray(jy)[0])
    for k in (0, 1):
        assert np.abs(outs["alone"][k] - outs["batched"][k]).max() > 1e-3


# ---------------------------------------------------------------------------
# the two MoE configurations at smoke size
# ---------------------------------------------------------------------------

_PAIRS: dict = {}


def _pair(arch: str, dtype: str = "float32"):
    """(reference model, its params, port model, the same params bridged)
    at smoke size; DeepSeek with absorbed decode (the fused MLA form). The
    weights are stored in ``param_dtype`` whatever ``dtype`` computes in,
    so every dtype shares the float32 pair's weights."""
    key = (arch, dtype)
    if key not in _PAIRS:
        kw = dict(mla_absorb_decode=True) if arch == "deepseek_v3_671b" \
            else {}
        jm = jget(arch, smoke=True, dtype=dtype, **kw)
        tm = tget(arch, smoke=True, dtype=dtype, **kw)
        if dtype == "float32":
            jp = jm.init(jax.random.key(0))
            tp = params_from_flat({k: np.asarray(v) for k, v in
                                   flatten_paths(jp).items()}, tm.cfg, "cpu")
        else:
            base, jp, _, tp = _pair(arch)
            assert jm.param_specs() == base.param_specs()
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _batch(seed=0, B=2, T=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, T)).astype(np.int32)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_specs_match_reference(arch):
    jm, _, tm, _ = _pair(arch)
    js = {k: tuple(v.shape) for k, v in jm.param_specs().items()}
    ts = {k: tuple(v.shape) for k, v in tm.param_specs().items()}
    assert ts == js
    assert any(k.startswith("layers/1/moe/experts/") for k in ts)
    assert ("mtp/proj/w" in ts) == (arch == "deepseek_v3_671b")


@pytest.mark.parametrize("arch,dtype", [
    ("moonshot_v1_16b_a3b", "float32"), ("deepseek_v3_671b", "float32"),
    ("deepseek_v3_671b", "bfloat16")])
def test_logits_and_loss_match_reference(arch, dtype):
    """Logits, and ``loss`` with the MoE aux loss and (DeepSeek) the MTP
    loss, on the same weights and batch."""
    jm, jp, tm, tp = _pair(arch, dtype)
    b = _batch()
    jl = np.asarray(jm.apply(jp, jnp.asarray(b["tokens"]), JCtx()),
                    np.float32)
    tl = tm.apply(tp, torch.from_numpy(b["tokens"]), TCtx()).float()
    _close(tl.numpy(), jl, TOL[dtype])
    jloss = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in b.items()},
                          JCtx()))
    tloss = float(tm.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                          TCtx()))
    assert tloss == pytest.approx(jloss, rel=1e-5 if dtype == "float32"
                                  else 1e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_mp_logits_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    b = _batch(1)
    mp = {k: v for k, v in MP.items() if k != "layers/1/attn/qk_matmul"
          or arch != "deepseek_v3_671b"}
    jctx = JCtx(mode="mp", mp=mp, act_scale_token=True)
    jl = np.asarray(jax.jit(lambda p, t: jm.apply(p, t, jctx))(
        jp, jnp.asarray(b["tokens"])))
    tl = tm.apply(tp, torch.from_numpy(b["tokens"]),
                  TCtx(mode="mp", mp=mp, act_scale_token=True))
    _close(tl.numpy(), jl, TOL["mp"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Mirrors the reference's ``test_prefill_decode_matches_full_forward``
    on the port: a prompt prefilled into dense caches then decoded token
    by token gives the full forward's logits."""
    _, _, tm, tp = _pair(arch, "bfloat16")
    B, T = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (B, T)).astype(np.int32))
    full = tm.apply(tp, toks, TCtx()).float()
    caches = tm.init_cache(B, 16, "cpu")
    lp, caches = tm.prefill(tp, toks[:, :6], caches, TCtx())
    errs = [float((lp[:, 0].float() - full[:, 5]).abs().max())]
    for t in range(6, T - 1):
        lg, caches = tm.decode_step(tp, toks[:, t:t + 1], t, caches, TCtx())
        errs.append(float((lg[:, 0].float() - full[:, t]).abs().max()))
    assert max(errs) < 0.05, errs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_graph_and_partition_match_reference(arch):
    """Mirrors ``tests/test_partition.py``: the groups cover every
    quantizable node once; the port's graph equals the reference's, with
    no MTP node."""
    jm, _, tm, _ = _pair(arch)
    g = build_graph(tm)
    jg = jbuild_graph(jm)
    assert g.nodes == jg.nodes
    groups = partition_sequential(g)
    names = [x for grp in groups for x in grp]
    assert sorted(names) == sorted(g.quantizable_nodes())
    assert len(names) == len(set(names))
    assert "layers/1/moe/router" in names
    assert not any(n.startswith("mtp/") for n in g.nodes)
    if arch == "deepseek_v3_671b":
        assert "layers/1/moe/shared/down_proj" in names
    assert sorted(tm.serving_op_names()) == sorted(g.quantizable_nodes())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_calibrate_and_plan_match_reference(arch):
    """``calibrate`` on the float32 smoke model: the same op inventory
    (MTP ops included, in no group), groups and sensitivities within f32
    summation order, and the same IP plan at one tau."""
    jm, jp, tm, tp = _pair(arch)
    batches = [_batch(s) for s in (2, 3)]
    jb = jpl.calibrate(jm, jp, [{k: jnp.asarray(v) for k, v in b.items()}
                                for b in batches],
                       jpl.AMPOptions(hw=JHW(**dataclasses.asdict(H100_SXM))))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
        for a, b in zip(tb.objectives[obj]["gains"],
                        jb.objectives[obj]["gains"]):
            np.testing.assert_allclose(a, b, rtol=1e-9)
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=1e-3, abs=1e-12), name
    grouped = {n for g in tb.objectives["ET"]["groups"] for n in g}
    mtp = [n for n in ts if n.startswith("mtp/")]
    assert bool(mtp) == (arch == "deepseek_v3_671b")
    assert not grouped & set(mtp)
    assert tb.sens.loss_mean == pytest.approx(jb.sens.loss_mean, rel=1e-5)
    for tau in (0.02,):
        tplan, jplan = tb.solve(tau, "ET"), jb.solve(tau, "ET")
        assert tplan.assignment == jplan.assignment
        assert tplan.n_quantized > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(n=3, length=12, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=length).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("paged_attn", ["fused", "gather"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_match_reference_oneshot(arch, paged_attn, mp,
                                               monkeypatch):
    """The continuous engine (paged, staggered arrivals, two slots: vacant
    rows and bucket padding routed) against the reference's one-shot
    ``ServeEngine`` on the same float32 weights and prompts: the same
    greedy tokens (the smoke capacity factor 4 never drops a token, so
    batch composition does not enter). Fused decode reaches the kernel
    wrapper once per layer per step."""
    jm, jp, tm, tp = _pair(arch)
    assign = dict(MP) if mp else None
    prompts = _prompts()
    want = np.asarray(JServeEngine(jm, mp=assign, donate=False).generate(
        jp, {"tokens": jnp.asarray(np.stack(prompts))},
        max_new_tokens=5).tokens)
    calls = []
    orig = tpa.paged_decode_attention
    monkeypatch.setattr(tpa, "paged_decode_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_len=24, block_size=4,
                                   mp=assign, paged_attn=paged_attn,
                                   device="cpu")
    summ = eng.serve(tp, [Request(rid=i, tokens=p, max_new_tokens=5,
                                  arrival=i) for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(summ.tokens_for(i), want[i])
    fused_layers = tm.cfg.n_layers - (1 if mp else 0)
    assert len(calls) == (summ.n_steps * fused_layers
                          if paged_attn == "fused" else 0)
    one = ServeEngine(tm, mp=assign, device="cpu").generate(
        tp, {"tokens": np.stack(prompts)}, max_new_tokens=5)
    np.testing.assert_array_equal(one.tokens, want)


def test_router_under_the_kernel_impl_takes_the_fp8_kernels(monkeypatch):
    """``impl="kernel"`` with per-tensor scales sends the router's f32 2-D
    linear (N = E) through ``kernels.ops.fp8_linear`` with an f32 output,
    as the reference's ``impl="pallas"`` does; the 3-D expert GEMMs keep
    fake quant."""
    from repro_torch.kernels import ops
    seen = []
    orig = ops.fp8_linear

    def spy(x, w, **kw):
        seen.append((tuple(x.shape), tuple(w.shape), x.dtype,
                     kw.get("out_dtype")))
        return orig(x, w, **kw)
    monkeypatch.setattr(ops, "fp8_linear", spy)
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_expert_ff=16)
    _, _, tp = _layer(jmoe.MoEConfig(**dataclasses.asdict(cfg)))
    x = _t(np.random.default_rng(9).normal(size=(2, 6, 32)))
    mp = {"moe/router": "fp8_e4m3", "moe/experts/up_proj": "fp8_e4m3"}
    y, _ = tmoe.apply_moe(tp, TCtx(mode="mp", mp=mp, impl="kernel"), "moe",
                          x, cfg)
    assert seen == [((12, 32), (8, 32), torch.float32, torch.float32)]
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_moe_and_mtp_params(arch):
    jm, jp, tm, tp = _pair(arch)
    from repro_torch.nn.spec import flatten_paths as tflatten
    flat = {k: np.asarray(v) for k, v in flatten_paths(jp).items()}
    back = {k: v.float().numpy() for k, v in tflatten(tp).items()}
    assert set(back) == set(flat)
    moe = [k for k in flat if "/moe/" in k or k.startswith("mtp/")]
    assert moe
    for k in moe:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k],
                                                          np.float32))


def test_launcher_serves_the_moe_configs(capsys):
    """``--arch moonshot_v1_16b_a3b`` and the unmodified DeepSeek-V3 (MTP
    and all) through the launcher; ``--n-layers`` keeps DeepSeek's first
    layers past its dense prefix, as on the card."""
    from repro_torch.launch.serve import main
    from repro_torch.models.registry import depth_overrides
    common = ["--smoke", "--device", "cpu", "--continuous", "--requests",
              "3", "--n-slots", "2", "--prompt-len", "10", "--new-tokens",
              "3"]
    main(["--arch", "moonshot_v1_16b_a3b"] + common)
    assert "continuous: 3 reqs via 2 slots" in capsys.readouterr().out
    main(["--arch", "deepseek_v3_671b", "--mla-absorb-decode"] + common)
    assert "continuous: 3 reqs via 2 slots" in capsys.readouterr().out
    main(["--arch", "deepseek_v3_671b", "--n-layers", "2"] + common)
    out = capsys.readouterr().out
    assert "deepseek_smoke on cpu" in out and "3 reqs" in out
    assert depth_overrides("deepseek_v3_671b", 5) == dict(
        n_layers=5, block_types=("mla",) * 5, moe_layers=(3, 4),
        mtp_depth=0)
    with pytest.raises(ValueError, match="61 layers"):
        depth_overrides("deepseek_v3_671b", 62)
