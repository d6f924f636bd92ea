"""Mamba-2 and Hymba in the port (``repro_torch.nn.mamba``, the ``mamba``
and ``hybrid`` blocks of ``models.lm``) against the reference package on the
same seeded inputs and weights, bridged through numpy: the SSD products and
the block's prefill and decode, both smoke LMs' logits and loss, the dense
prefill and decode, the graph, calibration and the solved plan, the
hybrid's KV scales, the Random and Prefix baselines; and, inside the port,
chunked prefill against one-shot prefill and decode rows that must leave
their SSM state alone.

Tolerances (as ``test_torch_model.py``): float32 holds f32 summation order
(1e-4 of the output's scale; the SSD state, its exp and cumsum are f32 in
both packages); bfloat16 two ulps at the logits' scale (2^-6); an fp8 MP
plan 2^-4. Inside the port the equalities are bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.pipeline as jpl  # noqa: E402
from repro.core.baselines import prefix_strategy as jprefix  # noqa: E402
from repro.core.baselines import random_strategy as jrandom  # noqa: E402
from repro.core.graphs import build_graph as jbuild_graph  # noqa: E402
from repro.core.sensitivity import SensitivityResult as JSens  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn import mamba as jmamba  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.kv_scales import calibrate_kv_scales as jkv  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core.baselines import (prefix_strategy,  # noqa: E402
                                        random_strategy)
from repro_torch.core.graphs import build_graph  # noqa: E402
from repro_torch.core.partition import partition_sequential  # noqa: E402
from repro_torch.core.sensitivity import SensitivityResult  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn import mamba as tmamba  # noqa: E402
from repro_torch.quant.kv_scales import calibrate_kv_scales  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402

SSM_ARCHS = ["mamba2_370m", "hymba_1p5b"]
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}
MP = {"layers/0/mamba/in_proj": "fp8_e4m3",
      "layers/1/mamba/cb_matmul": "fp8_e4m3",
      "layers/1/mamba/c_state_matmul": "fp8_e4m3",
      "layers/2/mamba/out_proj": "fp8_e4m3", "lm_head": "fp8_e4m3"}
_PAIRS: dict = {}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=atol)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arch: str, dtype: str = "float32"):
    """(reference model, its params, port model, the same params bridged)
    at smoke size; the weights are stored in bf16 whatever ``dtype``
    computes in, so every dtype shares one draw."""
    key = (arch, dtype)
    if key not in _PAIRS:
        jm = jget(arch, smoke=True, dtype=dtype)
        tm = tget(arch, smoke=True, dtype=dtype)
        if dtype == "float32":
            jp = jm.init(jax.random.key(0))
            tp = params_from_flat({k: np.asarray(v) for k, v in
                                   flatten_paths(jp).items()}, tm.cfg, "cpu")
        else:
            _, jp, _, tp = _pair(arch)
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _batch(seed=0, B=2, T=40):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, T)).astype(np.int32)}


# ---------------------------------------------------------------------------
# the SSD block alone
# ---------------------------------------------------------------------------

CFG = jmamba.SSMConfig(d_model=32, d_inner=64, d_state=8, head_dim=16,
                       n_groups=2, chunk=8)
TCFG = tmamba.SSMConfig(**dataclasses.asdict(CFG))


def _block_params(seed=0, dtype=np.float32):
    """Flat numpy params of one mamba block, with A_log, dt_bias and the
    conv bias drawn (the inits are zeros) so every term carries weight."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, ps in sorted(jmamba.mamba_specs("m", CFG).items()):
        scale = 0.3 if path.endswith("/w") else 0.5
        flat[path[2:]] = (rng.normal(size=ps.shape) * scale).astype(dtype)
    flat["D"] = (1.0 + 0.1 * rng.normal(size=flat["D"].shape)).astype(dtype)
    flat["norm/scale"] = np.ones_like(flat["norm/scale"])
    return flat


def _trees(flat, dtype):
    from repro.nn.spec import tree_from_flat as jtree
    from repro_torch.nn.spec import tree_from_flat as ttree
    f32 = {"A_log", "D", "dt_bias", "norm/scale"}
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jt = jtree({k: jnp.asarray(v, jnp.float32 if k in f32 else jd)
                for k, v in flat.items()})
    tt = ttree({k: torch.from_numpy(v).to(torch.float32 if k in f32 else td)
                for k, v in flat.items()})
    return jt, tt


@pytest.mark.parametrize("T,init", [(8, False), (21, False), (21, True)])
def test_ssd_chunked_matches_reference(T, init):
    """The four SSD products and the inter-chunk recurrence, one chunk and
    three (the last padded), from zero and from a carried state."""
    rng = np.random.default_rng(T)
    B, H, P, G, N = 2, CFG.n_heads, CFG.head_dim, CFG.n_groups, CFG.d_state
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * 0.5
    Bm = rng.normal(size=(B, T, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, G, N)).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if init else None
    jy, js = jmamba._ssd_chunked(
        JCtx(), "m", CFG, *map(jnp.asarray, (x, dt, Bm, Cm, A)),
        init_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = tmamba._ssd_chunked(
        TCtx(), "m", TCFG, *map(torch.from_numpy, (x, dt, Bm, Cm, A)),
        init_state=None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (B, T, H, P) and ts.dtype == torch.float32
    _close(_np(ty), _np(jy), TOL["float32"])
    _close(_np(ts), _np(js), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_and_decode_match_reference(dtype):
    """A prefill of 13 tokens (two chunks) into a cache, a resumed chunk
    with padding, then three decode steps with one row held back by
    ``row_valid``: outputs and the conv/state caches."""
    flat = _block_params()
    jp, tp = _trees(flat, dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 13, 32)).astype(np.float32)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in
          jmamba.mamba_cache_spec(CFG, 2, jd).items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
          tmamba.mamba_cache_spec(TCFG, 2, td).items()}
    jy, jc = jmamba.apply_mamba(jp, JCtx(), "m", CFG,
                                jnp.asarray(x, jd), jc)
    ty, tc = tmamba.apply_mamba(tp, TCtx(), "m", TCFG,
                                torch.from_numpy(x).to(td), tc)
    tol = TOL[dtype]
    for got, want in ((ty, jy), (tc["conv"], jc["conv"]),
                      (tc["state"], jc["state"])):
        _close(_np(got), _np(want), tol)
    # a resumed chunk: row 0 continues with 5 valid of 8, row 1 is idle
    xc = rng.normal(size=(2, 8, 32)).astype(np.float32)
    valid = np.array([[True] * 5 + [False] * 3, [False] * 8])
    resume = np.array([True, True])
    jy, jc = jmamba.apply_mamba(jp, JCtx(), "m", CFG, jnp.asarray(xc, jd),
                                jc, chunk_valid=jnp.asarray(valid),
                                resume=jnp.asarray(resume))
    before = {k: v.clone() for k, v in tc.items()}
    ty, tc = tmamba.apply_mamba(tp, TCtx(), "m", TCFG,
                                torch.from_numpy(xc).to(td), tc,
                                chunk_valid=torch.from_numpy(valid),
                                resume=torch.from_numpy(resume))
    _close(_np(ty[0, :5]), _np(jy[0, :5]), tol)
    for k in ("conv", "state"):
        _close(_np(tc[k]), _np(jc[k]), tol)
        assert torch.equal(tc[k][1], before[k][1]), f"idle row's {k}"
    for i, rv in enumerate(([True, True], [True, False], [False, True])):
        xd = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jy, jc = jmamba.apply_mamba_decode(jp, JCtx(), "m", CFG,
                                           jnp.asarray(xd, jd), jc,
                                           row_valid=jnp.asarray(rv))
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc = tmamba.apply_mamba_decode(tp, TCtx(), "m", TCFG,
                                           torch.from_numpy(xd).to(td), tc,
                                           row_valid=torch.tensor(rv))
        _close(_np(ty), _np(jy), tol)
        for k in ("conv", "state"):
            _close(_np(tc[k]), _np(jc[k]), tol)
            for r in range(2):
                if not rv[r]:
                    assert torch.equal(tc[k][r], before[k][r]), (i, k, r)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_specs_match_reference(arch):
    """The same paths and shapes at the published widths (specs only),
    the SSM scalars in f32."""
    js = {k: tuple(v.shape) for k, v in jget(arch).param_specs().items()}
    specs = tget(arch).param_specs()
    assert {k: tuple(v.shape) for k, v in specs.items()} == js
    for leaf in ("A_log", "D", "dt_bias"):
        assert specs[f"layers/0/mamba/{leaf}"].dtype == torch.float32
    cfg = tget(arch).cfg
    if arch == "mamba2_370m":
        assert (cfg.n_layers, cfg.d_model, cfg.ssm.d_inner, cfg.ssm.d_state,
                cfg.ssm.n_heads, cfg.vocab_size) == (48, 1024, 2048, 128,
                                                     32, 50280)
        assert specs["layers/0/mamba/in_proj/w"].shape == (4384, 1024)
    else:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_head, cfg.d_ff, cfg.sliding_window,
                cfg.global_attn_layers, cfg.ssm.d_state,
                cfg.vocab_size) == (32, 1600, 25, 5, 64, 5504, 1024,
                                    (0, 15, 31), 16, 32001)
        assert specs["layers/0/mamba/in_proj/w"].shape == (6482, 1600)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_logits_and_loss_match_reference(arch, dtype):
    """A 40-token batch (two SSD chunks of the mamba smoke config, past the
    hybrid's 32-token window)."""
    jm, jp, tm, tp = _pair(arch, dtype)
    b = _batch()
    jl = _np(jm.apply(jp, jnp.asarray(b["tokens"]), JCtx()))
    tl = _np(tm.apply(tp, torch.from_numpy(b["tokens"]), TCtx()))
    _close(tl, jl, TOL[dtype])
    jloss = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in b.items()},
                          JCtx()))
    tloss = float(tm.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                          TCtx()))
    assert tloss == pytest.approx(jloss, rel=1e-5 if dtype == "float32"
                                  else 1e-3)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mp_logits_match_reference(arch):
    """Under an fp8 plan on the SSD products and the mamba linears, with
    per-token scales (the lowercase ``b/c/q/k`` letters kept)."""
    jm, jp, tm, tp = _pair(arch)
    b = _batch(1)
    jctx = JCtx(mode="mp", mp=MP, act_scale_token=True)
    jl = np.asarray(jax.jit(lambda p, t: jm.apply(p, t, jctx))(
        jp, jnp.asarray(b["tokens"])))
    tl = tm.apply(tp, torch.from_numpy(b["tokens"]),
                  TCtx(mode="mp", mp=MP, act_scale_token=True))
    _close(_np(tl), jl, TOL["mp"])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_dense_prefill_and_decode_match_reference(arch):
    """Dense caches: a 40-token prefill (the hybrid's windowed ring holds
    32 of them) and three decode steps."""
    jm, jp, tm, tp = _pair(arch)
    b = _batch(2)
    B, T = b["tokens"].shape
    rng = np.random.default_rng(4)
    nxt = rng.integers(0, 512, (3, B, 1)).astype(np.int32)
    jc = jm.init_cache(B, T + 3)
    jl, jc = jm.prefill(jp, jnp.asarray(b["tokens"]), jc, JCtx())
    tc = tm.init_cache(B, T + 3, "cpu")
    tl, tc = tm.prefill(tp, torch.from_numpy(b["tokens"]), tc, TCtx())
    _close(_np(tl), _np(jl), TOL["float32"])
    for i in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[i]),
                                jnp.asarray(T + i, jnp.int32), jc, JCtx())
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt[i]), T + i, tc,
                                TCtx())
        _close(_np(tl), _np(jl), TOL["float32"])
    node = tc["layers/0"]
    if arch == "hymba_1p5b":
        assert set(node) == {"attn", "mamba"}
        assert set(node["mamba"]) == {"conv", "state"}
    else:
        assert set(node) == {"conv", "state"}
        assert node["state"].dtype == torch.float32


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_chunked_prefill_equals_one_shot_in_the_port(arch):
    """Paged ``prefill_chunk`` in two chunks of ``ssm.chunk`` = 32 tokens
    resumes the SSM state and conv history exactly: row 0's last logits
    and state equal one 64-token chunk's bit for bit; row 1, prefilled in
    the first chunk only, keeps its state through the second (start past
    0, no valid token)."""
    _, _, base, tp = _pair(arch, "bfloat16")
    tm = tget(arch, smoke=True, dtype="bfloat16",
              ssm=dataclasses.replace(base.cfg.ssm, chunk=32))
    T, bs = 64, 4
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 512, (2, T)).astype(np.int32))
    n_pages = -(-T // bs)
    bt = torch.arange(1, 1 + 2 * n_pages, dtype=torch.int32).reshape(
        2, n_pages)

    def ssm(pc):
        return {k: v.clone() for k, v in _leaves(pc)
                if k.endswith(("/conv", "/state"))}

    def run(chunks):
        pc = tm.init_paged_cache(2, 1 + 2 * n_pages, bs, "cpu")
        step, first = T // chunks, None
        for c in range(chunks):
            valid = torch.tensor([step, step if c == 0 else 0],
                                 dtype=torch.int32)
            start = torch.tensor([c * step, 0 if c == 0 else T],
                                 dtype=torch.int32)
            lg, pc = tm.prefill_chunk(tp, toks[:, c * step:(c + 1) * step],
                                      pc, TCtx(), start_pos=start,
                                      valid_len=valid, block_tables=bt)
            first = ssm(pc) if first is None else first
        return lg, ssm(pc), first

    l1, s1, _ = run(1)
    l2, s2, first = run(2)
    assert torch.equal(l1[0], l2[0])
    assert len(s1) == 2 * tm.cfg.n_layers
    for key in s1:
        assert torch.equal(s1[key][0], s2[key][0]), key
        assert torch.equal(s2[key][1], first[key][1]), key


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_paged_decode_rows_with_no_table_keep_their_state(arch):
    """A paged decode row whose block table starts with -1 (a vacant or
    mid-prefill slot) leaves its conv history and state bit-unchanged."""
    _, _, tm, tp = _pair(arch, "bfloat16")
    pc = tm.init_paged_cache(2, 5, 4, "cpu")
    gen = torch.Generator().manual_seed(0)
    for _, t in sorted(_leaves(pc)):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = {k: v.clone() for k, v in _leaves(pc)}
    bt = torch.tensor([[1, 2], [-1, -1]], dtype=torch.int32)
    tm.decode_step(tp, torch.tensor([[3], [5]], dtype=torch.int32),
                   torch.tensor([4, 0], dtype=torch.int32), pc, TCtx(),
                   block_tables=bt)
    after = dict(_leaves(pc))
    n = 0
    for key, t in before.items():
        if key.endswith(("/conv", "/state")):
            assert torch.equal(after[key][1], t[1]), key
            assert not torch.equal(after[key][0], t[0]), key
            n += 1
    assert n == 2 * tm.cfg.n_layers


def _leaves(tree, prefix=""):
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out += _leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


# ---------------------------------------------------------------------------
# graph, calibration, plan, KV scales, baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_graph_and_partition_match_reference(arch, smoke):
    """``build_graph``'s nodes, quantizable flags and edges equal the
    reference's (the full configs' graphs need no weights); the groups
    cover every quantizable node once and equal the serving op names."""
    jm, tm = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    g, jg = build_graph(tm), jbuild_graph(jm)
    assert list(g.nodes.items()) == list(jg.nodes.items())
    assert g.edges == jg.edges and g.residual_edges == jg.residual_edges
    groups = partition_sequential(g)
    names = [x for grp in groups for x in grp]
    assert sorted(names) == sorted(g.quantizable_nodes())
    assert len(names) == len(set(names))
    assert sorted(tm.serving_op_names()) == sorted(g.quantizable_nodes())
    if arch == "hymba_1p5b":
        assert "layers/0/hybrid_merge" in g.nodes


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_calibrate_and_plan_match_reference(arch):
    """``calibrate`` on the float32 smoke model: the same op inventory, the
    groups and gain tables, sensitivities within f32 summation order and
    the same IP plan."""
    jm, jp, tm, tp = _pair(arch)
    batches = [_batch(s, T=32) for s in (2, 3)]
    jb = jpl.calibrate(jm, jp, [{k: jnp.asarray(v) for k, v in b.items()}
                                for b in batches],
                       jpl.AMPOptions(hw=JHW(**dataclasses.asdict(H100_SXM))))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    assert any(o.name.endswith("mamba/cb_matmul") for o in tb.sens.ops)
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
        for a, b in zip(tb.objectives[obj]["gains"],
                        jb.objectives[obj]["gains"]):
            np.testing.assert_allclose(a, b, rtol=1e-9)
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=1e-3, abs=1e-12), name
    assert tb.sens.loss_mean == pytest.approx(jb.sens.loss_mean, rel=1e-5)
    tplan, jplan = tb.solve(0.02, "ET"), jb.solve(0.02, "ET")
    assert tplan.assignment == jplan.assignment
    assert tplan.n_quantized > 0


def test_kv_scales_nest_under_hybrid_layers():
    """Hybrid layers calibrate their attention half; SSM-only layers get
    None, as in the reference."""
    batches = [_batch(6, T=16)]
    for arch in SSM_ARCHS:
        jm, jp, tm, tp = _pair(arch)
        want = jkv(jm, jp, batches)
        got = calibrate_kv_scales(tm, tp, batches)
        assert len(got) == len(want) == tm.cfg.n_layers
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert [n for n, _ in g] == [n for n, _ in w] == ["k", "v"]
            np.testing.assert_allclose([s for _, s in g],
                                       [s for _, s in w], rtol=1e-5)
        assert (want[0] is None) == (arch == "mamba2_370m")


@pytest.mark.parametrize("seed", [0, 3])
def test_baselines_match_reference(seed):
    """Random (seeded shuffle) and Prefix (topological order) pick the same
    ops as the reference on one ``SensitivityResult``, within the budget,
    and never beat the IP's predicted gain on the bundle's tables."""
    tm = tget("mamba2_370m", smoke=True)
    g = build_graph(tm)
    names = [n for n in g.nodes if n in set(g.quantizable_nodes())]
    rng = np.random.default_rng(seed)
    sens = {n: float(s) for n, s in zip(names, rng.exponential(
        1.0, len(names)))}
    ts = SensitivityResult(sens, 2.0, 1.0, 4, [])
    js = JSens(sens, 2.0, 1.0, 4, [])
    for budget in (0.0, 1.5, 10.0, 1e9):
        assert random_strategy(names, ts, budget, seed=seed) == jrandom(
            names, js, budget, seed=seed)
        assert prefix_strategy(names, ts, budget) == jprefix(names, js,
                                                             budget)
        for asg in (random_strategy(names, ts, budget, seed=seed),
                    prefix_strategy(names, ts, budget)):
            assert ts.loss_mse(asg) <= budget * (1 + 1e-12)
    assert prefix_strategy(names, ts, 1e9) == {n: "fp8_e4m3" for n in names}
    assert random_strategy(names, ts, 0.0, seed=seed) == {}
