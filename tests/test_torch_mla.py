"""DeepSeek-V3's multi-head latent attention (MLA) in the port against the
reference: the dense-MLA smoke model's logits on bridged weights (full
forward, dense prefill and decode, paged prefill and decode through both
read paths, absorbed and expanded), the MLA form of the paged-decode plain
version against the interpret-mode Pallas kernel, the continuous engine's
tokens (fused, gather, one-shot), the fused dispatch predicate, the
calibration groups, and the configurations that must still raise.

The smoke model is the reference's ``deepseek_v3_671b`` smoke config with
``moe_layers=()`` and ``mtp_depth=0``: three MLA layers with dense MLPs.

Tolerances: as ``test_torch_model.py`` — f32 summation order (1e-4) in
float32, two bf16 ulps at the logits' magnitude (2^-6) in bf16, 2^-4 under
an fp8 MP plan. The MLA form of the paged kernel is all f32 (scores,
probabilities, output): rtol 1e-4 against the reference kernel. Engine
tokens follow ``test_torch_serve.py``: on the CPU the paths agree on every
token."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.pipeline as jpl  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jpaged)
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn.spec import default_generator  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, Request,  # noqa: E402
                               ServeEngine)

DENSE = dict(moe_layers=(), mtp_depth=0)
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}
# MLA's own ops; the lm_head under fp8 is held in test_torch_model.py (here
# one e4m3 step of one of its 128 inputs, |x|/8 of a value up to ~3, moves a
# logit by ~0.1 through a weight of ~0.3, past any ulp-level tolerance)
MP = {"layers/0/attn/q_b_proj": "fp8_e4m3",
      "layers/1/attn/kv_b_proj": "fp8_e4m3",
      "layers/2/attn/qk_matmul": "fp8_e4m3",
      "layers/2/attn/av_matmul": "fp8_e4m3"}


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(dtype: str, absorb: bool, **ov):
    jm = jget("deepseek_v3_671b", smoke=True, dtype=dtype,
              mla_absorb_decode=absorb, **DENSE, **ov)
    jp = jm.init(jax.random.key(0))
    tm = tget("deepseek_v3_671b", smoke=True, dtype=dtype,
              mla_absorb_decode=absorb, **DENSE, **ov)
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return (request.param, *_pair(request.param, True))


def _ctx(mp, torch_side: bool):
    cls = TCtx if torch_side else JCtx
    return cls(mode="mp", mp=mp, act_scale_token=True) if mp else cls()


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


def test_param_specs_match_reference():
    """The same paths and shapes as the reference for the dense prefix at
    DeepSeek-V3's published widths (specs only, nothing allocated), and the
    bridge takes every MLA path."""
    from repro.configs import deepseek_v3_671b as jc
    from repro.models.lm import LM as JLM
    from repro_torch.configs import deepseek_v3_671b as tc
    from repro_torch.models.lm import LM as TLM
    ov = dict(n_layers=3, block_types=("mla",) * 3, **DENSE)
    js = JLM(jc.config(**ov)).param_specs()
    ts = TLM(tc.config(**ov)).param_specs()
    assert {k: v.shape for k, v in js.items()} == {
        k: v.shape for k, v in ts.items()}
    assert {p.split("/")[-2] for p in ts if p.startswith("layers/0/attn/")
            } == {"q_a_proj", "q_norm", "q_b_proj", "kv_a_proj", "kv_norm",
                  "kv_b_proj", "o_proj"}


@pytest.mark.parametrize("mp", [None, MP], ids=["plain", "mp"])
def test_apply_and_loss_match_reference(pair, mp):
    dtype, jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 12)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 12)).astype(np.int32)
    tol = TOL["mp" if mp else dtype]
    want = jm.apply(jp, jnp.asarray(toks), _ctx(mp, False))
    got = tm.apply(tp, torch.from_numpy(toks), _ctx(mp, True))
    assert got.shape == (2, 12, 512)
    _close(got, want, tol)
    lj = jm.loss(jp, {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(labels)}, _ctx(mp, False))
    lt = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                      "labels": torch.from_numpy(labels)}, _ctx(mp, True))
    _close(lt.item(), float(lj), 1e-3)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed",
                                                       "expanded"])
@pytest.mark.parametrize("mp", [None, MP], ids=["plain", "mp"])
def test_prefill_and_decode_match_reference(pair, absorb, mp):
    """Reference dense prefill + decode against the port's dense path and
    its paged path (bucketed paged prefill, then paged decode through the
    fused kernel entry and the gather path), absorbed and expanded."""
    dtype = pair[0]
    jm, jp, tm, tp = (pair[1:] if absorb else _pair(dtype, False))
    rng = np.random.default_rng(2)
    B, T, steps, bs = 2, 11, 3, 4
    toks = rng.integers(0, 512, (B, T)).astype(np.int32)
    nxt = rng.integers(0, 512, (steps, B, 1)).astype(np.int32)
    tol = TOL["mp" if mp else dtype]
    jctx, tctx = _ctx(mp, False), _ctx(mp, True)
    max_len = T + steps
    jc = jm.init_cache(B, max_len)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc, jctx)
    want = [jl]
    for i in range(steps):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[i]),
                                jnp.asarray(T + i, jnp.int32), jc, jctx)
        want.append(jl)
    tc = tm.init_cache(B, max_len, "cpu")
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc, tctx)
    got = [tl]
    for i in range(steps):
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt[i]), T + i, tc, tctx)
        got.append(tl)
    for g, w in zip(got, want):
        _close(g, w, tol)
    n_pages = -(-max_len // bs)
    for paged_attn in ("fused", "gather"):
        pc = tm.init_paged_cache(B, 1 + B * n_pages, bs, "cpu")
        assert set(pc["layers/0"]) == {"ckv", "kr"}
        bt = torch.arange(1, 1 + B * n_pages, dtype=torch.int32).reshape(
            B, n_pages)
        pad = torch.zeros((B, 16), dtype=torch.int32)
        pad[:, :T] = torch.from_numpy(toks)
        tl, pc = tm.prefill_chunk(
            tp, pad, pc, tctx, start_pos=torch.zeros(B, dtype=torch.int32),
            valid_len=torch.full((B,), T, dtype=torch.int32), block_tables=bt)
        got = [tl]
        for i in range(steps):
            tl, pc = tm.decode_step(
                tp, torch.from_numpy(nxt[i]),
                torch.full((B,), T + i, dtype=torch.int32), pc, tctx,
                block_tables=bt, paged_attn=paged_attn)
            got.append(tl)
        for g, w in zip(got, want):
            _close(g, w, tol)


def test_serving_op_names_match_a_registry_trace():
    """The MLA op names the launcher checks plans against are exactly the
    ones a forward registers."""
    m = tget("deepseek_v3_671b", smoke=True, **DENSE)
    p = m.init(default_generator(0, "cpu"), "cpu")
    reg: list = []
    m.apply(p, torch.zeros((1, 4), dtype=torch.int32), TCtx(registry=reg))
    assert {op.name for op in reg} == m.serving_op_names()


def test_absorbed_decode_equals_expanded_decode():
    """Latent-space decode (W_uk into q, W_uv into the output) and the
    expanded decode compute the same attention: f32 logits within 1e-4."""
    tm_a = tget("deepseek_v3_671b", smoke=True, dtype="float32",
                mla_absorb_decode=True, **DENSE)
    tm_e = tget("deepseek_v3_671b", smoke=True, dtype="float32", **DENSE)
    tp = tm_a.init(default_generator(3, "cpu"), "cpu")
    rng = np.random.default_rng(8)
    B, T = 2, 9
    toks = torch.from_numpy(rng.integers(0, 512, (B, T)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, 512, (4, B, 1)).astype(np.int32))
    out = {}
    for name, m in (("absorbed", tm_a), ("expanded", tm_e)):
        c = m.init_cache(B, T + 4, "cpu")
        lg, c = m.prefill(tp, toks, c, TCtx())
        seq = [lg]
        for i in range(4):
            lg, c = m.decode_step(tp, nxt[i], T + i, c, TCtx())
            seq.append(lg)
        out[name] = torch.cat(seq, dim=1)
    _close(out["absorbed"], out["expanded"], 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_prompt_through_mla_flash_matches_reference(dtype):
    """MLA prefill at or beyond flash_min_seq goes through the blocked
    attention with Dk = nope + rope and Dv = v_head_dim. In float32 the two
    agree to summation order; in bf16 each of the three layers rounds its
    latents, heads and block probabilities once more than the logits, and a
    rounding that flips early moves a logit by up to four ulps (2^-5)."""
    jm, jp, tm, tp = _pair(dtype, True, flash_min_seq=16, flash_block=8)
    toks = np.random.default_rng(9).integers(0, 512, (1, 32)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(toks), JCtx())
    got = tm.apply(tp, torch.from_numpy(toks), TCtx())
    _close(got, want, 1e-4 if dtype == "float32" else 2.0 ** -5)


# ---------------------------------------------------------------------------
# the MLA form of the paged kernel (plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_mla_form_matches_reference_kernel(seed):
    """v=None (values from the ckv pages), q2 . k2 added to the scores,
    scale_mode 'mul', f32 query, scores, probabilities and output; rows of
    different lengths, a vacant row and stale entries pointing at poisoned
    blocks, against the interpret-mode Pallas kernel."""
    rng = np.random.default_rng(seed)
    B, H, r, dr, n_pages, bs = 3, 4, 32, 16, 5, 4
    n_live = B * n_pages
    n_blocks = 1 + n_live + 2
    lengths = np.array([n_pages * bs, 7, 0], np.int32)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    bt = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        bt[b, :used] = perm[c:c + used]
        c += used
        if lengths[b]:
            bt[b, used:] = n_blocks - 1          # a poisoned block
    ckv = rng.normal(size=(n_blocks, bs, 1, r)).astype(np.float32)
    kr = rng.normal(size=(n_blocks, bs, 1, dr)).astype(np.float32)
    ckv[-1], kr[-1] = 1e4, -1e4
    q1 = rng.normal(size=(B, 1, H, r)).astype(np.float32)
    q2 = rng.normal(size=(B, 1, H, dr)).astype(np.float32)
    kw = dict(scale=1.0 / math.sqrt(r + dr), scale_mode="mul")
    want = jpaged(jnp.asarray(q1), jnp.asarray(ckv, jnp.bfloat16), None,
                  jnp.asarray(bt), jnp.asarray(lengths), q2=jnp.asarray(q2),
                  k2=jnp.asarray(kr, jnp.bfloat16), out_dtype=jnp.float32,
                  interpret=True, **kw)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(ckv).to(torch.bfloat16), None,
        torch.from_numpy(bt), torch.from_numpy(lengths),
        q2=torch.from_numpy(q2), k2=torch.from_numpy(kr).to(torch.bfloat16),
        out_dtype=torch.float32, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, r)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert (got[2] == 0).all(), "a length-0 row must give zeros"


def test_mla_context_limit():
    """The table width one block's shared memory holds in the MLA form at
    block size 16: 6,624 keys with groups of 8 heads, 54,144 with one; and
    the group size the wrapper takes."""
    assert tpa.max_context(512, 64, 16, hg=8) == 6624
    assert tpa.max_context(512, 64, 16) == 54144
    assert tpa.head_group(128, 512, 64, 6624 // 16, 16) == 8
    assert tpa.head_group(128, 512, 64, 6624 // 16 + 1, 16) == 4
    assert tpa.head_group(128, 512, 64, 54144 // 16, 16) == 1
    assert tpa.head_group(128, 512, 64, 54144 // 16 + 1, 16) == 0
    assert tpa.head_group(4, 64, 0, 10, 16) == 4   # llama3_1b: one group
    # with a card's SM count, groups shrink until half the SMs get a block
    assert tpa.head_group(4, 64, 0, 10, 16, rows=32, sms=132) == 1
    assert tpa.head_group(128, 512, 64, 10, 16, rows=4, sms=132) == 4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """The bf16 dense-MLA smoke model with absorbed decode, random weights."""
    model = tget("deepseek_v3_671b", smoke=True, mla_absorb_decode=True,
                 **DENSE)
    params = model.init(default_generator(2, "cpu"), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 200, size=n).astype(np.int32)
               for n in (11, 6, 9)]
    return model, params, prompts


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    orig = tpa.paged_decode_attention

    def counting(*a, **kw):
        calls.append(kw.get("scale_mode"))
        return orig(*a, **kw)

    monkeypatch.setattr(tpa, "paged_decode_attention", counting)
    return calls


def _oneshot(model, params, prompts, max_new, mp=None):
    eng = ServeEngine(model, mp=mp, device="cpu")
    return [eng.generate(params, {"tokens": p[None]},
                         max_new_tokens=max_new).tokens[0] for p in prompts]


def _serve(model, params, prompts, max_new, **kw):
    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=24,
                                   block_size=4, device="cpu", **kw)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=max_new, arrival=2 * i)
            for i, p in enumerate(prompts)]
    return eng.serve(params, reqs)


@pytest.mark.parametrize("mp", [None, MP], ids=["plain", "mp"])
def test_fused_gather_and_oneshot_tokens_agree(served, kernel_calls, mp):
    """The absorbed MLA decode through the fused kernel, through the gather
    path, and the one-shot engine give the same greedy tokens; the fused
    engine reaches the kernel's MLA form once per decode step and layer,
    except on the layer whose qk/av BGEMMs the plan quantizes."""
    model, params, prompts = served
    ref = _oneshot(model, params, prompts, 5, mp=mp)
    for pa in ("gather", "fused"):
        kernel_calls.clear()
        summ = _serve(model, params, prompts, 5, paged_attn=pa, mp=mp)
        for i in range(len(prompts)):
            np.testing.assert_array_equal(summ.results[i].tokens, ref[i],
                                          err_msg=pa)
        fused_layers = model.cfg.n_layers - (1 if mp else 0)
        want = summ.n_steps * fused_layers if pa == "fused" else 0
        assert len(kernel_calls) == want
        assert set(kernel_calls) <= {"mul"}


def test_expanded_decode_always_gathers(kernel_calls):
    model = tget("deepseek_v3_671b", smoke=True, **DENSE)
    params = model.init(default_generator(2, "cpu"), "cpu")
    prompts = [np.arange(1, 8, dtype=np.int32)]
    summ = _serve(model, params, prompts, 3, paged_attn="fused")
    np.testing.assert_array_equal(summ.results[0].tokens,
                                  _oneshot(model, params, prompts, 3)[0])
    assert kernel_calls == []


def test_nonunit_scales_route_to_gather(kernel_calls):
    """The fused absorbed-MLA predicate treats non-unit dequant scales as a
    gather condition: an engine holding a scaled-fp8 MLA cache drains, token
    for token as the explicit gather engine, without a kernel call."""
    model = tget("deepseek_v3_671b", smoke=True, mla_absorb_decode=True,
                 kv_cache_dtype="fp8_e4m3",
                 kv_dequant_scales=(("ckv", 0.5), ("kr", 0.5)), **DENSE)
    params = model.init(default_generator(2, "cpu"), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 200, size=n).astype(np.int32) for n in (11, 6)]
    outs = {pa: _serve(model, params, prompts, 4, paged_attn=pa)
            for pa in ("fused", "gather")}
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs["fused"].results[i].tokens,
                                      outs["gather"].results[i].tokens)
    assert kernel_calls == []


def test_mp_plan_on_qk_matmul_gathers():
    from repro_torch.nn import layers as TL
    cfg = tget("deepseek_v3_671b", smoke=True, mla_absorb_decode=True,
               **DENSE).cfg
    mp_ctx = TCtx(mode="mp", mp={"layers/1/attn/qk_matmul": "fp8_e4m3"})
    assert not TL.use_fused_paged(mp_ctx, "layers/1/attn", "fused")
    assert TL.use_fused_paged(mp_ctx, "layers/0/attn", "fused")
    assert cfg.mla_cfg_for(1).absorb_decode


# ---------------------------------------------------------------------------
# calibration and what still raises
# ---------------------------------------------------------------------------


def test_calibrate_groups_match_reference():
    """Calibration on the float32 dense-MLA smoke model: the same op
    inventory, the same partition groups and gain tables as the
    reference's, and sensitivities within f32 summation order."""
    jm, jp, tm, tp = _pair("float32", False)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 512, (2, 16)).astype(np.int32),
                "labels": rng.integers(0, 512, (2, 16)).astype(np.int32)}
               for _ in range(2)]
    jb = jpl.calibrate(jm, jp, [{k: jnp.asarray(v) for k, v in b.items()}
                                for b in batches],
                       jpl.AMPOptions(hw=JHW(**dataclasses.asdict(H100_SXM))))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
    groups = tb.objectives["TT"]["groups"]
    assert any("layers/0/attn/kv_b_proj" in g for g in groups)
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=1e-4), name
    assert tgraphs.build_graph(tm).nodes == tgraphs.build_lm_graph(
        tm.cfg).nodes


def test_unmodified_configs_raise_naming_moe_and_mtp():
    for smoke in (False, True):
        with pytest.raises(NotImplementedError, match="MoE.*mtp_depth"):
            tget("deepseek_v3_671b", smoke=smoke)
    with pytest.raises(NotImplementedError, match="mamba"):
        tget("deepseek_v3_671b", smoke=True, block_types=("mla", "mamba",
                                                          "mla"), **DENSE)
    with pytest.raises(NotImplementedError, match="MoE"):
        tgraphs.build_lm_graph(tget.__globals__["get_smoke_config"](
            "deepseek_v3_671b"))
