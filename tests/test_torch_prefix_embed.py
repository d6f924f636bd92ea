"""LLaVA's prefix embeddings in the port (``LM`` with ``prefix_embed``:
precomputed patch embeddings prepended to the text tokens' embeddings)
against the reference package on the same seeded inputs and weights,
bridged through numpy: the forward, the loss over the text positions, the
prefill, ``ServeEngine`` tokens, calibration, and A7's analytic counts of
the full-size LLaVA.

Tolerances (as ``test_torch_model.py``): float32 holds f32 summation order
(1e-4 of the output's scale); bfloat16 two ulps at the logits' scale
(2^-6); an fp8 MP plan 2^-4. Greedy tokens, op inventories and analytic
counts are held equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.core.pipeline as jpl  # noqa: E402
from repro.analysis.analytic import analytic_costs as janalytic  # noqa: E402
from repro.analysis.model_stats import param_stats as jstats  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.analysis.analytic import analytic_costs  # noqa: E402
from repro_torch.analysis.model_stats import param_stats  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs.shapes import (SHAPES,  # noqa: E402
                                        VLM_PREFIX_TOKENS, input_specs)
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "llava_next_34b"
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}
MP = {"layers/0/attn/q_proj": "fp8_e4m3", "layers/0/mlp/down_proj":
      "fp8_e4m3", "layers/1/attn/qk_matmul": "fp8_e4m3",
      "layers/1/mlp/gate_proj": "fp8_e4m3", "lm_head": "fp8_e4m3"}
P = 6
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


def _pair(dtype: str = "float32"):
    if dtype not in _PAIRS:
        jm = jget(ARCH, smoke=True, dtype=dtype)
        tm = tget(ARCH, smoke=True, dtype=dtype)
        jp = jm.init(jax.random.key(0))
        tp = params_from_flat({k: _np(v) for k, v in
                               flatten_paths(jp).items()}, tm.cfg, "cpu")
        _PAIRS[dtype] = (jm, jp, tm, tp)
    return _PAIRS[dtype]


def _batch(seed: int, B: int = 2, T: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    return {"prefix_embeds": rng.standard_normal((B, P, 128)).astype(
                np.float32),
            "tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, T)).astype(np.int32)}


def _j(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_loss_prefill_match_reference(dtype):
    """The forward over prefix + text (P + T logits), the loss over the
    text positions only, and the prefill's last logits and caches, plain
    and under an MP plan."""
    jm, jp, tm, tp = _pair(dtype)
    b = _batch(1)
    jb, tb = _j(b), _t(b)
    for jctx, tctx, tol in ((JCtx(), TCtx(), TOL[dtype]),
                            (JCtx(mode="mp", mp=MP), TCtx(mode="mp", mp=MP),
                             TOL["mp"])):
        got = tm.apply(tp, tb["tokens"], tctx,
                       prefix_embeds=tb["prefix_embeds"])
        assert got.shape == (2, P + 10, 512)
        _close(_np(got), _np(jm.apply(jp, jb["tokens"], jctx,
                                      prefix_embeds=jb["prefix_embeds"])),
               tol)
        assert float(tm.loss(tp, tb, tctx)) == pytest.approx(
            float(jm.loss(jp, jb, jctx)), rel=tol)
    tc = tm.init_cache(2, 24, "cpu")
    lt, tc = tm.prefill(tp, tb["tokens"], tc, TCtx(),
                        prefix_embeds=tb["prefix_embeds"])
    lj, jc = jm.prefill(jp, jb["tokens"], jm.init_cache(2, 24), JCtx(),
                        prefix_embeds=jb["prefix_embeds"])
    _close(_np(lt), _np(lj), TOL[dtype])
    _close(_np(tc["layers/1"]["k"]), _np(jc["layers/1"]["k"]), TOL[dtype])
    assert (tc["layers/0"]["pos"][:, :P + 10] >= 0).all()


def test_loss_covers_the_text_positions_only():
    """The prefix's positions carry no label: the loss is the text
    positions' cross-entropy of the forward's last T logits."""
    _, _, tm, tp = _pair()
    tb = _t(_batch(2))
    logits = tm.apply(tp, tb["tokens"], TCtx(),
                      prefix_embeds=tb["prefix_embeds"])[:, P:]
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        tb["labels"].reshape(-1).long())
    assert float(tm.loss(tp, tb, TCtx())) == pytest.approx(float(want),
                                                           rel=1e-5)


@pytest.mark.parametrize("plan", ["plain", "mp"])
def test_serve_engine_tokens_match_reference(plan):
    """``ServeEngine.generate`` on a (prefix_embeds, tokens) batch, float32
    smoke weights: the reference engine's greedy tokens, plain and under a
    plan; decode starts after prefix and prompt, and the batch takes the
    per-length prefill step."""
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, tm, tp = _pair()
    b = _batch(4, B=3, T=5)
    gen = {k: b[k] for k in ("prefix_embeds", "tokens")}
    mp = MP if plan == "mp" else None
    want = np.asarray(JServeEngine(jm, mp=mp, donate=False).generate(
        jp, _j(gen), max_new_tokens=6).tokens)
    eng = ServeEngine(tm, mp=mp, device="cpu")
    got = eng.generate(tp, gen, max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, want)
    assert eng.prefill_compile_keys == {("legacy", 5)}
    assert eng._caches[0] == (3, P + 5 + 6, 0)


def test_generate_equals_a_greedy_loop_over_full_forwards():
    """Inside the port, bf16: every generated token is the argmax of a full
    forward over prefix + prompt + the tokens so far (decode positions
    continue after the prefix); bf16 prefix embeddings serve alike."""
    _, _, tm, tp = _pair("bfloat16")
    b = _batch(5, B=2, T=4)
    got = ServeEngine(tm, device="cpu").generate(
        tp, {"prefix_embeds": b["prefix_embeds"].astype(ml_dtypes.bfloat16),
             "tokens": b["tokens"]}, max_new_tokens=4).tokens
    toks = torch.from_numpy(b["tokens"])
    pre = torch.from_numpy(b["prefix_embeds"]).to(torch.bfloat16)
    for _ in range(4):
        with torch.no_grad():
            nxt = tm.apply(tp, toks, TCtx(), prefix_embeds=pre)[:, -1]
        toks = torch.cat([toks, nxt.argmax(-1, keepdim=True).int()], 1)
    np.testing.assert_array_equal(got, toks[:, 4:].numpy())


def test_calibration_matches_reference():
    """``calibrate`` on the float32 smoke model over (prefix_embeds,
    tokens, labels) batches: the same op inventory (operands over P + T
    positions, the head over T), groups and plan; s_l within f32
    summation order; a bf16 batch hashes as the reference's."""
    jm, jp, tm, tp = _pair()
    batches = [_batch(s) for s in (6, 7)]
    jb = jpl.calibrate(jm, jp, [_j(b) for b in batches],
                       jpl.AMPOptions(hw=JHW(**dataclasses.asdict(
                           H100_SXM))))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    ops = {o.name: o for o in tb.sens.ops}
    assert ops["layers/0/attn/q_proj"].lhs_shape == (2, P + 10, 128)
    assert ops["lm_head"].lhs_shape == (2, 10, 128)
    for obj in ("ET", "TT", "M"):
        assert tb.objectives[obj]["groups"] == jb.objectives[obj]["groups"]
    js, ts = jb.sens.sensitivity, tb.sens.sensitivity
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=1e-3, abs=1e-12), name
    assert tb.solve(0.02, "ET").assignment == jb.solve(0.02,
                                                       "ET").assignment
    bf = [dict(b, prefix_embeds=b["prefix_embeds"].astype(
        ml_dtypes.bfloat16)) for b in batches]
    tbf = [dict(_t(b), prefix_embeds=torch.from_numpy(
        b["prefix_embeds"]).to(torch.bfloat16)) for b in batches]
    assert tpl._calib_hash(tbf) == tpl._calib_hash(bf) == jpl._calib_hash(
        [_j(b) for b in bf])


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_analytic_costs_match_reference(cell):
    """A7's counts of the full-size LLaVA (its 576-token image prefix in
    the train and prefill cells): the port's ``meta``-device trace equals
    the reference's ``jax.eval_shape`` trace op for op."""
    want = janalytic(ARCH, cell)
    got = analytic_costs(ARCH, cell)
    assert got["ops"] == want["ops"]
    for k in ("flops", "bytes", "n_ops", "n_params", "fwd_flops"):
        assert got[k] == want[k], k
    ins = input_specs(tget(ARCH), SHAPES[cell])
    if cell != "decode_32k":
        assert ins["prefix_embeds"].shape[1] == VLM_PREFIX_TOKENS
        assert ins["tokens"].shape[1] == SHAPES[cell].seq_len \
            - VLM_PREFIX_TOKENS
    assert all(t.device.type == "meta" for t in ins.values())
    assert param_stats(tget(ARCH)) == jstats(jget(ARCH))
