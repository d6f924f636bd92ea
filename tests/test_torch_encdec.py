"""The encoder-decoder (Whisper) in the port (``repro_torch.models.encdec``,
cross-attention in ``nn.layers``, its graph, calibration and serving) and
A7's analytic counts (``repro_torch.analysis``), against the reference
package on the same seeded inputs and weights, bridged through numpy.

Tolerances (as ``test_torch_model.py``): float32 holds f32 summation order
(1e-4 of the output's scale); bfloat16 two ulps at the logits' scale
(2^-6); an fp8 MP plan 2^-4; the sinusoid 1e-4 absolute (the two
packages' f32 ``sin``/``cos`` part by up to 6.1e-5 at angles up to 1500
rad, Whisper's 30-s window, and by 3.8e-6 below 128). Greedy tokens,
graphs, groups, op inventories and analytic counts are held equal.
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
from repro.analysis.analytic import \
    terms_under_assignment as jterms  # noqa: E402
from repro.analysis.model_stats import model_flops as jflops  # noqa: E402
from repro.analysis.model_stats import param_stats as jstats  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core.graphs import build_graph as jbuild_graph  # noqa: E402
from repro.core.partition import \
    partition_sequential as jpartition  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.analysis.analytic import (analytic_costs,  # noqa: E402
                                           terms_under_assignment)
from repro_torch.analysis.model_stats import (model_flops,  # noqa: E402
                                              param_stats)
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.graphs import build_graph  # noqa: E402
from repro_torch.core.partition import partition_sequential  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.launch.steps import GraphedForward  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeEngine)

ARCH = "whisper_base"
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}
MP = {"enc/0/attn/q_proj": "fp8_e4m3", "enc/1/mlp/down_proj": "fp8_e4m3",
      "dec/0/cross/k_proj": "fp8_e4m3", "dec/0/cross/qk_matmul": "fp8_e4m3",
      "dec/1/attn/av_matmul": "fp8_e4m3", "dec/1/mlp/up_proj": "fp8_e4m3",
      "lm_head": "fp8_e4m3"}
ENC_LEN = 12
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
    """(reference model, its params, port model, the same params bridged)
    at smoke size."""
    if dtype not in _PAIRS:
        jm = jget(ARCH, smoke=True, dtype=dtype)
        tm = tget(ARCH, smoke=True, dtype=dtype)
        jp = jm.init(jax.random.key(0))
        tp = params_from_flat({k: _np(v) for k, v in
                               flatten_paths(jp).items()}, tm.cfg, "cpu")
        _PAIRS[dtype] = (jm, jp, tm, tp)
    return _PAIRS[dtype]


def _batch(seed: int, B: int = 2, T: int = 10, S: int = ENC_LEN) -> dict:
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S, 64)).astype(np.float32),
            "tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, T)).astype(np.int32)}


def _j(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_sinusoid_matches_reference():
    pos = np.arange(1500, dtype=np.int32)[None].repeat(2, 0)
    want = np.asarray(jencdec._sinusoid(jnp.asarray(pos), 512))
    got = tencdec._sinusoid(torch.from_numpy(pos), 512).numpy()
    assert got.shape == want.shape == (2, 1500, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("source", ["kv_x", "cache"])
def test_cross_attention_matches_reference(source):
    """One cross-attention layer, float32: K/V projected from the encoder
    output (``kv_x``) or read from the cache ``cross_kv`` precomputes;
    queries at positions past 0 (decode) see every frame."""
    jm, jp, tm, tp = _pair()
    cfg_j, cfg_t = jm.cfg.enc_attn, tm.cfg.enc_attn
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    enc = rng.standard_normal((2, ENC_LEN, 64)).astype(np.float32)
    pos = np.full((2, 3), 7, np.int32)
    pj, pt = jp["dec"]["0"]["cross"], tp["dec"]["0"]["cross"]
    if source == "kv_x":
        kw_j, kw_t = dict(kv_x=jnp.asarray(enc)), dict(kv_x=torch.from_numpy(
            enc))
    else:
        cj = jlayers.cross_kv(pj, JCtx(), "c", cfg_j, jnp.asarray(enc))
        ct = tlayers.cross_kv(pt, TCtx(), "c", cfg_t, torch.from_numpy(enc))
        _close(_np(ct["k"]), _np(cj["k"]), TOL["float32"])
        kw_j, kw_t = dict(cache=cj), dict(cache=ct)
    yj, _ = jlayers.attention(pj, JCtx(), "c", cfg_j, jnp.asarray(x),
                              jnp.asarray(pos), cross=True, **kw_j)
    yt, c = tlayers.attention(pt, TCtx(), "c", cfg_t, torch.from_numpy(x),
                              torch.from_numpy(pos), cross=True, **kw_t)
    _close(_np(yt), _np(yj), TOL["float32"])
    if source == "cache":
        assert c is kw_t["cache"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_loss_match_reference(dtype):
    jm, jp, tm, tp = _pair(dtype)
    b = _batch(1)
    _close(_np(tm.apply(tp, _t(b), TCtx())), _np(jm.apply(jp, _j(b), JCtx())),
           TOL[dtype])
    assert float(tm.loss(tp, _t(b), TCtx())) == pytest.approx(
        float(jm.loss(jp, _j(b), JCtx())), rel=TOL[dtype])
    mp_j = JCtx(mode="mp", mp=MP)
    mp_t = TCtx(mode="mp", mp=MP)
    _close(_np(tm.apply(tp, _t(b), mp_t)), _np(jm.apply(jp, _j(b), mp_j)),
           TOL["mp"])


def test_prefill_decode_matches_full_forward_and_reference():
    """As ``tests/test_models.py::test_whisper_prefill_decode``, bf16:
    prefill of 5 tokens then 4 decode steps give the full forward's
    logits (within 0.05), and the reference's prefill and decode logits
    (within 2^-6)."""
    jm, jp, tm, tp = _pair("bfloat16")
    b = _batch(2, S=16)
    full = _np(tm.apply(tp, _t(b), TCtx()))
    fr, tok = torch.from_numpy(b["frames"]), torch.from_numpy(b["tokens"])
    tc = tm.init_cache(2, 16, 16, "cpu")
    jc = jm.init_cache(2, 16, 16)
    lp, tc = tm.prefill(tp, fr, tok[:, :5], tc, TCtx())
    jlp, jc = jm.prefill(jp, jnp.asarray(b["frames"]),
                         jnp.asarray(b["tokens"][:, :5]), jc, JCtx())
    assert np.abs(_np(lp)[:, 0] - full[:, 4]).max() < 0.05
    _close(_np(lp), _np(jlp), TOL["bfloat16"])
    for t in range(5, 9):
        lg, tc = tm.decode_step(tp, tok[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32), tc,
                                TCtx())
        jlg, jc = jm.decode_step(jp, jnp.asarray(b["tokens"][:, t:t + 1]),
                                 jnp.array(t, jnp.int32), jc, JCtx())
        assert np.abs(_np(lg)[:, 0] - full[:, t]).max() < 0.05, t
        _close(_np(lg), _np(jlg), TOL["bfloat16"])


@pytest.mark.parametrize("plan", ["plain", "mp"])
def test_serve_engine_tokens_match_reference(plan):
    """``ServeEngine.generate`` on a (frames, tokens) batch, float32 smoke
    weights: the reference engine's greedy tokens, plain and under a
    plan; the batch goes to the per-length prefill step, and decode starts
    after the prompt."""
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, tm, tp = _pair()
    b = _batch(4, B=3, T=4)
    mp = MP if plan == "mp" else None
    want = np.asarray(JServeEngine(jm, mp=mp, donate=False).generate(
        jp, _j({k: b[k] for k in ("frames", "tokens")}),
        max_new_tokens=6).tokens)
    eng = ServeEngine(tm, mp=mp, device="cpu")
    got = eng.generate(tp, {"frames": b["frames"], "tokens": b["tokens"]},
                       max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, want)
    assert eng.prefill_compile_keys == {("legacy", 4)}
    # bf16 frames, as a calibration or serving batch carries them
    bf = {"frames": b["frames"].astype(ml_dtypes.bfloat16),
          "tokens": b["tokens"]}
    assert eng.ttft(tp, bf, max_len=10, n_iters=1, n_warmup=0) > 0


def test_serve_engine_refuses_keys_the_model_does_not_take():
    """A batch is never served as text alone: frames to a decoder-only
    LM, prefix embeddings to the encoder-decoder, or an encoder-decoder
    batch without frames raise."""
    _, _, tm, tp = _pair()
    b = _batch(5)
    eng = ServeEngine(tm, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        eng.generate(tp, {"tokens": b["tokens"]}, max_new_tokens=2)
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.generate(tp, {"tokens": b["tokens"], "frames": b["frames"],
                          "prefix_embeds": b["frames"]}, max_new_tokens=2)
    lm = tget("llama3_1b", smoke=True)
    lp = lm.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="frames"):
        ServeEngine(lm, device="cpu").generate(
            lp, {"tokens": b["tokens"], "frames": b["frames"]},
            max_new_tokens=2)


def test_continuous_engine_refuses_encdec():
    _, _, tm, _ = _pair()
    with pytest.raises(NotImplementedError,
                       match="continuous batching currently serves "
                             "decoder-only LMs"):
        ContinuousBatchingEngine(tm, device="cpu")


def test_graph_and_groups_match_reference():
    for smoke in (True, False):
        jg = jbuild_graph(jget(ARCH, smoke=smoke))
        tg = build_graph(tget(ARCH, smoke=smoke))
        assert list(tg.nodes.items()) == list(jg.nodes.items())
        assert tg.edges == jg.edges
        assert tg.residual_edges == jg.residual_edges
        for drop in (True, False):
            assert partition_sequential(tg, drop_residual=drop,
                                        max_group_size=8) == jpartition(
                jg, drop_residual=drop, max_group_size=8)


def test_calibration_matches_reference():
    """``calibrate`` on the float32 smoke model over (frames, tokens,
    labels) batches: the same op inventory (the encoder's ops, the cross
    K/V from the encoder output), groups, gain tables and plan, and s_l
    within f32 summation order; a bf16 batch hashes as the reference's."""
    jm, jp, tm, tp = _pair()
    batches = [_batch(s) for s in (6, 7)]
    hw = JHW(**dataclasses.asdict(H100_SXM))
    jb = jpl.calibrate(jm, jp, [_j(b) for b in batches],
                       jpl.AMPOptions(hw=hw))
    tb = tpl.calibrate(tm, tp, batches, tpl.AMPOptions())
    assert [dataclasses.asdict(o) for o in tb.sens.ops] == [
        dataclasses.asdict(o) for o in jb.sens.ops]
    assert "enc/0/attn/qk_matmul" in tb.op_names
    assert tb.sens.ops[tb.op_names.index("dec/1/cross/k_proj")].lhs_shape \
        == (2, ENC_LEN, 64)
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
    assert tb.solve(0.02, "ET").assignment == jb.solve(0.02,
                                                       "ET").assignment
    bf = [{k: (v.astype(ml_dtypes.bfloat16) if k == "frames" else v)
           for k, v in b.items()} for b in batches]
    tbf = [{k: (torch.from_numpy(v).to(torch.bfloat16) if k == "frames"
                else torch.from_numpy(v)) for k, v in b.items()}
           for b in batches]
    assert tpl._calib_hash(tbf) == tpl._calib_hash(bf) == jpl._calib_hash(
        [_j(b) for b in bf])


def test_graphed_forward_takes_frames():
    """The measured tier's forward (``GraphedForward``, eager on the CPU)
    takes the encoder-decoder's batch: tokens, then frames."""
    _, _, tm, tp = _pair()
    b = _batch(8)
    ctx = TCtx(mode="mp", mp=MP, impl="kernel")
    got = GraphedForward(tm, ctx)(tp, torch.from_numpy(b["tokens"]),
                                  torch.from_numpy(b["frames"]))
    want = tm.apply(tp, _t(b), ctx)
    assert torch.equal(got, want)


def test_caveat_decoder_self_attention_applies_rope():
    """Reference caveat: the decoder's self-attention rotates q and k
    (theta 10000) on top of the sinusoidal positions; the encoder's and
    the cross-attention do not. The port keeps it: without the rotation
    its logits leave the reference's."""
    jm, jp, tm, tp = _pair()
    assert tm.cfg.dec_attn.rope_theta == 10000.0
    assert tm.cfg.enc_attn.rope_theta is None
    b = _batch(9)
    want = _np(jm.apply(jp, _j(b), JCtx()))
    _close(_np(tm.apply(tp, _t(b), TCtx())), want, TOL["float32"])

    class NoRope(tencdec.EncDecConfig):
        @property
        def dec_attn(self):
            return dataclasses.replace(super().dec_attn, rope_theta=None)
    plain = tencdec.EncDec(NoRope(**dataclasses.asdict(tm.cfg)))
    assert np.abs(_np(plain.apply(tp, _t(b), TCtx())) - want).max() > 1e-2


def test_caveat_prefill_projects_the_cross_kv_twice():
    """Reference caveat: at prefill each decoder layer projects the
    encoder's K/V for its cross-attention and again into the decode
    cache; the port does both, so its registry records what the
    reference's records, and the cache holds the K/V the prefill
    attended."""
    jm, jp, tm, tp = _pair()
    b = _batch(10, T=5)
    jreg: list = []
    jax.eval_shape(lambda p, c: jm.prefill(
        p, jnp.asarray(b["frames"]), jnp.asarray(b["tokens"]), c,
        JCtx(registry=jreg)), jp, jm.init_cache(2, 8, ENC_LEN))
    treg: list = []
    tc = tm.init_cache(2, 8, ENC_LEN, "cpu")
    with torch.no_grad():
        tm.prefill(tp, torch.from_numpy(b["frames"]),
                   torch.from_numpy(b["tokens"]), tc, TCtx(registry=treg))
    assert [dataclasses.asdict(o) for o in treg] == [
        dataclasses.asdict(o) for o in jreg]
    names = [o.name for o in treg]
    assert names.count("dec/0/cross/k_proj") == 2
    assert names.count("dec/0/cross/v_proj") == 2
    with torch.no_grad():
        enc = tm.encode(tp, torch.from_numpy(b["frames"]), TCtx())
        kv = tlayers.cross_kv(tp["dec"]["1"]["cross"], TCtx(), "c",
                              tm.cfg.enc_attn, enc)
    assert torch.equal(tc["dec/1/cross"]["k"], kv["k"])
    assert torch.equal(tc["dec/1/cross"]["v"], kv["v"])


def test_caveat_cross_kv_hang_off_cross_norm():
    """Reference caveat: the graph feeds the cross ``k_proj``/``v_proj``
    from ``cross_norm`` (the decoder stream), though the model feeds them
    the encoder output; the partition follows the graph, so they group
    with the cross query."""
    g = build_graph(tget(ARCH, smoke=True))
    for proj in ("q_proj", "k_proj", "v_proj"):
        assert ("dec/0/cross_norm", f"dec/0/cross/{proj}") in g.edges
    assert ("enc_final_norm", "dec/0/cross/k_proj") not in g.edges
    groups = partition_sequential(g, drop_residual=True, max_group_size=8)
    group = next(gr for gr in groups if "dec/0/cross/k_proj" in gr)
    assert "dec/0/cross/q_proj" in group


CELLS = [("whisper_base", "train_4k"), ("whisper_base", "prefill_32k"),
         ("whisper_base", "decode_32k"), ("llama3_1b", "train_4k"),
         ("llama3_1b", "prefill_32k"), ("llama3_1b", "decode_32k"),
         ("deepseek_v3_671b", "prefill_32k"), ("hymba_1p5b", "long_500k")]


@pytest.mark.parametrize("arch,cell", CELLS)
def test_analytic_costs_match_reference(arch, cell):
    """A7's counts at full size: the port's ``meta``-device trace against
    the reference's ``jax.eval_shape`` trace, every op's integer MACs and
    element counts equal, and so the FLOP and byte totals; the roofline
    terms under an assignment priced alike; ``model_stats`` equal."""
    want = janalytic(arch, cell)
    got = analytic_costs(arch, cell)
    assert got["ops"] == want["ops"]
    for k in ("flops", "bytes", "n_ops", "n_params", "fwd_flops"):
        assert got[k] == want[k], k
    kind = SHAPES[cell].kind
    asg = {op["name"]: "fp8_e4m3" for op in got["ops"][::3]}
    for fused in (False, True):
        assert terms_under_assignment(got, kind, 1, H100_SXM, asg,
                                      fused_quant=fused) == jterms(
            want, kind, 1, H100_SXM, asg, fused_quant=fused)
    assert param_stats(tget(arch)) == jstats(jget(arch))
    assert model_flops(tget(arch), SHAPES[cell]) == jflops(
        jget(arch), JSHAPES[cell])
