"""The port's model (``repro_torch.models.lm``) against the reference ``LM``
on the same weights, bridged through numpy by param path.

Tolerances, stated for logits of magnitude up to 1 and scaled by the
logits' scale, max(1, max |logit|): float32 configs hold the algorithm to
f32 summation-order noise (atol 1e-4 on O(1) logits after a few layers);
bf16 configs, the working type, to two bf16 ulps at the logits' magnitude
(both sides sum in f32 and round once per op, so most logits agree
bitwise, a few by one rounding); MP plans add fp8 fake-quant: an
activation that differs by one rounding may land on the other side of an
e4m3 rounding boundary, a step of 1/8 of its value, so MP logits get 2^-4.
The scale is 1 for llama3_1b (tied head, |logit| < 1); llama3_8b's untied
head (std 0.089 against the embedding's 0.020) makes its smoke logits 5x
larger (up to 4.2), and with them the step a flipped rounding moves them
by (measured: 0.19 under the MP plan in float32, where the frameworks' f32
sums differ by an ulp; 0.021 at one bf16 logit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.models.registry import ARCH_IDS, get_model as tget  # noqa: E402
from repro_torch.nn.spec import flatten_paths as tflatten  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402

MP = {"layers/0/attn/q_proj": "fp8_e4m3", "layers/0/mlp/down_proj": "fp8_e4m3",
      "layers/1/attn/qk_matmul": "fp8_e4m3",
      "layers/1/attn/av_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "mp": 2.0 ** -4}


# the dense configs the port serves, each at smoke size: llama3_1b (tied
# head, d_head 64), llama3_8b (untied head, d_head 128 at full width), and
# the features no llama has: QKV bias and a tied head (qwen2p5_3b), QKV bias
# with one KV head (qwen2p5_32b), layernorm with a non-gated relu2 MLP
# (nemotron_4_15b) and with a non-gated gelu MLP (starcoder2_15b)
DENSE = ["llama3_1b", "llama3_8b", "qwen2p5_3b", "qwen2p5_32b",
         "nemotron_4_15b", "starcoder2_15b"]
PAIRS = [pytest.param(("llama3_1b", "float32"), id="float32"),
         pytest.param(("llama3_1b", "bfloat16"), id="bfloat16")] + [
    pytest.param((arch, dtype), id=f"{arch}-{dtype}")
    for arch in DENSE[1:] for dtype in ("float32", "bfloat16")]


@pytest.fixture(scope="module", params=PAIRS)
def pair(request):
    arch, dtype = request.param
    jm = jget(arch, smoke=True, dtype=dtype)
    jp = jm.init(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in flatten_paths(jp).items()}
    tm = tget(arch, smoke=True, dtype=dtype)
    return dtype, jm, jp, tm, params_from_flat(flat, tm.cfg, "cpu"), flat


def _ctx(mp, torch_side: bool):
    cls = TCtx if torch_side else JCtx
    return cls(mode="mp", mp=mp, act_scale_token=True) if mp else cls()


def _close(got, want, tol, scaled=True):
    """``scaled``: atol at ``tol`` of the logits' scale (module docstring)."""
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=atol)


def test_bridge_round_trips_every_path(pair):
    dtype, jm, jp, tm, tp, flat = pair
    back = {k: v.float().numpy() for k, v in tflatten(tp).items()}
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
    with pytest.raises(KeyError, match="missing"):
        params_from_flat({k: v for k, v in flat.items() if k != "embed/w"},
                         tm.cfg, "cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_flat(dict(flat, **{"layers/9/attn/q_proj/w": flat[
            "layers/0/attn/q_proj/w"]}), tm.cfg, "cpu")
    bad = dict(flat)
    bad["final_norm/scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_flat(bad, tm.cfg, "cpu")


@pytest.mark.parametrize("arch_cfg", [
    pytest.param(("llama3_1b", "config"), id="config"),
    pytest.param(("llama3_1b", "bench_config"), id="bench_config"),
    pytest.param(("llama3_1b", "smoke_config"), id="smoke_config")] + [
    pytest.param((arch, cfg), id=f"{arch}-{cfg}")
    for arch in DENSE[1:] for cfg in ("config", "smoke_config")])
def test_param_specs_match_reference(arch_cfg):
    """Same paths and shapes as the reference for every config of the
    dense models, the full 1.2B- to 32.8B-parameter ones included (specs
    only, nothing allocated), and the same config fields."""
    import dataclasses
    import importlib
    from repro.models.lm import LM as JLM
    from repro_torch.models.lm import LM as TLM
    arch, cfg = arch_cfg
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), cfg)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   cfg)()
    js, ts = JLM(jcfg).param_specs(), TLM(tcfg).param_specs()
    assert {k: v.shape for k, v in js.items()} == {
        k: v.shape for k, v in ts.items()}
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert {k: jf[k] for k in tf} == tf


@pytest.mark.parametrize("mp", [None, MP], ids=["plain", "mp"])
def test_apply_and_loss_match_reference(pair, mp):
    dtype, jm, jp, tm, tp, _ = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    tol = TOL["mp" if mp else dtype]
    want = jm.apply(jp, jnp.asarray(toks), _ctx(mp, False))
    got = tm.apply(tp, torch.from_numpy(toks), _ctx(mp, True))
    assert got.dtype == tm.dtype and got.shape == (2, 12, tm.cfg.vocab_size)
    _close(got.float(), want, tol)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}
    _close(tm.loss(tp, batch_t, _ctx(mp, True)).item(),
           float(jm.loss(jp, batch_j, _ctx(mp, False))), 1e-3, scaled=False)


@pytest.mark.parametrize("mp", [None, MP], ids=["plain", "mp"])
def test_prefill_and_decode_logits_match_reference(pair, mp):
    """Reference dense prefill + decode_step against the port's dense path
    and its paged path (bucketed paged prefill, then paged decode through
    both the fused kernel entry and the gather path)."""
    dtype, jm, jp, tm, tp, _ = pair
    rng = np.random.default_rng(2)
    B, T, steps, bs = 2, 11, 3, 4
    toks = rng.integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    nxt = rng.integers(0, tm.cfg.vocab_size, (steps, B, 1)).astype(np.int32)
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
    # dense: one-shot prefill, scalar-position decode
    tc = tm.init_cache(B, max_len, "cpu")
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc, tctx)
    got = [tl]
    for i in range(steps):
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt[i]), T + i, tc, tctx)
        got.append(tl)
    for g, w in zip(got, want):
        _close(g.float(), w, tol)
    # paged: bucketed prefill into blocks, per-row positions, both read paths
    for paged_attn in ("fused", "gather"):
        n_pages = -(-max_len // bs)
        pc = tm.init_paged_cache(B, 1 + B * n_pages, bs, "cpu")
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
            _close(g.float(), w, tol)


def test_unported_features_raise():
    from repro_torch.configs import llama3_1b as tc
    from repro_torch.models.lm import LM, MoEConfig
    # scan_layers is ported (ROADMAP A9c): its params are stacked by segment
    scan = LM(tc.smoke_config(scan_layers=True))
    assert "segments/0/attn/q_proj/w" in scan.param_specs()
    # prefix embeddings and the encoder-decoder are ported (ROADMAP A8)
    assert LM(tc.smoke_config(prefix_embed=True)).cfg.prefix_embed
    LM(tget("llava_next_34b").cfg)
    assert type(tget("whisper_base")).__name__ == "EncDec"
    # mamba and hybrid blocks are ported (ROADMAP A8's SSM half)
    LM(tget("mamba2_370m").cfg)
    LM(tget("hymba_1p5b").cfg)
    with pytest.raises(ValueError, match="unknown block types"):
        LM(tc.smoke_config(block_types=("conv", "attn")))
    # MoE layers and multi-token prediction are ported (ROADMAP A6)
    moe = MoEConfig(n_experts=4, top_k=2, d_expert_ff=32)
    m = LM(tc.smoke_config(moe_layers=(1,), moe=moe, mtp_depth=1))
    assert "layers/1/moe/experts/up_proj/w" in m.param_specs()
    assert "mtp/block/moe/router/w" in m.param_specs()
    LM(tget("moonshot_v1_16b_a3b").cfg)
    # MLA blocks and prompts at or beyond flash_min_seq are ported
    LM(tc.smoke_config(block_types=("mla", "attn")))
    m = LM(tc.smoke_config(flash_min_seq=8))
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    assert m.apply(p, torch.zeros((1, 8), dtype=torch.int32),
                   TCtx()).shape == (1, 8, m.cfg.vocab_size)
    with pytest.raises(KeyError, match="llama3_1b"):
        tget("whisper_large")
    assert ARCH_IDS == ["llama3_1b", "llama3_8b", "deepseek_v3_671b",
                        "qwen2p5_3b", "qwen2p5_32b", "nemotron_4_15b",
                        "starcoder2_15b", "moonshot_v1_16b_a3b",
                        "mamba2_370m", "hymba_1p5b", "whisper_base",
                        "llava_next_34b"]
    from repro.models.registry import ARCH_IDS as JARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)


def _jax_greedy(jm, jp, batch, n: int, jit: bool):
    """The reference ``ServeEngine``'s greedy loop (bucketed prefill, then
    scalar-position decode) over the reference model's steps, compiled
    (``jit``, as the engine runs them) or op by op. Returns the tokens and
    each step's top-two logit gap, (B, n) each."""
    from repro.serve import prefill_bucket as jbucket
    B, T0 = batch.shape
    ctx = JCtx()

    def prefill(p, c, t, s, v):
        return jm.prefill_chunk(p, t, c, ctx, start_pos=s, valid_len=v)

    def decode(p, c, t, pos):
        return jm.decode_step(p, t, pos, c, ctx)

    if jit:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    tok = np.zeros((B, jbucket(T0)), np.int32)
    tok[:, :T0] = batch
    logits, caches = prefill(jp, jm.init_cache(B, T0 + n), jnp.asarray(tok),
                             jnp.zeros((B,), jnp.int32),
                             jnp.full((B,), T0, jnp.int32))
    toks, gaps = [], []
    for i in range(n):
        last = np.asarray(logits[:, -1], np.float32)
        top = np.sort(last, axis=-1)
        toks.append(last.argmax(-1).astype(np.int32))
        gaps.append(top[:, -1] - top[:, -2])
        if i + 1 < n:
            logits, caches = decode(jp, caches, jnp.asarray(toks[-1][:, None]),
                                    jnp.asarray(T0 + i, jnp.int32))
    return np.stack(toks, 1), np.stack(gaps, 1)


def _reference_ties_where_port_differs(jm, jp, batch, got, want):
    """The port's greedy tokens may part from the reference engine's only
    where the engine's compiled steps tie exactly (argmax then takes the
    lower index) while the reference model's steps run op by op do not —
    XLA's fusions round some bf16 intermediates otherwise than the ops
    alone — and then the port's tokens are the op-by-op reference's."""
    n = want.shape[1]
    compiled, gaps = _jax_greedy(jm, jp, batch, n, jit=True)
    np.testing.assert_array_equal(compiled, want)
    eager, _ = _jax_greedy(jm, jp, batch, n, jit=False)
    np.testing.assert_array_equal(got, eager)
    for row in range(len(batch)):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            assert gaps[row, diff[0]] == 0.0, (row, diff[0], gaps[row])


def test_serving_op_names_match_a_registry_trace():
    """The op names the launcher checks plans against are exactly the ones
    a dense forward registers."""
    m = tget("llama3_1b", smoke=True)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    reg: list = []
    m.apply(p, torch.zeros((1, 4), dtype=torch.int32), TCtx(registry=reg))
    assert {op.name for op in reg} == m.serving_op_names()


def test_cuda_entry_points_refuse_without_a_card():
    """Entry points default to the card and never fall back to the host."""
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA"):
        tget("llama3_1b", smoke=True).init_cache(1, 4)
