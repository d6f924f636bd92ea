"""Flash attention in the port against the reference: kernel 4
(``mp_flash_attention``) and its ``flash_attention_mp`` entry point against
the interpret-mode Pallas kernel, the blocked attention of ``nn/flash.py``
against the reference's, and a long prompt through the whole model.

On the CPU the kernel's wrapper runs its plain version, which walks the keys
in the kernel's blocks with the same online softmax; the CUDA kernel is held
against that plain version on the card (``test_torch_kernels_cuda.py``).

Tolerances. Both sides sum in f32 in different orders and round once to
bf16, so an output may differ by one bf16 rounding: rtol 2^-7 with atol
1e-5. The fp8 cases take the same quantization points on both sides (the
reference's bytes from the amax/scale_cast pair); a probability that lands
on the other side of an e4m3 rounding boundary would move an output by up
to 1/16 of its weight, which these small cases never meet, so they share
the bf16 tolerance. The blocked attention in f32 differs from the reference
by f32 summation order (1e-5); in bf16 by one rounding of an output, and
under fp8 fake-quant by one e4m3 step of an operand (2^-4). Model logits:
as ``test_torch_model.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mp_attention import mp_flash_attention as jmpfa  # noqa: E402
from repro.kernels.quant_cast import quantize_fp8 as jquant  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.flash import flash_attention as jflash  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.kernels import mp_attention as tmpa  # noqa: E402
from repro_torch.kernels.fp8_matmul import pad_last as tpad  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_cast as tqc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn.flash import flash_attention as tflash  # noqa: E402
from repro_torch.quant.qops import QuantContext as TCtx  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

KTOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# kernel 4: mp_flash_attention
# ---------------------------------------------------------------------------


# the reference suite's cases (tests/test_kernels.py), then T != S, a Dv
# other than D, and blocks that do not divide the keys of the last block
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S,D,Dv,bq,bk", [
    (128, 128, 64, 64, 64, 64), (256, 256, 32, 32, 128, 64),
    (64, 192, 32, 32, 64, 64), (128, 64, 16, 24, 64, 32)])
def test_mp_flash_attention_matches_reference_kernel(causal, T, S, D, Dv, bq,
                                                     bk):
    q, k, v = _normal(T + S, (2, 3, T, D), (2, 3, S, D), (2, 3, S, Dv))
    want = jmpfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = tmpa.mp_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, T, Dv)
    np.testing.assert_allclose(_np(got), _np(want), **KTOL)
    if T == S:
        # the materialized oracle agrees where its mask does (T == S)
        oracle = tref.mp_flash_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal)
        np.testing.assert_allclose(_np(got), _np(oracle), rtol=5e-2,
                                   atol=5e-3)


@pytest.mark.parametrize("bk", [32, 64])
def test_mp_flash_attention_fp8_matches_reference_kernel(bk):
    """FP8 q/k/v quantized by the reference's kernels and probabilities
    rounded to e4m3 in the kernel: the port walks the same key blocks, so it
    matches the reference kernel at each block size."""
    B, H, T, D = 1, 2, 128, 64
    q, k, v = _normal(7, (B, H, T, D), (B, H, T, D), (B, H, T, D))
    jq = [jquant(jnp.asarray(x).reshape(-1, D), 448.0, jnp.float8_e4m3fn,
                 interpret=True) for x in (q, k, v)]
    want = jmpfa(*(a.reshape(B, H, T, D) for a, _ in jq),
                 *(s for _, s in jq), causal=True, block_q=64, block_k=bk,
                 quant_probs=True, interpret=True)
    tq = [tqc.quantize_fp8(torch.from_numpy(x).reshape(-1, D))
          for x in (q, k, v)]
    for (a, sa), (b, sb) in zip(tq, jq):
        assert float(sa) == float(sb)
        np.testing.assert_array_equal(_np(a), _np(b))
    got = tmpa.mp_flash_attention(*(a.reshape(B, H, T, D) for a, _ in tq),
                                  *(s for _, s in tq), causal=True,
                                  block_k=bk, quant_probs=True)
    np.testing.assert_allclose(_np(got), _np(want), **KTOL)


def test_quantized_probabilities_depend_on_the_key_block():
    """Rounded against the running max, the probabilities (and so the
    output) change with the key block; without quant_probs they do not
    beyond f32 summation order."""
    q, k, v = _normal(3, (1, 2, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, out_dtype=torch.float32)
    a = tmpa.mp_flash_attention(qt, kt, vt, block_k=32, quant_probs=True,
                                **kw)
    b = tmpa.mp_flash_attention(qt, kt, vt, block_k=128, quant_probs=True,
                                **kw)
    assert (a - b).abs().max() > 1e-3
    c = tmpa.mp_flash_attention(qt, kt, vt, block_k=32, **kw)
    d = tmpa.mp_flash_attention(qt, kt, vt, block_k=128, **kw)
    np.testing.assert_allclose(c.numpy(), d.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", [None, "fp8_e4m3"])
def test_flash_attention_mp_matches_reference(fmt):
    """The ops entry point: bf16 straight through, or q/k/v quantized per
    tensor over reshape(-1, D) (amax and scale_cast) with e4m3
    probabilities by default."""
    q, k, v = _normal(11, (1, 2, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64))
    want = jops.flash_attention_mp(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), fmt_name=fmt,
        block=64, interpret=True)
    got = tops.flash_attention_mp(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        fmt_name=fmt, block=64)
    np.testing.assert_allclose(_np(got), _np(want), **KTOL)


# zero columns add exact zeros to every score and context sum, so only the
# f32 summation order of the padded matmuls may move an output: 1e-6
# relative and absolute on f32 outputs of magnitude <= 4
PAD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant_probs,bk", [(False, 256), (True, 96)])
@pytest.mark.parametrize("D,Dv", [(40, 24), (8, 100)])
def test_head_dim_padding_leaves_the_plain_version_unchanged(D, Dv,
                                                             quant_probs, bk):
    """The kernel's wrapper zero-pads D and Dv to multiples of 16 for TMA and
    passes the unpadded D's scale: the plain version on the padded operands
    with that scale, its padded output columns sliced off, is the plain
    version on the unpadded ones (the padded columns are exact zeros)."""
    q, k, v = (torch.from_numpy(x) for x in _normal(
        13, (1, 2, 70, D), (1, 2, 150, D), (1, 2, 150, Dv)))
    kw = dict(causal=True, block_k=bk, quant_probs=quant_probs,
              out_dtype=torch.float32)
    want = tref.mp_flash_attention_plain(q, k, v, **kw)
    qp, kp, vp = (tpad(x, 16) for x in (q, k, v))
    assert qp.shape[-1] % 16 == 0 and vp.shape[-1] % 16 == 0
    got = tref.mp_flash_attention_plain(qp, kp, vp, scale=1.0 / np.sqrt(D),
                                        **kw)
    assert torch.equal(got[..., Dv:], torch.zeros_like(got[..., Dv:]))
    np.testing.assert_allclose(got[..., :Dv].numpy(), want.numpy(),
                               **PAD_TOL)


@pytest.mark.parametrize("dtype,kind,entry", [
    (torch.float32, "f32_cuda_cores", "mp_flash_attention_f32_launch"),
    (torch.bfloat16, "tensor_cores", "mp_flash_attention_launch"),
    (torch.float8_e4m3fn, "tensor_cores", "mp_flash_attention_launch"),
    (torch.float8_e5m2, "tensor_cores", "mp_flash_attention_launch")])
def test_operand_dtype_chooses_the_kernel(dtype, kind, entry):
    """f32 operands have no exact tensor-core route and go to the CUDA-core
    kernel's entry; bf16 and fp8 (widened to bf16 in shared memory) to the
    wgmma kernel's. Other dtypes are refused by name."""
    assert tmpa.route(dtype) == kind
    assert tmpa._ENTRY[tmpa.route(dtype)] == entry
    with pytest.raises(TypeError, match="float16"):
        tmpa.route(torch.float16)


def test_oracle_matches_reference_oracle():
    q, k, v = _normal(5, (1, 2, 64, 32), (1, 2, 96, 32), (1, 2, 96, 16))
    for causal in (True, False):
        want = jref.mp_flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = tref.mp_flash_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), **KTOL)


# ---------------------------------------------------------------------------
# nn/flash.py: the blocked attention of long prompts
# ---------------------------------------------------------------------------

FLASH_MP = {"x/qk_matmul": "fp8_e4m3", "x/av_matmul": "fp8_e4m3"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "window", "mp_token", "mp_seq"])
def test_blocked_attention_matches_reference(dtype, case):
    """GQA (4 query heads on 2 KV heads), causal or sliding-window masks from
    positions, and MP fake-quant with per-token or per-sequence scales, at a
    length that is a multiple of the block."""
    B, T, H, Hkv, D, block = 2, 64, 4, 2, 16, 16
    q, k, v = _normal(21, (B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    window = 24 if case == "window" else None
    mp = FLASH_MP if case.startswith("mp") else None
    extra = ({"act_scale_token": True} if case == "mp_token" else
             {"act_scale_axis": 0} if case == "mp_seq" else {})
    jctx = JCtx(mode="mp", mp=mp, **extra) if mp else JCtx()
    tctx = TCtx(mode="mp", mp=mp, **extra) if mp else TCtx()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jflash(jctx, "x", *(jnp.asarray(a, jdt) for a in (q, k, v)),
                  jnp.asarray(pos), causal=True, window=window, block=block)
    got = tflash(tctx, "x", *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                 torch.from_numpy(np.ascontiguousarray(pos)), causal=True,
                 window=window, block=block)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    tol = (2.0 ** -4 if mp else 2.0 ** -7) if dtype == "bfloat16" else 1e-5
    if mp and dtype == "float32":
        tol = 2.0 ** -4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_blocked_attention_registers_the_bgemms():
    reg_j, reg_t = [], []
    q, k, v = _normal(2, (1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8))
    pos = np.arange(32, dtype=np.int32)[None]
    jflash(JCtx(registry=reg_j), "x", *(jnp.asarray(a) for a in (q, k, v)),
           jnp.asarray(pos), causal=True, window=None, block=16)
    tflash(TCtx(registry=reg_t), "x", *(torch.from_numpy(a) for a in
                                        (q, k, v)),
           torch.from_numpy(pos), causal=True, window=None, block=16)
    assert [tuple(vars(o).values()) for o in reg_t] == [
        tuple(vars(o).values()) for o in reg_j]


@pytest.mark.parametrize("T", [40, 57])
def test_blocked_attention_at_lengths_off_the_block(T):
    """At a length that is not a multiple of the block the port agrees with
    the materialized reference attention. (The reference's blocked attention
    does not there: its padded keys carry position int32 min, which its
    causal test lets into every row's denominator — ROADMAP C.)"""
    B, H, D = 1, 2, 8
    q, k, v = (torch.from_numpy(a) for a in _normal(
        T, (B, T, H, D), (B, T, H, D), (B, T, H, D)))
    pos = torch.arange(T, dtype=torch.int32)[None]
    got = tflash(TCtx(), "x", q, k, v, pos, causal=True, window=None,
                 block=16)
    mask = TL._mask_from_pos(pos, pos, True, None, None)
    want = TL._reference_attention(TCtx(), "x", q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# a long prompt through the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_long():
    """The bf16 smoke llama with flash_min_seq 16 and blocks of 8, both
    packages, the same weights."""
    ov = dict(flash_min_seq=16, flash_block=8)
    jm = jget("llama3_1b", smoke=True, **ov)
    jp = jm.init(jax.random.key(0))
    tm = tget("llama3_1b", smoke=True, **ov)
    tp = params_from_flat({k: np.asarray(a) for k, a in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    return jm, jp, tm, tp


def test_long_prompt_logits_match_reference(llama_long):
    jm, jp, tm, tp = llama_long
    toks = np.random.default_rng(4).integers(0, 512, (2, 32)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(toks), JCtx())
    got = tm.apply(tp, torch.from_numpy(toks), TCtx())
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -6,
                               atol=2.0 ** -6)
    # the same prompt below the threshold takes the reference attention;
    # the two paths agree within the same tolerance
    tm_ref = tget("llama3_1b", smoke=True, flash_min_seq=1 << 30)
    ref = tm_ref.apply(tp, torch.from_numpy(toks), TCtx())
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2.0 ** -6,
                               atol=2.0 ** -6)


def test_long_prompt_through_the_oneshot_engine(llama_long):
    """A prompt whose bucket reaches flash_min_seq prefills at its own
    length through the blocked attention: first tokens as the reference's
    engine gives them."""
    jm, jp, tm, tp = llama_long
    toks = np.random.default_rng(6).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(JServeEngine(jm, donate=False).generate(
        jp, {"tokens": jnp.asarray(toks)}, max_new_tokens=1).tokens)
    got = ServeEngine(tm, device="cpu").generate(tp, {"tokens": toks},
                                                 max_new_tokens=1)
    np.testing.assert_array_equal(got.tokens, want)


def test_probe_mode_keeps_the_reference_path(llama_long, monkeypatch):
    """A probe-mode forward of a long sequence never reaches the blocked
    attention: calibration probes the reference path's BGEMMs."""
    _, _, tm, tp = llama_long
    import repro_torch.nn.flash as tflash_mod

    def refuse(*a, **kw):
        raise AssertionError("probe mode reached flash attention")

    monkeypatch.setattr(tflash_mod, "flash_attention", refuse)
    toks = torch.zeros((1, 32), dtype=torch.int32)
    reg: list = []
    tm.apply(tp, toks, TCtx(mode="probe", probes={}, captures={}))
    with pytest.raises(AssertionError, match="flash"):
        tm.apply(tp, toks, TCtx(registry=reg))
