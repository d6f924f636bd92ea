"""The port's quantization (``repro_torch.quant``) against the reference.

Inputs are drawn with numpy from a seed and handed to both packages. On the
CPU both compute the amax, the scale and the scaled cast in float32 with
round-to-nearest-even, so fp8 results are compared bitwise; the emulated fp4
grid goes through log2/exp2, compared bitwise as well (powers of two are
exact in both)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.nn import layers as JL  # noqa: E402
from repro.quant import formats as jformats  # noqa: E402
from repro.quant import qops as jqops  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.quant import formats as tformats  # noqa: E402
from repro_torch.quant import qops as tqops  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def test_format_registry_matches_reference():
    assert set(tformats.FORMATS) == set(jformats.FORMATS)
    for name, tf in tformats.FORMATS.items():
        jf = jformats.FORMATS[name]
        assert (tf.mantissa_bits, tf.exponent_bits, tf.bytes, tf.max_value,
                tf.is_quantized) == (jf.mantissa_bits, jf.exponent_bits,
                                     jf.bytes, jf.max_value, jf.is_quantized)
        assert tf.alpha == jf.alpha == tformats.alpha(name)
        assert (tf.dtype is None) == (jf.dtype is None)
    with pytest.raises(KeyError, match="unknown format"):
        tformats.get_format("fp6")


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1", "bf16"])
@pytest.mark.parametrize("axis", [None, (2,), (1, 2), ()],
                         ids=["per_tensor", "per_token", "per_row", "per_elem"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_and_quantize_match_reference(fmt, axis, dtype):
    rng = np.random.default_rng(hash((fmt, str(axis), dtype)) % 2**32)
    a = (rng.normal(size=(3, 5, 16)) * rng.choice([0.01, 1.0, 300.0],
                                                    size=(3, 5, 1)))
    a = a.astype(np.float32)
    a[0, 0, :4] = 0.0                       # exact zeros stay zeros
    xj, xt = _pair(a, dtype)
    np.testing.assert_array_equal(_np(tqt.fake_quant(xt, fmt, axis=axis)),
                                  _np(jqt.fake_quant(xj, fmt, axis=axis)))
    if fmt != "bf16":
        qt, qj = tqt.quantize(xt, fmt, axis=axis), jqt.quantize(xj, fmt,
                                                                axis=axis)
        np.testing.assert_array_equal(_np(qt.data), _np(qj.data))
        np.testing.assert_array_equal(_np(qt.scale_inv), _np(qj.scale_inv))


def test_fp8_cast_hazard_supplied_scale_gives_reference_nan():
    """A supplied scale that pushes values past e4m3's range: the reference
    stores NaN beyond the 464 rounding midpoint, where a bare PyTorch cast
    saturates to 448. The port's quantize follows the reference."""
    a = np.array([1.0, 100.0, 115.9, 116.0, 116.1, 200.0, -300.0, np.inf,
                  -np.inf, np.nan], np.float32)
    scale = np.float32(4.0)                 # 116 * 4 == 464
    qt = tqt.quantize(torch.from_numpy(a), "fp8_e4m3",
                      scale=torch.tensor(scale))
    qj = jqt.quantize(jnp.asarray(a), "fp8_e4m3", scale=jnp.asarray(scale))
    got, want = _np(qt.data), _np(qj.data)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[4:9]).all() and got[3] == 448.0
    # the hazard itself: PyTorch's own cast would have saturated
    bare = torch.tensor([500.0]).to(torch.float8_e4m3fn).float().item()
    assert bare == 448.0
    # e5m2 overflows to inf in both frameworks: plain cast, no special case
    q5t = tqt.quantize(torch.from_numpy(a), "fp8_e5m2",
                       scale=torch.tensor(np.float32(1e3)))
    q5j = jqt.quantize(jnp.asarray(a), "fp8_e5m2",
                       scale=jnp.asarray(np.float32(1e3)))
    np.testing.assert_array_equal(_np(q5t.data), _np(q5j.data))


def test_kv_write_saturates_identically():
    """The paged KV write clamps fp8 stores to the finite max in both
    packages (nn/layers.py paged_update_attend), so an overflow stores
    +-448, never NaN, and the two caches stay bitwise equal."""
    rng = np.random.default_rng(3)
    k = (rng.normal(size=(2, 1, 2, 8)) * 400).astype(np.float32)
    v = (rng.normal(size=(2, 1, 2, 8)) * 10).astype(np.float32)
    bt = np.array([[1, -1], [2, 3]], np.int32)
    pos = np.array([0, 5], np.int32)
    jc = {n: jnp.zeros((4, 4, 2, 8), jnp.float8_e4m3fn) for n in ("k", "v")}
    tc = {n: torch.zeros((4, 4, 2, 8), dtype=torch.float8_e4m3fn)
          for n in ("k", "v")}
    jnew, _, _ = JL.paged_update_attend(
        jc, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(bt),
        None, jnp.asarray(pos), None, jnp.bfloat16, fused=True)
    tnew, _, _ = TL.paged_update_attend(
        tc, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
        torch.from_numpy(bt), None, torch.from_numpy(pos), None,
        torch.bfloat16, fused=True)
    for n in ("k", "v"):
        got, want = _np(tnew[n]), _np(jnew[n])
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got).all()
    assert np.abs(_np(tnew["k"])).max() == 448.0


@pytest.mark.parametrize("kind,spec,shapes", [
    ("linear", "BSC,KC->BSK", ((2, 3, 16), (8, 16))),
    ("bgemm", "BTKGD,BSKD->BKGTS", ((2, 3, 2, 2, 8), (2, 5, 2, 8))),
    ("bgemm", "BKGTS,BSKD->BTKGD", ((2, 2, 2, 3, 5), (2, 5, 2, 8))),
])
@pytest.mark.parametrize("token", [False, True])
def test_qeinsum_mp_matches_reference(kind, spec, shapes, token):
    """MP execution of one op, per-tensor or per-token scales: operands are
    fake-quantized identically (bitwise, see module docstring); the product
    is an f32 sum in another order, then one rounding to bf16, so the
    outputs agree to one bf16 ulp."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=shapes[0]).astype(np.float32)
    b = rng.normal(size=shapes[1]).astype(np.float32)
    mp = {"op": "fp8_e4m3"}
    jctx = jqops.QuantContext(mode="mp", mp=mp, act_scale_token=token)
    tctx = tqops.QuantContext(mode="mp", mp=mp, act_scale_token=token)
    aj, at = _pair(a, "bfloat16")
    bj, bt = _pair(b, "bfloat16")
    got = _np(tqops.qeinsum(tctx, "op", spec, at, bt, kind=kind))
    want = _np(jqops.qeinsum(jctx, "op", spec, aj, bj, kind=kind))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)


def test_qops_registry_and_refusals():
    reg: list = []
    ctx = tqops.QuantContext(registry=reg)
    x = torch.ones((2, 3, 4))
    w = torch.ones((5, 4))
    y = tqops.linear(ctx, "lin", x, w, torch.zeros(5))
    assert y.shape == (2, 3, 5)
    assert reg[0].name == "lin" and reg[0].macs == 2 * 3 * 4 * 5
    assert reg[0].weight_elems == 20
    # probe mode: zero probes leave the output unchanged, the unperturbed
    # operands are captured by reference, and the probes receive dg/dz
    probes = {"lin": (torch.zeros((2, 3, 4), requires_grad=True),
                      torch.zeros((5, 4), requires_grad=True))}
    ctx = tqops.QuantContext(mode="probe", probes=probes, captures={})
    yp = tqops.linear(ctx, "lin", x, w)
    assert torch.equal(yp.detach(), y)
    assert ctx.captures["lin"][0] is x and ctx.captures["lin"][1] is w
    g_x, g_w = torch.autograd.grad(yp.sum(), probes["lin"])
    assert torch.equal(g_x, torch.full((2, 3, 4), 5.0))
    assert torch.equal(g_w, torch.full((5, 4), 6.0))
    # the reference's impl="pallas" is the port's impl="kernel"
    with pytest.raises(ValueError, match="'kernel'"):
        tqops.linear(tqops.QuantContext(mode="mp", mp={"lin": "fp8_e4m3"},
                                        impl="pallas"), "lin", x, w)
