"""The port's fp8 kernels' plain versions and wrappers against the reference
Pallas kernels (interpret mode on the CPU), and the ``impl="kernel"`` route
of ``qeinsum``.

Tolerances:

* ``amax``, ``scale_cast`` and ``quantize_fp8``: bitwise. A max does not
  depend on summation order; the cast is one f32 multiply and one
  round-to-nearest-even, and special values (NaN, overflow) follow the
  reference's bytes (``repro_torch.kernels.ref``). Bytes are compared as
  uint8, so NaN signs and payloads count.
* ``fp8_matmul`` / ``fp8_linear``: products of two fp8 values are exact in
  f32, so the two sides differ only by f32 summation order and by the
  scales' application (one multiply by ``sx*sw`` in the reference kernel,
  two in the plain version): |diff| <= 2^-6 * max|Y| (two bf16 ulps at the
  largest output).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.fp8_matmul  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_cast as jqc  # noqa: E402
from repro.quant import qops as jqops  # noqa: E402
from repro_torch.kernels import fp8_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_cast as tqc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.quant import qops as tqops  # noqa: E402

FP8 = {"fp8_e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
       "fp8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
MM_TOL = 2.0 ** -6
# the reference package re-exports the function under the module's name
jmm = sys.modules["repro.kernels.fp8_matmul"]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _bits(x) -> np.ndarray:
    """f32 scalars/arrays as their int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.int32)
    return np.asarray(x, np.float32).view(np.int32)


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks, bit for bit: bf16 inputs are
    rounded once (by the reference) and handed over as bits, since the two
    frameworks' f32 -> bf16 casts give NaN different signs."""
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a.copy())
    j = jnp.asarray(a).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.int16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _hazard_rows(n_cols: int) -> np.ndarray:
    """Values straddling e4m3's 448/464/480 and e5m2's 57344/61440, with
    +-inf, +-NaN, +-0 and subnormal magnitudes, tiled to ``n_cols``."""
    special = np.array([0.0, -0.0, 1e-9, -3e-6, 447.9, 448.0, 455.0, 463.9,
                        464.0, 464.1, 479.9, 480.0, -470.0, 57000.0, 61439.0,
                        61440.0, -61440.0, 70000.0, np.inf, -np.inf, np.nan,
                        -np.nan, 3.4e38, -1.0], np.float32)
    return np.resize(special, (8, n_cols)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "hazards", "nan", "zeros"])
def test_amax_plain_matches_reference_kernel(dtype, case):
    rng = np.random.default_rng(11)
    a = (rng.normal(size=(256, 128)) * 30).astype(np.float32)
    if case == "hazards":
        a[:8] = _hazard_rows(128)
        a[:8][np.isnan(a[:8])] = 5.0          # NaN has its own case
    elif case == "nan":
        a[17, 3] = np.nan
    elif case == "zeros":
        a[:] = 0.0
    xj, xt = _pair(a, dtype)
    want = jqc.amax(xj, interpret=True)
    for got in (tref.amax_ref(xt), tqc.amax(xt)):
        assert got.dtype == torch.float32 and got.shape == ()
        if case == "nan":
            assert np.isnan(float(got)) and np.isnan(float(want))
            assert _bits(got) == 0x7FC00000        # canonical quiet NaN
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", sorted(FP8))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 4.0])
def test_scale_cast_plain_matches_reference_kernel(fmt, dtype, scale):
    """Bitwise, as bytes: overflow to NaN (e4m3fn, with the sign) or inf
    (e5m2), NaN inputs, signed zeros, subnormals, round-to-nearest-even at
    the rounding midpoints."""
    td, jd = FP8[fmt]
    rng = np.random.default_rng(12)
    a = (rng.normal(size=(256, 128)) * 50).astype(np.float32)
    a[:8] = _hazard_rows(128)
    xj, xt = _pair(a, dtype)
    s = np.float32(scale)
    want = jqc.scale_cast(xj, jnp.asarray(s), dtype=jd, interpret=True)
    for got in (tref.scale_cast_ref(xt, torch.tensor(s), td),
                tqc.scale_cast(xt, torch.tensor(s), dtype=td),
                tqc.scale_cast(xt, float(s), dtype=td)):
        assert got.dtype == td and got.shape == xt.shape
        np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("fmt", sorted(FP8))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_fp8_matches_reference(fmt, dtype):
    rng = np.random.default_rng(13)
    a = (rng.normal(size=(256, 256)) * rng.choice([1e-3, 1.0, 900.0],
                                                   size=(256, 1)))
    xj, xt = _pair(a.astype(np.float32), dtype)
    jq, js = jops.quantize_fp8(xj, fmt, interpret=True)
    tq, ts = tops.quantize_fp8(xt, fmt)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert ts.shape == () and tq.dtype == FP8[fmt][0]


def _mm_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = MM_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("fx,fw", [("fp8_e4m3", "fp8_e4m3"),
                                   ("fp8_e5m2", "fp8_e5m2"),
                                   ("fp8_e4m3", "fp8_e5m2")])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_fp8_matmul_plain_matches_reference_kernel(fx, fw, out):
    rng = np.random.default_rng(14)
    M, N, K = 256, 128, 384
    x = (rng.normal(size=(M, K)) * 40).astype(np.float32)
    w = (rng.normal(size=(N, K)) * 40).astype(np.float32)
    xq_t = torch.from_numpy(x).to(FP8[fx][0])
    wq_t = torch.from_numpy(w).to(FP8[fw][0])
    xq_j = jnp.asarray(xq_t.float().numpy()).astype(FP8[fx][1])
    wq_j = jnp.asarray(wq_t.float().numpy()).astype(FP8[fw][1])
    sx, sw = np.float32(0.013), np.float32(0.21)
    od = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}[out]
    want = jmm.fp8_matmul(xq_j, wq_j, jnp.asarray(sx), jnp.asarray(sw),
                          block_m=128, block_n=128, block_k=128,
                          out_dtype=od[1], interpret=True)
    for got in (tmm.fp8_matmul(xq_t, wq_t, torch.tensor(sx), torch.tensor(sw),
                               out_dtype=od[0]),
                tref.fp8_matmul_ref(xq_t, wq_t, torch.tensor(sx),
                                    torch.tensor(sw), od[0])):
        assert got.dtype == od[0]
        _mm_close(got, want)


@pytest.mark.parametrize("shape", [(128, 256, 128), (256, 128, 256),
                                   (200, 200, 130)],
                         ids=["square", "wide", "padded"])
@pytest.mark.parametrize("fmt", sorted(FP8))
def test_fp8_linear_matches_reference(shape, fmt):
    """Shapes the reference accepts; the padded one pads to (256, 256, 256)
    in both packages before quantizing."""
    M, K, C = shape
    rng = np.random.default_rng(15)
    x = rng.normal(size=(M, C)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.05).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    want = jops.fp8_linear(xj, wj, fmt_name=fmt, interpret=True)
    got = tops.fp8_linear(xt, wt, fmt_name=fmt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    _mm_close(got, want)


def test_fp8_linear_takes_shapes_the_reference_refuses():
    """The reference pads M=300 to 384 and then its amax asserts
    ``M % min(256, M) == 0``; the port pads the same way and computes. Its
    result equals the plain pipeline on the unpadded operands: zero padding
    changes neither amax nor any product."""
    rng = np.random.default_rng(16)
    x = rng.normal(size=(300, 96)).astype(np.float32)
    w = (rng.normal(size=(70, 96)) * 0.1).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    with pytest.raises(AssertionError):
        jops.fp8_linear(xj, wj, interpret=True)
    got = tops.fp8_linear(xt, wt)
    xq, sx = tqc.quantize_fp8(xt)
    wq, sw = tqc.quantize_fp8(wt)
    want = tref.fp8_matmul_ref(xq, wq, sx, sw)
    assert got.shape == (300, 70)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    """A CPU tensor runs the plain version; no kernel launch is counted."""
    n0 = dict(tqc.launches), tmm.launches
    x = torch.randn(64, 32, dtype=torch.bfloat16)
    tops.fp8_linear(x, torch.randn(16, 32, dtype=torch.bfloat16))
    assert (dict(tqc.launches), tmm.launches) == n0
    with pytest.raises(ValueError, match=r"\(M, K\) x \(N, K\)"):
        tmm.fp8_matmul(torch.zeros(2, 3, dtype=torch.float8_e4m3fn),
                       torch.zeros(2, 4, dtype=torch.float8_e4m3fn), 1.0, 1.0)
    with pytest.raises(TypeError, match="fp8"):
        tref.scale_cast_ref(x, 1.0, torch.bfloat16)


@pytest.mark.parametrize("fx,fw", [("fp8_e4m3", "fp8_e4m3"),
                                   ("fp8_e5m2", "fp8_e5m2")])
@pytest.mark.parametrize("K", [1, 100, 130])
def test_k_padding_leaves_the_plain_version_bitwise_unchanged(fx, fw, K):
    """The GEMM wrapper zero-pads K to a multiple of 16 for TMA: zero bytes
    are +0.0 in both formats and their products add exact zeros, so the
    plain version on the padded operands is bitwise the unpadded one (and
    matches the reference kernel on the unpadded ones)."""
    rng = np.random.default_rng(17)
    xq = torch.from_numpy((rng.normal(size=(96, K)) * 40).astype(
        np.float32)).to(FP8[fx][0])
    wq = torch.from_numpy((rng.normal(size=(72, K)) * 40).astype(
        np.float32)).to(FP8[fw][0])
    xp, wp = tmm.pad_last(xq, 16), tmm.pad_last(wq, 16)
    assert xp.shape == (96, -(-K // 16) * 16) and xp.dtype == xq.dtype
    assert not _bytes(xp)[:, K:].any() and not _bytes(wp)[:, K:].any()
    assert np.array_equal(_bytes(xp)[:, :K], _bytes(xq))
    for out in (torch.bfloat16, torch.float32):
        want = tref.fp8_matmul_ref(xq, wq, 0.013, 0.21, out)
        got = tref.fp8_matmul_ref(xp, wp, 0.013, 0.21, out)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_pad_last_keeps_aligned_rows_and_realigns_others():
    """No copy when the rows are already a multiple of 16 bytes and the
    base is 16-byte aligned; a view starting mid-buffer is copied to an
    aligned one with the same values."""
    x = torch.zeros(8, 32, dtype=torch.float8_e4m3fn)
    assert tmm.pad_last(x, 16) is x
    buf = torch.arange(8 * 33, dtype=torch.float32).to(torch.float8_e4m3fn)
    v = buf[1:1 + 8 * 32].view(8, 32)
    got = tmm.pad_last(v, 16)
    assert got.data_ptr() % 16 == 0
    assert np.array_equal(_bytes(got), _bytes(v.contiguous()))


# ---------------------------------------------------------------------------
# qeinsum impl="kernel"
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_qeinsum_kernel_2d_matches_reference_pallas():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(128, 256)).astype(np.float32)
    w = (rng.normal(size=(128, 256)) * 0.05).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    mp = {"lin": "fp8_e4m3"}
    reg: list = []
    want = jqops.linear(jqops.QuantContext(mode="mp", mp=mp, impl="pallas"),
                        "lin", xj, wj)
    got = tqops.linear(tqops.QuantContext(mode="mp", mp=mp, impl="kernel",
                                          registry=reg), "lin", xt, wt)
    _mm_close(got, want)
    assert reg == []            # returns before the registry, as the reference


@pytest.mark.parametrize("fmt", sorted(FP8))
def test_qeinsum_kernel_3d_matches_reference_per_tensor_fake_quant(fmt):
    """The port's one routing departure: a (B, S, C) operand under
    per-tensor activation scales goes through the fp8 kernels. Same grid as
    the reference's per-tensor fake-quant of the same tensor; the products
    differ by the bf16 rounding of the dequantized operands, so the outputs
    agree to a few bf16 ulps of the largest output (2^-6 * max|Y|)."""
    rng = np.random.default_rng(18)
    x = rng.normal(size=(2, 48, 64)).astype(np.float32)
    w = (rng.normal(size=(40, 64)) * 0.1).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    mp = {"lin": fmt}
    want = jqops.linear(jqops.QuantContext(mode="mp", mp=mp), "lin", xj, wj)
    got = tqops.linear(tqops.QuantContext(mode="mp", mp=mp, impl="kernel"),
                       "lin", xt, wt)
    assert got.shape == (2, 48, 40) and got.dtype == torch.bfloat16
    _mm_close(got, want)
    # the grid is the reference's: operands quantize to the same bytes
    from repro.quant import qtensor as jqt
    jx = jqt.quantize(jnp.asarray(x).astype(jnp.bfloat16), fmt)
    tx, _ = tops.quantize_fp8(xt.reshape(-1, 64), fmt)
    np.testing.assert_array_equal(_bytes(tx).reshape(2, 48, 64),
                                  _bytes(jx.data))


@pytest.mark.parametrize("token,axis", [(True, None), (False, 0)],
                         ids=["per_token", "per_sequence"])
def test_qeinsum_kernel_serving_contexts_keep_fake_quant(token, axis):
    """Per-token and per-sequence contexts keep the reference's fake-quant
    branch under impl='kernel' (the reference's impl='pallas' does the same
    for a 3-D operand): the outputs equal the reference's to one bf16 ulp,
    as the plain MP comparison in test_torch_quant.py holds them."""
    rng = np.random.default_rng(19)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    mp = {"lin": "fp8_e4m3"}
    kw = dict(mode="mp", mp=mp, act_scale_token=token, act_scale_axis=axis)
    want = jqops.linear(jqops.QuantContext(impl="pallas", **kw), "lin", xj,
                        wj)
    n0 = dict(tqc.launches)
    got = tqops.linear(tqops.QuantContext(impl="kernel", **kw), "lin", xt, wt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -8, atol=1e-6)
    simulate = tqops.linear(tqops.QuantContext(impl="simulate", **kw), "lin",
                            xt, wt)
    torch.testing.assert_close(got, simulate, rtol=0, atol=0)
    assert dict(tqc.launches) == n0


def test_qeinsum_refuses_pallas_by_name():
    x, w = torch.ones((2, 3, 4)), torch.ones((5, 4))
    with pytest.raises(ValueError, match="'kernel'"):
        tqops.linear(tqops.QuantContext(mode="mp", mp={"lin": "fp8_e4m3"},
                                        impl="pallas"), "lin", x, w)
    with pytest.raises(ValueError, match="impl"):
        tqops.linear(tqops.QuantContext(mode="mp", mp={"lin": "fp8_e4m3"},
                                        impl="triton"), "lin", x, w)
