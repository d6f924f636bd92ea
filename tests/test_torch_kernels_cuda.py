"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device — a CUDA kernel has no CPU mode — and skip
without one. They import neither ``jax`` nor ``repro``, so they run on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX.)

Tolerance for bf16 outputs: two bf16 ulps at |o| ~ 1 (2^-6), absolute and
relative — the kernel and the plain version sum in f32 in different orders,
which can flip the bf16 rounding of a score or a probability."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.quant.formats import cast_to  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(kv_dtype, poison_value, *, B=4, Hkv=8, G=4, D=64, bs=16,
          n_pages=10, seed=0):
    """The serving shape: rows at a page boundary, mid-page, one page and a
    vacant row (all -1, length 0); dead table entries point at poisoned
    blocks that no live page references."""
    rng = np.random.default_rng(seed)
    lengths = np.array([n_pages * bs, 100, bs, 0][:B], np.int32)
    n_live = B * n_pages
    poison = np.arange(1 + n_live, n_live + 5)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    bt = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        bt[b, :used] = perm[c:c + used]
        c += used
        if lengths[b]:
            bt[b, used:] = rng.choice(poison, size=n_pages - used)

    def fill():
        x = rng.normal(size=(n_live + 5, bs, Hkv, D)).astype(np.float32)
        x[poison] = poison_value
        return cast_to(torch.from_numpy(x).cuda(), kv_dtype)

    k, v = fill(), fill()
    q = torch.from_numpy(rng.normal(size=(B, Hkv, G, D)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    return q, k, v, torch.from_numpy(bt).cuda(), torch.from_numpy(
        lengths).cuda()


KW = dict(scale=8.0, score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16)


@pytest.mark.parametrize("kv", ["bf16", "fp8_e4m3"])
@pytest.mark.parametrize("window", [None, 7])
def test_kernel_matches_plain_version(cuda, kv, window):
    kv_dtype = {"bf16": torch.bfloat16, "fp8_e4m3": torch.float8_e4m3fn}[kv]
    scales = dict(k_scale=0.5, v_scale=2.0) if kv != "bf16" else {}
    args = _case(kv_dtype, 224.0)
    n0 = tpa.launches
    got = tpa.paged_decode_attention(*args, window=window, **KW, **scales)
    want = tref.paged_decode_attention_ref(*args, window=window, **KW,
                                           **scales)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)
    assert (got[3] == 0).all(), "a length-0 row must give zeros"
    # NaN in blocks only dead entries reference is never read
    nan_out = tpa.paged_decode_attention(*_case(kv_dtype, float("nan")),
                                         window=window, **KW, **scales)
    torch.cuda.synchronize()
    assert torch.equal(nan_out, got)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v, bt, ln = _case(torch.bfloat16, 0.0)
    with pytest.raises(NotImplementedError, match="MLA"):
        tpa.paged_decode_attention(q, k, None, bt, ln, scale=8.0)
    with pytest.raises(NotImplementedError, match="MLA"):
        tpa.paged_decode_attention(q, k, v, bt, ln, scale=0.125,
                                   scale_mode="mul")
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode_attention(q, k, v, bt.long(), ln, scale=8.0)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode_attention(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, v, bt, ln, scale=8.0)
    with pytest.raises(TypeError, match="query dtype"):
        tpa.paged_decode_attention(q, k, v, bt, ln, scale=8.0,
                                   out_dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.full((4, 4000), -1, dtype=torch.int32, device="cuda")
        tpa.paged_decode_attention(q, k, v, big, ln, scale=8.0)


def test_float32_query_and_window_edge(cuda):
    """An f32 query (no bf16 rounding anywhere) and a window of one key."""
    q, k, v, bt, ln = _case(torch.float32, 0.0)
    q = q.float()
    kw = dict(scale=math.sqrt(64), window=1)
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **kw)
    want = tref.paged_decode_attention_ref(q, k, v, bt, ln, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# fp8 quantization and GEMM kernels (csrc/quant_cast.cu, csrc/fp8_matmul.cu)
# ---------------------------------------------------------------------------

from repro_torch.kernels import fp8_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_cast as tqc  # noqa: E402

FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# fp8 GEMM vs its plain version: exact products, f32 sums in other orders,
# one rounding to bf16: two bf16 ulps of the largest output
MM_TOL = 2.0 ** -6


def _hazards(n: int) -> torch.Tensor:
    special = torch.tensor([0.0, -0.0, 1e-9, -3e-6, 447.9, 448.0, 455.0,
                            463.9, 464.0, 464.1, 479.9, 480.0, -470.0,
                            57000.0, 61439.0, 61440.0, -61440.0, 70000.0,
                            float("inf"), -float("inf"), float("nan"),
                            -float("nan"), 3.4e38, -1.0])
    return special.repeat(-(-n // special.numel()))[:n]


def _input(shape, dtype, seed, *, hazards=False, offset=0):
    """A contiguous CUDA tensor; ``offset`` > 0 starts it that many elements
    into a larger buffer, so its address is not 16-byte aligned."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=g) * 40
    if hazards:
        x[offset:offset + 512] = _hazards(512)
    x = x.to(dtype)
    if dtype == torch.bfloat16:   # canonical NaN bits on both devices
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.cuda()[offset:].view(shape)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    view = torch.int32 if got.element_size() == 4 else torch.uint8
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["normal", "hazards", "nan", "unaligned"])
def test_amax_kernel_bitwise(cuda, dtype, case):
    x = _input((2048, 2048), dtype, 1, hazards=case == "hazards",
               offset=3 if case == "unaligned" else 0)
    if case == "hazards":
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    if case == "nan":
        x[1000, 7] = float("nan")
    n0 = tqc.launches["amax"]
    got = tqc.amax(x)
    want = tref.amax_ref(x)
    torch.cuda.synchronize()
    assert tqc.launches["amax"] == n0 + 1
    _same_bits(got, want)
    if case == "hazards":
        assert float(got) == float("inf")


@pytest.mark.parametrize("fmt", sorted(FP8))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,offset", [((2048, 2048), 0), ((300, 77), 5)],
                         ids=["model", "ragged_unaligned"])
def test_scale_cast_kernel_bitwise(cuda, fmt, dtype, shape, offset):
    """Every byte, NaN and overflow included, at scales that push values
    across 448/464/480 (e4m3fn) and 57344/61440 (e5m2)."""
    x = _input(shape, dtype, 2, hazards=True, offset=offset)
    for scale in (1.0, 0.37, 4.0):
        s = torch.tensor(scale, device="cuda")
        n0 = tqc.launches["scale_cast"]
        got = tqc.scale_cast(x, s, dtype=FP8[fmt])
        want = tref.scale_cast_ref(x, s, FP8[fmt])
        torch.cuda.synchronize()
        assert tqc.launches["scale_cast"] == n0 + 1
        _same_bits(got, want)


@pytest.mark.parametrize("M,N,K", [(2048, 8192, 2048), (300, 2048, 2048),
                                   (77, 130, 100), (1, 1, 1)],
                         ids=["gate_proj", "m300", "ragged", "one"])
@pytest.mark.parametrize("fx,fw,out", [("e4m3", "e4m3", torch.bfloat16),
                                       ("e5m2", "e4m3", torch.float32)])
def test_fp8_matmul_kernel_matches_plain(cuda, M, N, K, fx, fw, out):
    xq = (_input((M, K), torch.float32, 3) / 8).to(FP8[fx])
    wq = (_input((N, K), torch.float32, 4) / 8).to(FP8[fw])
    sx = torch.tensor(0.02, device="cuda")
    sw = torch.tensor(0.003, device="cuda")
    n0 = tmm.launches
    got = tmm.fp8_matmul(xq, wq, sx, sw, out_dtype=out)
    want = tref.fp8_matmul_ref(xq, wq, sx, sw, out)
    torch.cuda.synchronize()
    assert tmm.launches == n0 + 1 and got.dtype == out
    tol = MM_TOL * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_fp8_linear_on_card_counts_and_matches_plain(cuda):
    """2 amax + 2 scale_cast + 1 GEMM launches per call; the result equals
    the plain pipeline within the GEMM tolerance, M=300 included."""
    x = _input((300, 2048), torch.bfloat16, 5) / 40
    w = _input((2048, 2048), torch.bfloat16, 6) / 1600
    n0 = dict(tqc.launches), tmm.launches
    got = tops.fp8_linear(x, w)
    torch.cuda.synchronize()
    assert tqc.launches == {"amax": n0[0]["amax"] + 2,
                            "scale_cast": n0[0]["scale_cast"] + 2}
    assert tmm.launches == n0[1] + 1
    xq, sx = tqc.quantize_fp8(x)
    wq, sw = tqc.quantize_fp8(w)
    want = tref.fp8_matmul_ref(xq, wq, sx, sw)
    tol = MM_TOL * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    with pytest.raises(ValueError, match="contiguous"):
        tqc.amax(x.t())
    with pytest.raises(TypeError, match="fp8"):
        tmm.fp8_matmul(x, w, sx, sw)
