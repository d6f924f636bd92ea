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
    with pytest.raises(ValueError, match="q2 and k2"):
        tpa.paged_decode_attention(q, k, v, bt, ln, scale=8.0, q2=q)
    with pytest.raises(ValueError, match="scale_mode"):
        tpa.paged_decode_attention(q, k, v, bt, ln, scale=0.125,
                                   scale_mode="pow")
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
# the GQA form's tensor-core kernel (csrc/paged_decode_gqa.cu)
# ---------------------------------------------------------------------------

KV_DTYPES = {"bf16": torch.bfloat16, "fp8_e4m3": torch.float8_e4m3fn}


def _poison_stale(k, v, bt, lengths, bs, window=None):
    """NaN (byte 0xFF, NaN in bf16 and in e4m3fn) in every slot of a live
    page that holds no live key: past the row's length and below its
    window. In place."""
    blocks, offs = [], []
    for b, L in enumerate(lengths.tolist()):
        lo = 0 if window is None else max(0, L - window)
        for pos in range(-(-L // bs) * bs):
            if pos >= L or pos < lo:
                blocks.append(int(bt[b, pos // bs]))
                offs.append(pos % bs)
    if blocks:
        for t in (k, v):
            t.view(torch.uint8)[blocks, offs] = 0xFF


@pytest.mark.parametrize("kv", sorted(KV_DTYPES))
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("window", [None, 7])
def test_gqa_kernel_matches_plain_version(cuda, kv, G, D, window):
    """Every head dim the route takes, single heads, the serving group and
    a group that does not split evenly (G 7), with and without a window."""
    scales = dict(k_scale=0.5, v_scale=2.0) if kv != "bf16" else {}
    args = _case(KV_DTYPES[kv], 224.0, G=G, D=D)
    assert tpa.route(args[0].dtype, args[1].dtype, True, 0, D, D) == \
        "gqa_mma"
    n0 = dict(tpa.launches_by_route)
    kw = dict(KW, scale=math.sqrt(D), window=window, **scales)
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, gqa_mma=n0["gqa_mma"] + 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)
    assert (got[3] == 0).all(), "a length-0 row must give zeros"
    again = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, got), "two calls must give equal bits"


@pytest.mark.parametrize("hg", [1, 3, 4, 7, 8])
@pytest.mark.parametrize("scale,mode", [(8.0, "div"), (0.125, "mul"),
                                        (-8.0, "div")])
def test_gqa_kernel_at_every_head_group(cuda, monkeypatch, hg, scale, mode):
    """Forced head groups, including ones that leave a last group short,
    under both scale modes and a negative scale (the row max is then taken
    from the smallest sum)."""
    args = _case(torch.bfloat16, 224.0, G=8)
    kw = dict(KW, scale=scale, scale_mode=mode)
    want = tref.paged_decode_attention_ref(*args, **kw)
    monkeypatch.setattr(tpa, "head_group", lambda *a, **k: hg)
    got = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv", sorted(KV_DTYPES))
@pytest.mark.parametrize("window", [None, 7])
def test_gqa_kernel_never_reads_stale_live_slots(cuda, kv, window):
    """NaN in the slots of live pages past a row's length and below its
    window leaves the output finite and bit-identical."""
    scales = dict(k_scale=0.5, v_scale=2.0) if kv != "bf16" else {}
    kw = dict(KW, window=window, **scales)
    args = _case(KV_DTYPES[kv], float("nan"))
    clean = tpa.paged_decode_attention(*args, **kw)
    q, k, v, bt, ln = args
    _poison_stale(k, v, bt.cpu(), ln.cpu(), 16, window)
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, clean)


def test_gqa_kernel_at_its_context_limit(cuda):
    """At the largest table width the GQA kernel holds (one head a block)
    it runs and agrees; one page more raises."""
    bs, Hkv, G, D = 16, 2, 4, 64
    n_pages = tpa.max_context(D, 0, bs, route="gqa_mma") // bs
    g = torch.Generator(device="cuda").manual_seed(0)
    n_blocks = 2 * n_pages + 1
    k, v = (torch.randn(n_blocks, bs, Hkv, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(2, Hkv, G, D, generator=g, device="cuda").to(
        torch.bfloat16)
    bt = torch.randperm(n_blocks - 1, generator=g, device="cuda")[
        :2 * n_pages].view(2, n_pages).to(torch.int32) + 1
    ln = torch.tensor([n_pages * bs, 3001], dtype=torch.int32, device="cuda")
    assert tpa.head_group(G, D, 0, n_pages, bs, route="gqa_mma") == 1
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **KW)
    want = tref.paged_decode_attention_ref(q, k, v, bt, ln, **KW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)
    wide = torch.cat([bt, bt[:, :1]], 1)
    with pytest.raises(ValueError, match="shared memory"):
        tpa.paged_decode_attention(q, k, v, wide, ln, **KW)


@pytest.mark.parametrize("case", ["unrounded", "D72", "v_from_k"])
def test_cuda_core_kernel_with_bf16_queries(cuda, case):
    """The GQA shapes outside the tensor-core kernel's rule stay on the
    CUDA-core kernel: scores not rounded to bf16, a head dim that is not a
    multiple of 16, and values read from the keys."""
    D = 72 if case == "D72" else 64
    q, k, v, bt, ln = _case(torch.bfloat16, 224.0, D=D)
    kw = dict(KW, scale=math.sqrt(D))
    if case == "unrounded":
        kw.update(score_dtype=None, probs_dtype=None)
    if case == "v_from_k":
        v = None
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **kw)
    want = tref.paged_decode_attention_ref(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, cuda_core=n0["cuda_core"] + 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)
    assert (got[3] == 0).all(), "a length-0 row must give zeros"


def test_wide_d256_table_takes_the_cuda_core_kernel(cuda):
    """At D 256 a table one page wider than the GQA kernel holds still fits
    the CUDA-core kernel's shared memory: the route sends it there, and it
    agrees with the plain version."""
    bs, Hkv, G, D = 16, 1, 2, 256
    n_pages = tpa.max_context(D, 0, bs, route="gqa_mma") // bs + 1
    assert n_pages * bs <= tpa.max_context(D, 0, bs)
    g = torch.Generator(device="cuda").manual_seed(0)
    k, v = (torch.randn(n_pages + 1, bs, Hkv, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(1, Hkv, G, D, generator=g, device="cuda").to(
        torch.bfloat16)
    bt = (torch.randperm(n_pages, generator=g, device="cuda") + 1).view(
        1, n_pages).to(torch.int32)
    ln = torch.tensor([n_pages * bs - 5], dtype=torch.int32, device="cuda")
    kw = dict(KW, scale=16.0)
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **kw)
    want = tref.paged_decode_attention_ref(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, cuda_core=n0["cuda_core"] + 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


def test_route_sends_each_form_to_its_kernel(cuda):
    """The serving GQA call counts under gqa_mma, the MLA serving form
    under mla_mma, an f32 query over GQA K/V under cuda_core."""
    args = _case(torch.bfloat16, 0.0)
    n0 = dict(tpa.launches_by_route)
    tpa.paged_decode_attention(*args, **KW)
    q, *rest = args
    tpa.paged_decode_attention(q.float(), *rest, scale=8.0)
    mla_args, mla_kw = _mla_case(10, [160, 152, 144, 136])
    tpa.paged_decode_attention(*mla_args, **mla_kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == {"gqa_mma": n0["gqa_mma"] + 1,
                                     "mla_mma": n0["mla_mma"] + 1,
                                     "cuda_core": n0["cuda_core"] + 1}


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


@pytest.mark.parametrize("M,N,K", [(2048, 2048, 8192), (2048, 128256, 2048)],
                         ids=["down_proj", "lm_head"])
def test_fp8_matmul_kernel_e5m2_at_the_widest_shapes(cuda, M, N, K):
    """e5m2 x e5m2 at the longest K (8192: 64 promotions of 128 products)
    and the widest N (1002 column tiles)."""
    xq = (_input((M, K), torch.float32, 7) / 8).to(FP8["e5m2"])
    wq = (_input((N, K), torch.float32, 8) / 8).to(FP8["e5m2"])
    sx = torch.tensor(0.02, device="cuda")
    sw = torch.tensor(0.003, device="cuda")
    got = tmm.fp8_matmul(xq, wq, sx, sw)
    want = tref.fp8_matmul_ref(xq, wq, sx, sw)
    torch.cuda.synchronize()
    tol = MM_TOL * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_fp8_matmul_kernel_pads_k_and_realigns(cuda):
    """K = 100 (rows of 100 bytes: padded to 112 for TMA) and an operand
    starting 3 bytes into its buffer (copied to an aligned one)."""
    buf = (_input((77 * 100 + 3,), torch.float32, 9) / 8).to(FP8["e4m3"])
    xq = buf[3:].view(77, 100)
    wq = (_input((130, 100), torch.float32, 10) / 8).to(FP8["e4m3"])
    got = tmm.fp8_matmul(xq, wq, 0.5, 0.25)
    want = tref.fp8_matmul_ref(xq, wq, 0.5, 0.25)
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------------------
# the MLA form of the paged kernel (route mla_mma, and cuda_core beyond it)
# ---------------------------------------------------------------------------


def _mla_case(n_pages, lengths, *, B=4, H=128, r=512, dr=64, bs=16, seed=0):
    """DeepSeek-V3's absorbed decode shapes: one latent KV head, H query
    heads, ckv (r) and kr (dr) pages in bf16, f32 queries."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * n_pages
    bt = np.full((B, n_pages), -1, np.int32)
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        bt[b, :used] = 1 + b * n_pages + np.arange(used)
    ckv = torch.from_numpy(rng.normal(size=(n_blocks, bs, 1, r)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    kr = torch.from_numpy(rng.normal(size=(n_blocks, bs, 1, dr)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    q1 = torch.from_numpy(rng.normal(size=(B, 1, H, r)).astype(
        np.float32)).cuda()
    q2 = torch.from_numpy(rng.normal(size=(B, 1, H, dr)).astype(
        np.float32)).cuda()
    args = (q1, ckv, None, torch.from_numpy(bt).cuda(),
            torch.from_numpy(np.asarray(lengths, np.int32)).cuda())
    kw = dict(q2=q2, k2=kr, scale=1.0 / math.sqrt(128 + dr),
              scale_mode="mul", out_dtype=torch.float32)
    return args, kw


# f32 scores, probabilities and output: summation order only
MLA_TOL = dict(rtol=1e-4, atol=1e-5)


def test_mla_form_matches_plain_version(cuda):
    """The serving cell's decode step: 4 rows of 160/152/144/136 keys
    (route mla_mma)."""
    args, kw = _mla_case(10, [160, 152, 144, 136])
    n0 = tpa.launches
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **MLA_TOL)


def test_mla_form_at_its_context_limit(cuda, monkeypatch):
    """At the largest table width one head's scores fit in the CUDA-core
    kernel (54,144 keys at block 16; route forced there) the kernel runs
    and agrees; one page more raises."""
    monkeypatch.setattr(tpa, "route", lambda *a, **k: "cuda_core")
    n_pages = tpa.max_context(512, 64, 16) // 16
    args, kw = _mla_case(n_pages, [40, 17, 1, 0], B=4)
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MLA_TOL)
    assert (got[3] == 0).all()
    args, kw = _mla_case(n_pages + 1, [40, 17, 1, 0], B=4)
    with pytest.raises(ValueError, match="shared memory"):
        tpa.paged_decode_attention(*args, **kw)


# ---------------------------------------------------------------------------
# the MLA form's tensor-core kernel (csrc/paged_decode_mla.cu)
# ---------------------------------------------------------------------------


def _mla_hazards(lengths, poison_value, *, window=None, n_pages=None, H=128,
                 r=512, dr=64, bs=16, seed=1):
    """As ``_mla_case``, with every hazard of the pool: permuted blocks,
    dead table entries on poisoned blocks that no live page references,
    and ``poison_value`` in every slot of a live page that holds no live
    key (past the row's length, below its window)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_pages = n_pages or -(-max(lengths) // bs)
    n_live = B * n_pages
    poison = np.arange(1 + n_live, n_live + 5)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    bt = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b, L in enumerate(lengths):
        used = -(-L // bs)
        bt[b, :used] = perm[c:c + used]
        c += used
        if L:
            bt[b, used:] = rng.choice(poison, size=n_pages - used)
    ckv = rng.normal(size=(n_live + 5, bs, 1, r)).astype(np.float32)
    kr = rng.normal(size=(n_live + 5, bs, 1, dr)).astype(np.float32)
    for x in (ckv, kr):
        x[poison] = poison_value
        for b, L in enumerate(lengths):
            lo = 0 if window is None else max(0, L - window)
            for pos in range(-(-L // bs) * bs):
                if pos >= L or pos < lo:
                    x[bt[b, pos // bs], pos % bs] = poison_value
    q1, q2 = (torch.from_numpy(rng.normal(size=(B, 1, H, d)).astype(
        np.float32)).cuda() for d in (r, dr))
    args = (q1, torch.from_numpy(ckv).cuda().to(torch.bfloat16), None,
            torch.from_numpy(bt).cuda(),
            torch.from_numpy(np.asarray(lengths, np.int32)).cuda())
    kw = dict(q2=q2, k2=torch.from_numpy(kr).cuda().to(torch.bfloat16),
              scale=1.0 / math.sqrt(128 + dr), scale_mode="mul",
              out_dtype=torch.float32, window=window)
    return args, kw


MLA_SHAPES = {
    "serving": dict(lengths=[160, 152, 144, 136]),
    "keys16": dict(lengths=[16, 16, 16, 16]),
    "boundaries": dict(lengths=[160, 100, 16, 0]),   # page ends, mid-page
    "window": dict(lengths=[160, 100, 16, 0], window=7),
    "window40": dict(lengths=[160, 152, 37, 5], window=40),
    "one_key": dict(lengths=[1, 2, 17, 0]),
}


@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_mla_kernel_matches_plain_version(cuda, shape):
    """The MLA serving form through mla_mma at the serving cell, 16 keys,
    page boundaries and mid-page rows, a vacant row and windows, with
    finite garbage in dead blocks and stale live slots; repeated calls
    give equal bits."""
    args, kw = _mla_hazards(poison_value=224.0, **MLA_SHAPES[shape])
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    again = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, mla_mma=n0["mla_mma"] + 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **MLA_TOL)
    assert torch.equal(again, got), "two calls must give equal bits"
    for b, L in enumerate(MLA_SHAPES[shape]["lengths"]):
        if L == 0:
            assert (got[b] == 0).all(), "a length-0 row must give zeros"


@pytest.mark.parametrize("shape", ["serving", "window", "one_key"])
def test_mla_kernel_never_reads_stale_or_dead_slots(cuda, shape):
    """NaN in blocks no live page references and in the stale slots of
    live pages leaves the output finite and bit-identical to the run with
    finite poison."""
    args, kw = _mla_hazards(poison_value=224.0, **MLA_SHAPES[shape])
    clean = tpa.paged_decode_attention(*args, **kw)
    args, kw = _mla_hazards(poison_value=float("nan"), **MLA_SHAPES[shape])
    got = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


@pytest.mark.parametrize("hg", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("scale,mode", [(1.0 / math.sqrt(192), "mul"),
                                        (math.sqrt(192), "div"),
                                        (-0.1, "mul")])
def test_mla_kernel_at_every_head_group(cuda, monkeypatch, hg, scale, mode):
    """Forced head groups (a short last group at 3), both scale modes and
    a negative scale."""
    args, kw = _mla_hazards([160, 100, 16, 0], 224.0, H=20)
    kw.update(scale=scale, scale_mode=mode)
    want = tref.paged_decode_attention_ref(*args, **kw)
    monkeypatch.setattr(tpa, "head_group", lambda *a, **k: hg)
    n0 = tpa.launches_by_route["mla_mma"]
    got = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route["mla_mma"] == n0 + 1
    torch.testing.assert_close(got, want, **MLA_TOL)


@pytest.mark.parametrize("r,dr", [(16, 0), (48, 16), (128, 128), (512, 0),
                                  (256, 64)])
def test_mla_kernel_at_other_latent_widths(cuda, r, dr):
    """Latent widths that leave a slab part-filled, no rope part, and the
    widest rope part."""
    args, kw = _mla_hazards([160, 100, 16, 0], 224.0, H=8, r=r, dr=dr)
    if dr == 0:
        kw.update(q2=None, k2=None)
    n0 = tpa.launches_by_route["mla_mma"]
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route["mla_mma"] == n0 + 1
    torch.testing.assert_close(got, want, **MLA_TOL)


def test_mla_kernel_at_its_widest_table(cuda):
    """At the widest table mla_mma holds (71,616 keys, wider than the
    CUDA-core kernel's 54,144) it runs and agrees; one page wider the route
    is cuda_core, which holds it no more than the parent did, so the call
    raises."""
    n_pages = tpa.max_context(512, 64, 16, route="mla_mma") // 16
    assert n_pages * 16 > tpa.max_context(512, 64, 16)
    args, kw = _mla_hazards([n_pages * 16 - 3, 17, 1, 0], 224.0,
                            n_pages=n_pages, H=8)
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, mla_mma=n0["mla_mma"] + 1)
    torch.testing.assert_close(got, want, **MLA_TOL)
    del args, kw, got, want
    args, kw = _mla_hazards([40, 17, 1, 0], 224.0, n_pages=n_pages + 1, H=8)
    form = (torch.float32, torch.bfloat16, False, 64, 512, 512, False)
    assert tpa.route(*form, n_pages=n_pages + 1, bs=16) == "cuda_core"
    with pytest.raises(ValueError, match="shared memory"):
        tpa.paged_decode_attention(*args, **kw)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("slots", [0, 2, 5])
def test_mla_kernel_staging_and_split(cuda, monkeypatch, split, slots):
    """Every way the kernel stages the latents (all resident, or rings of 2
    and 5 slabs a warp) with the key tiles in one block or split over a
    cluster of two: the same answer within tolerance."""
    args, kw = _mla_hazards([160, 100, 37, 0], 224.0, window=None)
    want = tref.paged_decode_attention_ref(*args, **kw)
    monkeypatch.setattr(tpa, "mla_split", lambda *a: split)
    monkeypatch.setattr(tpa, "mla_slots", lambda *a: slots)
    monkeypatch.setattr(tpa, "head_group", lambda *a, **k: 4)
    got = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MLA_TOL)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("case", ["f32", "fp8", "k_scale", "rounded"])
def test_mla_forms_outside_the_rule_take_cuda_core(cuda, case):
    """f32 or scaled-fp8 latents, a non-unit scale and rounded scores stay
    on the CUDA-core kernel, and agree with the plain version."""
    args, kw = _mla_hazards([160, 100, 16, 0], 224.0, H=8)
    q1, ckv, v, bt, ln = args
    if case == "f32":
        ckv, kw["k2"] = ckv.float(), kw["k2"].float()
    if case == "fp8":
        ckv = cast_to(ckv.float(), torch.float8_e4m3fn)
        kw["k2"] = cast_to(kw["k2"].float(), torch.float8_e4m3fn)
        kw.update(k_scale=0.5, v_scale=0.5)
    if case == "k_scale":
        kw.update(k_scale=0.5, v_scale=0.5)
    if case == "rounded":
        kw.update(score_dtype=torch.float32, probs_dtype=torch.float32)
    args = (q1, ckv, v, bt, ln)
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(*args, **kw)
    want = tref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches_by_route == dict(n0, cuda_core=n0["cuda_core"] + 1)
    torch.testing.assert_close(got, want, **MLA_TOL)


# ---------------------------------------------------------------------------
# kernel 4: mixed-precision flash attention (csrc/mp_attention.cu)
# ---------------------------------------------------------------------------

from repro_torch.kernels import mp_attention as tmpa  # noqa: E402


def _flash_agrees(got, want, quant_probs: bool) -> None:
    """Without quant_probs: two bf16 ulps (2^-6). With it, a probability the
    two sum orders put on either side of an e4m3 rounding boundary moves by
    one e4m3 step (at most p/8), so an output by at most max|v|/8 over a
    denominator of at least 1: max error 2^-3, and at most one output in
    1000 beyond 2^-6."""
    err = (got.float() - want.float()).abs()
    lim = TOL * (1 + want.float().abs())
    if not quant_probs:
        assert bool((err <= lim).all()), float(err.max())
        return
    assert float(err.max()) <= 0.125
    assert float((err > lim).float().mean()) <= 1e-3


def _qkv(B, H, T, S, D, Dv, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).cuda()
            for shape in ((B, H, T, D), (B, H, S, D), (B, H, S, Dv))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,T,S,D,Dv", [
    (1, 4, 512, 512, 64, 64), (1, 2, 512, 512, 192, 128),
    (2, 3, 200, 333, 64, 64), (1, 2, 333, 200, 32, 48)],
    ids=["llama", "deepseek", "t_lt_s", "t_gt_s"])
def test_mp_flash_kernel_matches_plain_version(cuda, causal, B, H, T, S, D,
                                               Dv):
    q, k, v = _qkv(B, H, T, S, D, Dv)
    n0 = tmpa.launches
    got = tmpa.mp_flash_attention(q, k, v, causal=causal)
    want = tref.mp_flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tmpa.launches == n0 + 1 and got.shape == (B, H, T, Dv)
    _flash_agrees(got, want, False)


@pytest.mark.parametrize("block", [64, 256])
def test_flash_attention_mp_fp8_on_card(cuda, block):
    """q/k/v through the amax and scale_cast kernels, e4m3 probabilities
    against the running max of each key block."""
    q, k, v = _qkv(1, 4, 512, 512, 64, 64, seed=1)
    n0 = tmpa.launches, dict(tqc.launches)
    got = tops.flash_attention_mp(q, k, v, fmt_name="fp8_e4m3", block=block)
    torch.cuda.synchronize()
    assert tmpa.launches == n0[0] + 1
    assert tqc.launches["amax"] == n0[1]["amax"] + 3
    qs = [tqc.quantize_fp8(x.reshape(-1, x.shape[-1])) for x in (q, k, v)]
    want = tref.mp_flash_attention_plain(
        *(a.reshape(x.shape) for (a, _), x in zip(qs, (q, k, v))),
        *(s for _, s in qs), block_k=block, quant_probs=True)
    _flash_agrees(got, want, True)


def test_mp_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(1, 2, 64, 64, 32, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tmpa.mp_flash_attention(q.transpose(2, 3).contiguous().transpose(
            2, 3), k, v)
    with pytest.raises(TypeError, match="dtypes"):
        tmpa.mp_flash_attention(q, k.float(), v)
    # the f32 kernel stages a key block's scores in shared memory; the
    # tensor-core kernel takes any block_k
    q, k, v = _qkv(1, 1, 1024, 1024, 32, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        tmpa.mp_flash_attention(q, k, v, block_k=1024)
    got = tmpa.mp_flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  block_k=1024)
    torch.cuda.synchronize()
    assert got.shape == (1, 1, 1024, 32)


def _fp8_qkv(B, H, T, S, D, Dv, seed):
    """q/k/v quantized per tensor by the amax and scale_cast kernels, and
    their dequant scales."""
    qs = [tqc.quantize_fp8(x.reshape(-1, x.shape[-1]))
          for x in _qkv(B, H, T, S, D, Dv, seed=seed)]
    shapes = ((B, H, T, D), (B, H, S, D), (B, H, S, Dv))
    return ([a.reshape(s) for (a, _), s in zip(qs, shapes)],
            [sc for _, sc in qs])


@pytest.mark.parametrize("block", [256, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_mp_flash_kernel_quant_probs_at_a_ragged_last_block(cuda, block,
                                                            causal):
    """T 300, S 700: key blocks of 256, 256, 188 (or 96 x 7 + 28), each
    walked twice (max, then probabilities) by the tensor-core kernel; keys
    past a block's end are absent from it."""
    (q, k, v), sc = _fp8_qkv(2, 4, 300, 700, 64, 64, seed=2)
    got = tmpa.mp_flash_attention(q, k, v, *sc, causal=causal,
                                  block_k=block, quant_probs=True)
    want = tref.mp_flash_attention_plain(q, k, v, *sc, causal=causal,
                                         block_k=block, quant_probs=True)
    torch.cuda.synchronize()
    _flash_agrees(got, want, True)


def test_mp_flash_kernel_deepseek_width_quant_probs(cuda):
    """D 192 (three 64-column slabs of Q and K), Dv 128, fp8 operands with
    e4m3 probabilities."""
    (q, k, v), sc = _fp8_qkv(1, 2, 512, 512, 192, 128, seed=3)
    got = tmpa.mp_flash_attention(q, k, v, *sc, quant_probs=True)
    want = tref.mp_flash_attention_plain(q, k, v, *sc, quant_probs=True)
    torch.cuda.synchronize()
    _flash_agrees(got, want, True)


@pytest.mark.parametrize("causal", [True, False])
def test_mp_flash_kernel_f32_operands(cuda, causal):
    """f32 operands take the CUDA-core kernel (no exact tensor-core route),
    f32 output: f32 summation order only."""
    q, k, v = _qkv(2, 3, 200, 333, 64, 48, seed=4, dtype=torch.float32)
    n0 = tmpa.launches
    got = tmpa.mp_flash_attention(q, k, v, causal=causal,
                                  out_dtype=torch.float32)
    want = tref.mp_flash_attention_plain(q, k, v, causal=causal,
                                         out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tmpa.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_mp_flash_kernel_pads_head_dims(cuda, fmt):
    """D 40 and Dv 24 (not multiples of 16 bytes in fp8): the wrapper pads
    both and keeps the scale of D 40."""
    q, k, v = _qkv(1, 2, 130, 150, 40, 24, seed=5)
    q, k, v = (x.to(FP8[fmt]) for x in (q, k, v))
    got = tmpa.mp_flash_attention(q, k, v, 0.5, 0.5, 2.0)
    want = tref.mp_flash_attention_plain(q, k, v, 0.5, 0.5, 2.0)
    torch.cuda.synchronize()
    assert got.shape == (1, 2, 130, 24)
    _flash_agrees(got, want, False)


@pytest.mark.parametrize("rows", [1, 4, 8, 512])
def test_norm_of_a_row_does_not_depend_on_its_batch_on_the_card(cuda, rows):
    """The serving engines batch 4 (continuous) or 8 (one-shot) decode rows;
    a token's norm must not depend on which (``Tensor.mean`` on the card
    sums 4 or 8 rows of 2048 in another order than 1024 rows)."""
    from repro_torch.nn.layers import apply_norm
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(1024, 2048, device=cuda, generator=g).bfloat16()
    p = {"scale": torch.rand(2048, device=cuda, generator=g) + 0.5}
    full = apply_norm(p, x)
    assert torch.equal(apply_norm(p, x[:rows]), full[:rows])
    assert torch.equal(apply_norm(p, x[:rows, None]), full[:rows, None])
