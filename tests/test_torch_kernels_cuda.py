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
