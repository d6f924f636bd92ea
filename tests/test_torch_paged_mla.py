"""The MLA form of paged decode in the port: the route that sends its
serving form to the tensor-core kernel (``csrc/paged_decode_mla.cu``,
``"mla_mma"``), that kernel's shared-memory sizing, the premise its exact
products rest on (an f32 value is the sum of three bf16 planes, and each
plane's product with a bf16 latent is exact in f32), and the port's plain
version against the JAX package's Pallas kernel (interpret mode on the CPU)
at DeepSeek-V3's latent widths.

The kernel itself runs only on a card: ``test_torch_kernels_cuda.py`` holds
it against the plain version there. Here the CPU tensors take the plain
version, as the wrapper does for any CPU tensor.

Tolerance against the Pallas kernel: rtol 1e-4, atol 1e-6 — f32 scores,
probabilities and output summed in other orders, as in ``test_torch_mla.py``.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

BF16, F32, FP8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
CSRC = Path(tpa.__file__).parent / "csrc"
BF16_MAX = float(torch.finfo(BF16).max)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

ROUTE_TABLE = [
    # (q dtype, kv dtype, v given, D2, Dk, Dv, rounded), scales -> route
    ((F32, BF16, False, 64, 512, 512, False), {}, "mla_mma"),  # DeepSeek
    ((F32, BF16, False, 0, 512, 512, False), {}, "mla_mma"),   # no rope
    ((F32, BF16, False, 128, 512, 512, False), {}, "mla_mma"),
    ((F32, BF16, False, 16, 16, 16, False), {}, "mla_mma"),
    ((F32, BF16, False, 64, 48, 48, False), {}, "mla_mma"),
    ((F32, F32, False, 64, 512, 512, False), {}, "cuda_core"),  # f32 latents
    ((F32, FP8, False, 64, 512, 512, False), {}, "cuda_core"),  # fp8 latents
    ((F32, BF16, False, 64, 512, 512, False), {"k_scale": 0.5}, "cuda_core"),
    ((F32, BF16, False, 64, 512, 512, False), {"v_scale": 2.0}, "cuda_core"),
    ((F32, BF16, False, 64, 512, 512, True), {}, "cuda_core"),  # rounded
    ((F32, BF16, False, 64, 512, 512, None), {}, "cuda_core"),  # scores only
    ((F32, BF16, False, 64, 520, 520, False), {}, "cuda_core"),  # Dk % 16
    ((F32, BF16, False, 72, 512, 512, False), {}, "cuda_core"),  # D2 % 16
    ((F32, BF16, False, 64, 8, 8, False), {}, "cuda_core"),      # Dk < 16
    ((F32, BF16, False, 64, 528, 528, False), {}, "cuda_core"),  # Dk > 512
    ((F32, BF16, False, 144, 512, 512, False), {}, "cuda_core"),  # D2 > 128
    ((F32, BF16, True, 64, 512, 512, False), {}, "cuda_core"),   # own v
    ((BF16, BF16, False, 64, 512, 512, False), {}, "cuda_core"),  # bf16 q
]


@pytest.mark.parametrize("args,scales,want", ROUTE_TABLE,
                         ids=[f"{i}-{w}" for i, (_, _, w) in
                              enumerate(ROUTE_TABLE)])
def test_mla_route_table(args, scales, want):
    assert tpa.route(*args, **scales) == want


def test_widest_mla_table_and_one_page_more():
    """The widest table mla_mma holds (one head a block, its key tiles
    split over a cluster of two, a ring of 2) goes to it; one page more
    goes to cuda_core — which holds no more than 54,144 keys, so such a
    call raises, as it did before the MLA kernel."""
    n = tpa.max_context(512, 64, 16, route="mla_mma") // 16
    assert n * 16 == 71616
    form = (F32, BF16, False, 64, 512, 512, False)
    assert tpa.route(*form, n_pages=n, bs=16) == "mla_mma"
    assert tpa.route(*form, n_pages=n + 1, bs=16) == "cuda_core"
    assert tpa._mla_smem(1, 512, 64, n, 16, 2) <= 227 * 1024
    assert tpa._mla_smem(1, 512, 64, n + 1, 16, 2) > 227 * 1024
    assert tpa.mla_slots(1, 512, 64, n, 16) >= 2
    assert tpa.mla_slots(1, 512, 64, n + 1, 16) == -1
    assert tpa.head_group(128, 512, 64, n + 1, 16) == 0
    assert tpa.max_context(512, 64, 16) == 54144 < n * 16


@pytest.mark.parametrize("n_pages", [1, 10, 16, 17, 128, 1000, 3384, 4476])
def test_every_width_the_parent_ran_still_has_a_route(n_pages):
    """Every table width the CUDA-core kernel held (up to 54,144 keys) now
    takes mla_mma, whose head group fits: no table the parent served is
    refused, and the MLA kernel holds wider ones too."""
    form = (F32, BF16, False, 64, 512, 512, False)
    rt = tpa.route(*form, n_pages=n_pages, bs=16)
    assert rt == "mla_mma"
    hg = tpa.head_group(128, 512, 64, n_pages, 16, rows=4, sms=132, route=rt)
    assert 1 <= hg <= 8
    assert tpa.smem_bytes(hg, 512, 64, n_pages, 16, rt) <= 227 * 1024


@pytest.mark.parametrize("hg", [1, 2, 4, 8])
@pytest.mark.parametrize("n_pages", [1, 10, 17, 128, 400, 4476])
def test_mla_staging_fits_shared_memory(hg, n_pages):
    """The staging :func:`mla_slots` picks — every slab resident (0) or a
    ring of 2 to 12 — fits in the 227 KB a block may use; -1 exactly when
    not even a ring of 2 does."""
    slots = tpa.mla_slots(hg, 512, 64, n_pages, 16)
    if slots < 0:
        assert tpa._mla_smem(hg, 512, 64, n_pages, 16, 2) > 227 * 1024
        return
    assert slots == 0 or 2 <= slots <= 12
    assert tpa._mla_smem(hg, 512, 64, n_pages, 16, slots) <= 227 * 1024
    if slots > 0:
        assert tpa._mla_smem(hg, 512, 64, n_pages, 16, 0) > 227 * 1024


def test_serving_cell_sizing():
    """The serving cell (4 rows, 128 heads, 10 pages of 16): one block a
    row and group, groups of 4 (128 blocks, the rule's half-the-SMs floor),
    every slab resident (10 tiles x 9 slabs). At 2048 keys a row: the key
    tiles split over clusters of two, groups of 8 (64 clusters, 128 blocks)
    and a ring of 5 slabs a warp."""
    assert tpa.mla_split(10, 16) == 1 and tpa.mla_split(128, 16) == 2
    assert tpa.mla_split(16, 16) == 1 and tpa.mla_split(17, 16) == 2
    assert tpa.head_group(128, 512, 64, 10, 16, rows=4, sms=132,
                          route="mla_mma") == 4
    assert tpa.mla_slots(4, 512, 64, 10, 16) == 0
    assert tpa._mla_smem(4, 512, 64, 10, 16, 0) == (
        10 * 9 * 2048 + 2 * 13 * 584 + 4 * 4 * 160 + 40 + 4 * 34 * 8)
    assert tpa.head_group(128, 512, 64, 128, 16, rows=4, sms=132,
                          route="mla_mma") == 8
    assert tpa.mla_slots(8, 512, 64, 128, 16) == 5


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_sizing_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's block shape, slab, ring depth and
    head group, from which it sizes the shared memory it passes to the
    launcher, agrees with ``csrc/paged_decode_mla.cu``."""
    src = (CSRC / "paged_decode_mla.cu").read_text()
    assert tpa._MLA_WARPS == _constant(src, "kWarps")
    assert tpa._MLA_VGROUPS == _constant(src, "kVGroups")
    assert tpa._MLA_SLAB == _constant(src, "kSlab")
    assert tpa._MLA_MAX_SLOTS == _constant(src, "kMaxSlots")
    assert tpa._MAX_HG == _constant(src, "kMaxHG")
    assert _constant(src, "kTile") == 16
    assert _constant(src, "kPlanes") == 3
    assert "kRowBytes = kSlab * 2" in src
    assert "kSlabBytes = kTile * kRowBytes" in src
    assert tpa._MLA_SLAB_BYTES == 16 * tpa._MLA_SLAB * 2
    # warp maxima and denominators, then the block's, per head
    assert tpa._MLA_RED_BYTES == 4 * (2 * tpa._MLA_WARPS + 2) * tpa._MAX_HG
    # the launcher's limits are the route's; the split is 1 or 2
    assert "Dk > kVGroups * kSlab" in src and "D2 > 2 * kSlab" in src
    assert "split != 1 && split != 2" in src
    assert tpa._MLA_MAX_DK == 512 and tpa._MLA_MAX_D2 == 128


def test_the_source_is_built_and_bound():
    from repro_torch.kernels import _build
    assert "paged_decode_mla" in _build.SOURCES
    assert "paged_decode_mla_launch" in (CSRC / "paged_decode_mla.cu"
                                         ).read_text()
    assert tpa.ROUTES == ("gqa_mma", "mla_mma", "cuda_core")
    assert set(tpa.launches_by_route) == set(tpa.ROUTES)


# ---------------------------------------------------------------------------
# the exact three-plane split, in plain torch
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): round to
    nearest, f32 subtraction — what the kernel does to q, q2 and p."""
    hi = x.to(BF16).float()
    r = x - hi
    mid = r.to(BF16).float()
    lo = (r - mid).to(BF16).float()
    return hi, mid, lo


def _values(seed: int) -> torch.Tensor:
    """Random f32 values over |x| in [2^-100, bf16's largest finite value]
    and edge cases: powers of two (mid = lo = 0), values of 16 and 8
    significant bits (lo = 0, or mid = lo = 0), values one f32 ulp from a
    power of two, 0 and -0, the range's ends."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(-100.0, 127.0, size=50000)
    x = (rng.choice([-1.0, 1.0], size=e.size) * rng.uniform(1.0, 2.0, e.size)
         * 2.0 ** np.floor(e)).astype(np.float32)
    pow2 = (2.0 ** np.arange(-100, 128)).astype(np.float32)
    bits16 = (np.round(rng.uniform(2 ** 15, 2 ** 16, 500))
              * 2.0 ** rng.integers(-110, 100, 500)).astype(np.float32)
    bits8 = (np.round(rng.uniform(2 ** 7, 2 ** 8, 500))
             * 2.0 ** rng.integers(-100, 110, 500)).astype(np.float32)
    near = np.concatenate([np.nextafter(pow2, np.float32(0)),
                           np.nextafter(pow2, np.float32(np.inf))])
    ends = np.array([0.0, -0.0, 2.0 ** -100, -(2.0 ** -100), BF16_MAX,
                     -BF16_MAX, 1.0 / 3.0, math.pi], np.float32)
    x = np.concatenate([x, pow2, -pow2, bits16, bits8, near, ends])
    x = x[np.isfinite(x) & ((np.abs(x) <= BF16_MAX) & ((np.abs(x) >= 2.0 ** -100)
                                                       | (x == 0)))]
    return torch.from_numpy(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_bf16_planes_sum_to_the_f32_value_bit_for_bit(seed):
    x = _values(seed)
    hi, mid, lo = _split(x)
    for plane in (hi, mid, lo):          # each plane is a bf16 value
        assert torch.equal(plane.to(BF16).float(), plane)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert torch.equal((hi + mid) + lo, x)
    # in f64 too, with no rounding anywhere
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # the edge cases: powers of two split into hi alone, 16-bit values
    # into hi and mid
    pow2 = torch.tensor([2.0 ** i for i in range(-100, 128)])
    p_hi, p_mid, p_lo = _split(pow2)
    assert torch.equal(p_hi, pow2) and (p_mid == 0).all() and (p_lo == 0).all()
    v16 = torch.tensor([2.0 ** 15 + 1.0, 1.0 + 2.0 ** -15, -3.0 * 2 ** -90
                        - 2.0 ** -104], dtype=F32)
    v_hi, v_mid, v_lo = _split(v16)
    assert (v_mid != 0).all() and (v_lo == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_each_plane_times_a_bf16_latent_is_exact_in_f32(seed):
    """For a bf16 k, each plane x k computed in f32 is exact (at most 16
    significant bits), so the three f32 products summed in f64 equal x x k
    in f64 — wherever x x k neither overflows nor underflows f32."""
    x = _values(seed)
    rng = np.random.default_rng(seed + 10)
    k = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(
        BF16).float()
    k = torch.where(k.abs() < 2.0 ** -8, torch.full_like(k, 0.5), k)
    keep = (x.abs() <= 2.0 ** 100) & ((x.abs() >= 2.0 ** -90) | (x == 0))
    x, k = x[keep], k[keep]
    hi, mid, lo = _split(x)
    for plane in (hi, mid, lo):
        assert torch.equal((plane * k).double(), plane.double() * k.double())
    three = ((hi * k).double() + (mid * k).double()) + (lo * k).double()
    assert torch.equal(three, x.double() * k.double())
    # probabilities in [0, 1] against latents, the context's products
    p = torch.from_numpy(rng.uniform(0.0, 1.0, 20000).astype(np.float32))
    kv = k[:p.numel()] if k.numel() >= p.numel() else k.repeat(
        -(-p.numel() // k.numel()))[:p.numel()]
    ph, pm, pl = _split(p)
    assert torch.equal(((ph * kv).double() + (pm * kv).double())
                       + (pl * kv).double(), p.double() * kv.double())


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel at DeepSeek-V3's widths
# ---------------------------------------------------------------------------


def _deepseek_case(seed, *, H=16, r=512, dr=64, bs=16, n_pages=3):
    """Latents of DeepSeek-V3's width (r 512, dr 64) in bf16, f32 queries of
    16 heads; rows at a page boundary, mid-page, of one key and vacant; dead
    entries and stale live slots holding finite garbage."""
    rng = np.random.default_rng(seed)
    lengths = np.array([n_pages * bs, 21, 1, 0], np.int32)
    B = lengths.size
    n_live = B * n_pages
    poison = np.arange(1 + n_live, n_live + 3)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    bt = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b, L in enumerate(lengths):
        used = -(-int(L) // bs)
        bt[b, :used] = perm[c:c + used]
        c += used
        if L:
            bt[b, used:] = rng.choice(poison, size=n_pages - used)
    ckv = rng.normal(size=(n_live + 3, bs, 1, r)).astype(np.float32)
    kr = rng.normal(size=(n_live + 3, bs, 1, dr)).astype(np.float32)
    for x, val in ((ckv, 30.0), (kr, -30.0)):
        x[poison] = val
        for b, L in enumerate(lengths):
            for pos in range(int(L), -(-int(L) // bs) * bs):
                x[bt[b, pos // bs], pos % bs] = val
    q1 = rng.normal(size=(B, 1, H, r)).astype(np.float32)
    q2 = rng.normal(size=(B, 1, H, dr)).astype(np.float32)
    return q1, q2, ckv, kr, bt, lengths


@pytest.mark.parametrize("seed,window", [(0, None), (1, 9)])
def test_plain_version_matches_pallas_kernel_at_deepseek_width(seed, window):
    q1, q2, ckv, kr, bt, ln = _deepseek_case(seed)
    kw = dict(scale=1.0 / math.sqrt(128 + 64), scale_mode="mul",
              window=window)
    want = np.asarray(jax_paged(
        jnp.asarray(q1), jnp.asarray(ckv, jnp.bfloat16), None,
        jnp.asarray(bt), jnp.asarray(ln), q2=jnp.asarray(q2),
        k2=jnp.asarray(kr, jnp.bfloat16), out_dtype=jnp.float32,
        interpret=True, **kw))
    n0 = dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(ckv).to(BF16), None,
        torch.from_numpy(bt), torch.from_numpy(ln), q2=torch.from_numpy(q2),
        k2=torch.from_numpy(kr).to(BF16), out_dtype=F32, **kw)
    assert tpa.launches_by_route == n0, "a CPU call launches nothing"
    assert got.dtype == F32 and got.shape == (4, 1, 16, 512)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    assert (got[3] == 0).all(), "a length-0 row must give zeros"
