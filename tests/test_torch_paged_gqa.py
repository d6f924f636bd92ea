"""The GQA form of paged decode in the port: the route that sends it to the
tensor-core kernel (``csrc/paged_decode_gqa.cu``), that kernel's
shared-memory sizing, and the port's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) at the widths of the
dense decoder configs (d_head 128, groups of 4, 5 and 7 query heads).

The kernel itself runs only on a card: ``test_torch_kernels_cuda.py`` holds
it against the plain version there. Here the CPU tensors take the plain
version, as the wrapper does for any CPU tensor.

Tolerance against the Pallas kernel: 2^-6 absolute and relative (two bf16
ulps at |o| ~ 1, the port's ``KERNEL_TOL``): both sum in f32, in different
orders, before rounding scores and probabilities to bf16, and a flipped
rounding moves an output by about one ulp."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.quant.formats import cast_to  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 2.0 ** -6
BF16, F32, FP8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

ROUTE_TABLE = [
    # (q dtype, kv dtype, v given, D2, Dk, Dv, rounded) -> route
    ((BF16, BF16, True, 0, 64, 64, True), "gqa_mma"),     # llama3_1b
    ((BF16, FP8, True, 0, 64, 64, True), "gqa_mma"),      # fp8 KV cache
    ((BF16, BF16, True, 0, 16, 16, True), "gqa_mma"),
    ((BF16, BF16, True, 0, 32, 32, True), "gqa_mma"),
    ((BF16, BF16, True, 0, 48, 48, True), "gqa_mma"),
    ((BF16, FP8, True, 0, 128, 128, True), "gqa_mma"),    # llama3_8b
    ((BF16, BF16, True, 0, 256, 256, True), "gqa_mma"),
    ((BF16, BF16, True, 0, 8, 8, True), "cuda_core"),     # below one k-step
    ((BF16, BF16, True, 0, 72, 72, True), "cuda_core"),   # not a multiple
    ((BF16, BF16, True, 0, 512, 512, True), "cuda_core"),  # too wide
    ((BF16, BF16, True, 0, 128, 64, True), "cuda_core"),  # Dk != Dv
    ((F32, BF16, True, 0, 64, 64, False), "cuda_core"),   # f32 queries
    ((BF16, F32, True, 0, 64, 64, True), "cuda_core"),    # f32 K/V
    ((BF16, BF16, True, 0, 64, 64, False), "cuda_core"),  # unrounded
    ((F32, BF16, False, 64, 512, 512, False), "mla_mma"),  # MLA form
    ((BF16, BF16, False, 0, 64, 64, True), "cuda_core"),  # v from k
    ((BF16, BF16, True, 64, 64, 64, True), "cuda_core"),  # a q2 . k2 part
]


@pytest.mark.parametrize("args,want", ROUTE_TABLE,
                         ids=[f"{i}-{w}" for i, (_, w) in
                              enumerate(ROUTE_TABLE)])
def test_route_table(args, want):
    assert tpa.route(*args) == want


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """A CPU call returns the plain version's bits and leaves the launch
    counters as they were."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 2, 4, 64)).astype(
        np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.normal(size=(5, 16, 2, 64)).astype(
        np.float32)).to(BF16) for _ in range(2))
    bt = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    ln = torch.tensor([20, 9], dtype=torch.int32)
    kw = dict(scale=8.0, score_dtype=BF16, probs_dtype=BF16)
    n0, by0 = tpa.launches, dict(tpa.launches_by_route)
    got = tpa.paged_decode_attention(q, k, v, bt, ln, **kw)
    assert torch.equal(got, tref.paged_decode_attention_ref(q, k, v, bt, ln,
                                                            **kw))
    assert tpa.launches == n0 and tpa.launches_by_route == by0


# ---------------------------------------------------------------------------
# shared memory of the GQA kernel
# ---------------------------------------------------------------------------

def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_sizing_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's block shape and ring depth, from
    which it sizes the shared memory it passes to the launcher, agrees with
    ``csrc/paged_decode_gqa.cu``."""
    src = (Path(tpa.__file__).parent / "csrc" / "paged_decode_gqa.cu"
           ).read_text()
    warps = _constant(src, "kWarps")
    tile = _constant(src, "kTile")
    assert "kChunk = kTile * kWarps" in src
    assert tpa._GQA_CHUNK == warps * tile
    assert tpa._GQA_MAX_SLOTS == _constant(src, "kMaxSlots")
    assert tpa._GQA_RED_BYTES == 2 * 4 * warps * _constant(src, "kMaxHG")


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("kv", [BF16, FP8])
def test_route_by_table_width(D, kv):
    """A table the GQA kernel holds at one head takes it; one page wider
    takes the CUDA-core kernel. That kernel holds the wider table only at
    D 256 (54,448 keys against 43,008); at D 64 and 128 the GQA kernel
    holds more, and the wider table fits neither."""
    n = tpa.max_context(D, 0, 16, route="gqa_mma") // 16
    form = (BF16, kv, True, 0, D, D, True)
    assert tpa.route(*form, n_pages=n, bs=16) == "gqa_mma"
    assert tpa.route(*form, n_pages=n + 1, bs=16) == "cuda_core"
    core_fits = tpa.head_group(1, D, 0, n + 1, 16) == 1
    assert core_fits == (D == 256)
    assert core_fits == (tpa.max_context(D, 0, 16) > 16 * n)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 5, 7, 8])
@pytest.mark.parametrize("n_pages", [10, 128, 2000])
def test_head_group_fits_shared_memory(D, G, n_pages):
    """Whatever group the wrapper picks, its shared memory fits in the
    227 KB a block may use, with a ring of at least 2 slots."""
    hg = tpa.head_group(G, D, 0, n_pages, 16, rows=32, sms=132,
                        route="gqa_mma")
    assert 1 <= hg <= min(G, 8)
    slots = tpa.gqa_slots(hg, D, n_pages, 16)
    assert 2 <= slots <= 12
    assert tpa.smem_bytes(hg, D, 0, n_pages, 16, "gqa_mma") <= 227 * 1024
    assert tpa._gqa_smem(hg, D, n_pages, 16, slots) <= 227 * 1024


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hg", [1, 2, 4, 8])
def test_gqa_context_is_no_shorter_than_before(D, hg):
    """The GQA kernel's largest table width is at least the CUDA-core
    kernel's at the head dims of the dense decoders, and is exact: it fits
    with 2 slots, one page more does not."""
    new = tpa.max_context(D, 0, 16, hg, route="gqa_mma")
    assert new >= tpa.max_context(D, 0, 16, hg)
    n = new // 16
    assert tpa._gqa_smem(hg, D, n, 16, 2) <= 227 * 1024
    assert tpa._gqa_smem(hg, D, n + 1, 16, 2) > 227 * 1024
    assert tpa.gqa_slots(hg, D, n, 16) >= 2
    assert tpa.gqa_slots(hg, D, n + 1, 16) == 0


def test_ring_depth_follows_the_table():
    """The serving step's table (10 pages of 16) puts all 4 loads in flight;
    a 2048-key table takes the deepest ring that fits."""
    assert tpa.gqa_slots(1, 64, 10, 16) == 4
    assert tpa.gqa_slots(1, 64, 128, 16) == 12
    assert tpa.gqa_slots(1, 128, 128, 16) == 6
    assert tpa.head_group(4, 64, 0, 10, 16, rows=32, sms=132,
                          route="gqa_mma") == 1


def test_sweep_cuts_find_their_markers():
    """``paged_kernel_sweep.py`` cuts each kernel at markers that must stay
    in the sources."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "paged_kernel_sweep", ROOT / "paged_kernel_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    csrc = Path(tpa.__file__).parent / "csrc"
    for source, cuts in sweep.CUTS.items():
        text = (csrc / f"{source}.cu").read_text()
        for name, marker in cuts.items():
            assert text.count(marker) == 1, (source, name)


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel at the A1 widths
# ---------------------------------------------------------------------------

POISON = 224.0      # finite garbage inside the e4m3 range


def _a1_case(seed, G, *, B=3, Hkv=2, D=128, bs=16, n_pages=4,
             stale=POISON, window=None):
    """Rows at a page boundary, mid-page and a vacant row; dead entries on
    poisoned blocks; and ``stale`` in every slot of a live page past the
    row's length or below its window."""
    rng = np.random.default_rng(seed)
    lengths = np.array([n_pages * bs, 37, 0][:B], np.int32)
    n_live = B * n_pages
    poison = np.arange(1 + n_live, n_live + 3)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    bt = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        bt[b, :used] = perm[c:c + used]
        c += used
        if lengths[b]:
            bt[b, used:] = rng.choice(poison, size=n_pages - used)
    k, v = (rng.normal(size=(n_live + 3, bs, Hkv, D)).astype(np.float32)
            for _ in range(2))
    for x in (k, v):
        x[poison] = POISON
        for b, L in enumerate(lengths):
            lo = 0 if window is None else max(0, int(L) - window)
            for pos in range(-(-int(L) // bs) * bs):
                if pos >= L or pos < lo:
                    x[bt[b, pos // bs], pos % bs] = stale
    q = rng.normal(size=(B, Hkv, G, D)).astype(np.float32)
    return q, k, v, bt, lengths


def _jax(q, k, v, bt, ln, kv, **kw):
    jd = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}[kv]
    return np.asarray(jax_paged(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k).astype(jd),
        jnp.asarray(v).astype(jd), jnp.asarray(bt), jnp.asarray(ln),
        score_dtype=jnp.bfloat16, probs_dtype=jnp.bfloat16,
        out_dtype=jnp.bfloat16, interpret=True, **kw), np.float32)


def _port(q, k, v, bt, ln, kv, **kw):
    td = {"bf16": BF16, "fp8": FP8}[kv]
    return tpa.paged_decode_attention(
        torch.from_numpy(q).to(BF16), cast_to(torch.from_numpy(k), td),
        cast_to(torch.from_numpy(v), td), torch.from_numpy(bt),
        torch.from_numpy(ln), score_dtype=BF16, probs_dtype=BF16,
        out_dtype=BF16, **kw).float().numpy()


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("G", [4, 5, 7])
@pytest.mark.parametrize("window", [None, 7])
def test_plain_version_matches_pallas_kernel_at_d128(kv, G, window):
    """d_head 128 (llama3_8b and the other A1 configs), block 16, bf16 and
    scaled fp8 K/V, with finite garbage in stale slots of live pages and
    in dead blocks."""
    q, k, v, bt, ln = _a1_case(G, G, window=window)
    kw = dict(scale=float(np.sqrt(128)), window=window)
    if kv == "fp8":
        kw.update(k_scale=0.5, v_scale=2.0)
    want = _jax(q, k, v, bt, ln, kv, **kw)
    got = _port(q, k, v, bt, ln, kv, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[2] == 0).all(), "a length-0 row must give zeros"


def test_caveat_nan_in_stale_live_slots_reaches_the_cpu_paths():
    """Reference caveat: with NaN in the stale slots of a live page (B 1,
    block 4, length 6), the JAX kernel in interpret mode, the JAX gather
    reference and the port's plain version all return NaN, through
    0 x NaN in the context sum. The CUDA kernels never read those slots
    and return finite values (held on the card), so the port is held
    against the JAX package on finite stale values only."""
    rng = np.random.default_rng(1)
    bs, D = 4, 16
    q = rng.normal(size=(1, 1, 2, D)).astype(np.float32)
    k, v = (rng.normal(size=(3, bs, 1, D)).astype(np.float32)
            for _ in range(2))
    bt = np.array([[1, 2]], np.int32)
    ln = np.array([6], np.int32)
    for x in (k, v):
        x[2, 2:] = np.nan                 # slots 6 and 7 of the second page
    kw = dict(scale=4.0)
    jax_kernel = _jax(q, k, v, bt, ln, "bf16", **kw)
    jax_ref = np.asarray(jref.paged_decode_attention_ref(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k).astype(
            jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16),
        jnp.asarray(bt), jnp.asarray(ln), score_dtype=jnp.bfloat16,
        probs_dtype=jnp.bfloat16, out_dtype=jnp.bfloat16, **kw), np.float32)
    port = _port(q, k, v, bt, ln, "bf16", **kw)
    for name, out in (("JAX kernel", jax_kernel), ("JAX reference", jax_ref),
                      ("port plain version", port)):
        assert np.isnan(out).any(), name
    # the same inputs with the stale slots finite: all three agree
    for x in (k, v):
        x[2, 2:] = POISON
    np.testing.assert_allclose(_port(q, k, v, bt, ln, "bf16", **kw),
                               _jax(q, k, v, bt, ln, "bf16", **kw),
                               rtol=TOL, atol=TOL)
