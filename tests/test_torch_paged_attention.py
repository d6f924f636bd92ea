"""Paged-attention decode in the port: the plain version against the
reference oracle, and the layer-level dispatch. The CUDA kernel itself is
held against the plain version in ``test_torch_kernels_cuda.py`` (card
only).

The plain version (``repro_torch.kernels.ref``) is held against the
reference's ``ref.paged_decode_attention_ref`` — not the interpret-mode
Pallas kernel, which is slow to compile — on inputs drawn with numpy. Both
sum in f32, in different orders, before rounding scores and probabilities to
bf16, so the comparison allows the reference suite's kernel tolerance
(rtol 1e-2, atol 1e-5): a masking leak shows up as NaN or a wildly wrong row,
not as a sub-percent wiggle."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn.spec import default_generator, init_params  # noqa: E402
from repro_torch.quant.formats import cast_to  # noqa: E402
from repro_torch.quant.qops import QuantContext  # noqa: E402

POISON = 224.0      # huge-but-finite garbage inside the fp8_e4m3 range

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _case(seed, *, B, n_pages, bs, vacant_row=True, stale_entries=True):
    """Rows of different lengths, unallocated (-1) entries, stale entries
    pointing at poisoned blocks, and a vacant row (all -1, length 0)."""
    rng = np.random.default_rng(seed)
    live_budget = B * n_pages
    n_blocks = 1 + live_budget + 4
    lengths = rng.integers(1, n_pages * bs + 1, size=B).astype(np.int32)
    if vacant_row:
        lengths[-1] = 0
    perm = rng.permutation(np.arange(1, 1 + live_budget))
    poison = np.arange(1 + live_budget, n_blocks)
    tables = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        tables[b, :used] = perm[c:c + used]
        c += used
        if stale_entries and lengths[b] > 0:
            for pg in range(used, n_pages):
                if rng.random() < 0.5:
                    tables[b, pg] = rng.choice(poison)
    return n_blocks, tables, lengths, poison, rng


def _fill(rng, shape, poison_blocks, value=POISON):
    x = rng.normal(size=shape).astype(np.float32)
    if len(poison_blocks):
        x[np.asarray(poison_blocks, np.int64)] = value
    return x


def _both(q, k, v, bt, lengths, kv, **kw):
    """Run the reference oracle and the port's plain version on the same
    numpy inputs; returns both outputs as float32 numpy arrays."""
    jd, td = DTYPES[kv]
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k).astype(jd),
        jnp.asarray(v).astype(jd), jnp.asarray(bt), jnp.asarray(lengths),
        score_dtype=jnp.bfloat16, probs_dtype=jnp.bfloat16,
        out_dtype=jnp.bfloat16, **kw)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q).to(torch.bfloat16),
        cast_to(torch.from_numpy(k), td), cast_to(torch.from_numpy(v), td),
        torch.from_numpy(bt), torch.from_numpy(lengths),
        score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
        out_dtype=torch.bfloat16, **kw)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_reference_oracle(kv, window, seed):
    B, Hkv, G, Dk, n_pages, bs = 3, 2, 2, 32, 5, 4
    n_blocks, bt, lengths, poison, rng = _case(seed, B=B, n_pages=n_pages,
                                               bs=bs)
    k = _fill(rng, (n_blocks, bs, Hkv, Dk), poison)
    v = _fill(rng, (n_blocks, bs, Hkv, Dk), poison)
    q = rng.normal(size=(B, Hkv, G, Dk)).astype(np.float32)
    ks, vs = (0.5, 2.0) if kv == "fp8" else (1.0, 1.0)
    got, want = _both(q, k, v, bt, lengths, kv, window=window,
                      scale=math.sqrt(Dk), scale_mode="div", k_scale=ks,
                      v_scale=vs)
    assert np.isfinite(got).all(), "stale/dead entries leaked into output"
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-5)
    assert (got[-1] == 0).all(), "a length-0 row must give zeros"


def test_exact_length_boundary_and_unreferenced_nan():
    """Lengths at a page boundary, mid-page and 1: scribbling every position
    past a row's length — and NaN in blocks no table entry references —
    leaves the output unchanged, and it matches the reference oracle."""
    B, Hkv, G, Dk, n_pages, bs = 3, 1, 2, 16, 4, 4
    rng = np.random.default_rng(3)
    n_blocks = 1 + B * n_pages + 2          # two blocks nobody references
    lengths = np.array([8, 5, 1], np.int32)
    bt = np.full((B, n_pages), -1, np.int32)
    ids = iter(range(1, n_blocks))
    for b in range(B):
        for pg in range(-(-int(lengths[b]) // bs)):
            bt[b, pg] = next(ids)
    k = rng.normal(size=(n_blocks, bs, Hkv, Dk)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, Hkv, Dk)).astype(np.float32)
    k[-2:] = np.nan
    v[-2:] = np.nan
    q = rng.normal(size=(B, Hkv, G, Dk)).astype(np.float32)
    kw = dict(scale=math.sqrt(Dk), scale_mode="div")
    base, want = _both(q, k, v, bt, lengths, "bf16", **kw)
    assert np.isfinite(base).all()
    np.testing.assert_allclose(base, want, rtol=1e-2, atol=1e-5)
    k2, v2 = k.copy(), v.copy()
    for b in range(B):
        for pos in range(int(lengths[b]), n_pages * bs):
            pg, off = divmod(pos, bs)
            if bt[b, pg] >= 0:
                k2[bt[b, pg], off] = 1e4
                v2[bt[b, pg], off] = -1e4
    again, _ = _both(q, k2, v2, bt, lengths, "bf16", **kw)
    np.testing.assert_array_equal(base, again)


def test_plain_version_mla_form_matches_reference_oracle():
    """The plain version also keeps the MLA absorbed form (v=None, q2/k2,
    scale_mode='mul', f32 throughout); only the CUDA kernel defers it."""
    B, H, r, dr, n_pages, bs = 2, 4, 24, 8, 4, 4
    n_blocks, bt, lengths, poison, rng = _case(7, B=B, n_pages=n_pages,
                                               bs=bs, vacant_row=False)
    ckv = _fill(rng, (n_blocks, bs, 1, r), poison)
    kr = _fill(rng, (n_blocks, bs, 1, dr), poison)
    q1 = rng.normal(size=(B, 1, H, r)).astype(np.float32)
    q2 = rng.normal(size=(B, 1, H, dr)).astype(np.float32)
    kw = dict(scale=1.0 / math.sqrt(r + dr), scale_mode="mul")
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q1), jnp.asarray(ckv).astype(jnp.bfloat16), None,
        jnp.asarray(bt), jnp.asarray(lengths), q2=jnp.asarray(q2),
        k2=jnp.asarray(kr).astype(jnp.bfloat16), out_dtype=jnp.float32, **kw)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(ckv).to(torch.bfloat16), None,
        torch.from_numpy(bt), torch.from_numpy(lengths),
        q2=torch.from_numpy(q2),
        k2=torch.from_numpy(kr).to(torch.bfloat16), out_dtype=torch.float32,
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# layer-level dispatch: the kernel switch lives in use_fused_paged
# ---------------------------------------------------------------------------


def test_fused_dispatch_predicate():
    """Mirrors the reference's dispatch cases: MP formats on the attention
    BGEMMs, probe mode and registry traces all force the gather path."""
    ctx = QuantContext()
    assert TL.use_fused_paged(ctx, "layers/0/attn", "fused")
    assert not TL.use_fused_paged(ctx, "layers/0/attn", "gather")
    mp_ctx = QuantContext(mode="mp",
                          mp={"layers/0/attn/qk_matmul": "fp8_e4m3"})
    assert not TL.use_fused_paged(mp_ctx, "layers/0/attn", "fused")
    assert TL.use_fused_paged(mp_ctx, "layers/1/attn", "fused")
    mp_ctx2 = QuantContext(mode="mp",
                           mp={"layers/0/attn/av_matmul": "fp8_e5m2"})
    assert not TL.use_fused_paged(mp_ctx2, "layers/0/attn", "fused")
    assert not TL.use_fused_paged(QuantContext(mode="probe"), "x", "fused")
    assert not TL.use_fused_paged(QuantContext(registry=[]), "x", "fused")
    with pytest.raises(AssertionError):
        TL.use_fused_paged(ctx, "x", "flash")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count calls of the kernel wrapper (on the CPU it runs the plain
    version; on a card each call is one launch)."""
    calls = []
    orig = tpa.paged_decode_attention

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tpa, "paged_decode_attention", counting)
    return calls


def _layer_case(paged_attn, ctx=None, window=None, kv_scales=None):
    cfg = TL.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        window=window, kv_dequant_scales=kv_scales)
    specs = {k.split("/", 1)[1]: s for k, s in TL.attn_specs("attn",
                                                             cfg).items()}
    params = init_params(default_generator(0, "cpu"), specs, "cpu")
    rng = np.random.default_rng(11)
    B, bs, n_pages = 2, 4, 4
    n_blocks = 1 + B * n_pages
    cache = {n: torch.from_numpy(rng.normal(size=(n_blocks, bs, 2, 16)).astype(
        np.float32)).to(torch.bfloat16) for n in ("k", "v")}
    bt = torch.from_numpy(np.arange(1, 1 + B * n_pages, dtype=np.int32)
                          .reshape(B, n_pages))
    x = torch.from_numpy(rng.normal(size=(B, 1, 64)).astype(
        np.float32)).to(torch.bfloat16)
    positions = torch.tensor([[9], [4]], dtype=torch.int32)
    y, new_cache = TL.attention(params, ctx or QuantContext(), "attn", cfg,
                                x, positions, cache=cache,
                                cache_pos=positions[:, 0], block_tables=bt,
                                paged_attn=paged_attn)
    return y.float().numpy(), {n: t.float().numpy()
                               for n, t in new_cache.items()}


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_scales", [None, (("k", 0.5), ("v", 2.0))])
def test_layer_fused_matches_gather(kernel_calls, window, kv_scales):
    """Both paged read paths of one layer: the fused path calls the kernel
    wrapper once, the gather path never; the cache writes are bitwise equal
    and the outputs agree to bf16 rounding (on the CPU both sum in f32 in
    their own order)."""
    yf, cf = _layer_case("fused", window=window, kv_scales=kv_scales)
    assert len(kernel_calls) == 1
    yg, cg = _layer_case("gather", window=window, kv_scales=kv_scales)
    assert len(kernel_calls) == 1
    np.testing.assert_allclose(yf, yg, rtol=2.0 ** -7, atol=1e-3)
    for name in ("k", "v"):
        np.testing.assert_array_equal(cf[name], cg[name])


def test_layer_mp_on_bgemm_falls_back_to_gather(kernel_calls):
    """A layer whose qk_matmul carries an MP format keeps the exact quantized
    reference path even when paged_attn='fused' is asked for: bitwise equal
    to the gather path, and no kernel call."""
    ctx = QuantContext(mode="mp", mp={"attn/qk_matmul": "fp8_e4m3"},
                       act_scale_token=True)
    yf, _ = _layer_case("fused", ctx=ctx)
    yg, _ = _layer_case("gather", ctx=ctx)
    assert kernel_calls == []
    np.testing.assert_array_equal(yf, yg)


def test_paged_gather_applies_dequant_scales():
    """``paged_gather`` with scales == the plain version's gathered dequant
    (f32 multiply then cast); unit scales are a plain cast."""
    rng = np.random.default_rng(5)
    cache = {n: cast_to(torch.from_numpy(rng.normal(size=(7, 4, 2, 8)).astype(
        np.float32)), torch.float8_e4m3fn) for n in ("k", "v")}
    bt = torch.tensor([[1, 3, -1], [2, 6, 4]], dtype=torch.int32)
    g, kp = TL.paged_gather(cache, bt, torch.bfloat16, {"k": 0.5, "v": 2.0})
    assert kp.shape == (2, 12)
    for name, s in (("k", 0.5), ("v", 2.0)):
        assert torch.equal(g[name], tref.paged_deq(cache[name], bt,
                                                   torch.bfloat16, s))
    g1, _ = TL.paged_gather(cache, bt, torch.bfloat16, {"k": 1.0})
    assert torch.equal(g1["k"], cache["k"][bt.clamp_min(0).long()].reshape(
        2, 12, 2, 8).to(torch.bfloat16))
