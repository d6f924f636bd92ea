"""``scan_layers`` in the port: stacked-layer segments (``LMConfig.segments``)
with per-segment op names and two-level remat, held bit for bit against the
port's unrolled model on the same stacked weights (``bridge.stack_layers``)
and within ``tests/test_torch_model.py``'s tolerance against the
reference's scan model on bridged weights; its graph, its refusals and its
MP assignments against the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graphs as jgraphs  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths as jflatten  # noqa: E402
from repro.quant import kv_scales as jkv  # noqa: E402
from repro.quant.qops import QuantContext as JCtx  # noqa: E402
from repro_torch.bridge import params_from_flat, stack_layers  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.models.lm import LMConfig, ssm_tensors  # noqa: E402
from repro_torch.models.registry import (ARCH_IDS,  # noqa: E402
                                         get_model as tget,
                                         get_smoke_config)
from repro_torch.nn.spec import flatten_paths, tree_from_flat  # noqa: E402
from repro_torch.quant import kv_scales as tkv  # noqa: E402
from repro_torch.quant import weight_cache  # noqa: E402
from repro_torch.quant.qops import QuantContext  # noqa: E402

CTX = QuantContext()
# (arch, overrides): a sliding window with a global layer (as the
# reference's traced-window test), a two-level remat segment with a tail
# (7 layers in groups of 2), hybrid blocks (window + SSM state), and
# DeepSeek's dense and MoE segments with its unstacked MTP block
CASES = {
    "window": ("qwen2p5_3b", dict(n_layers=2, sliding_window=6,
                                  global_attn_layers=(1,))),
    "two_level": ("llama3_1b", dict(n_layers=7, remat_group=2)),
    "hybrid": ("hymba_1p5b", dict(remat_group=2)),
    "moe_mtp": ("deepseek_v3_671b", {}),
}


def _pair(case, dtype="float32", **extra):
    """(unrolled model, scan model, unrolled params, stacked params) on
    the same weights."""
    arch, kw = CASES[case]
    kw = dict(kw, dtype=dtype, **extra)
    mu = tget(arch, smoke=True, **kw)
    ms = tget(arch, smoke=True, scan_layers=True, **kw)
    pu = mu.init(torch.Generator().manual_seed(0), "cpu")
    ps = tree_from_flat(stack_layers(flatten_paths(pu), ms.cfg))
    return mu, ms, pu, ps


def _tokens(model, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, model.cfg.vocab_size, shape)
                            .astype(np.int32))


def _loss_and_grads(model, flat, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = model.loss(tree_from_flat(leaves), batch, CTX)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(leaves[k]) if g is None else g
                  for k, g in zip(leaves, gs)}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_equals_unrolled_bit_for_bit(case):
    mu, ms, pu, ps = _pair(case, remat=True)
    toks = _tokens(mu, (2, 12))
    with torch.no_grad():
        assert torch.equal(mu.apply(pu, toks, CTX), ms.apply(ps, toks, CTX))
    # one training step's loss and gradients, under remat (and, for
    # "two_level" and "hybrid", the grouped two-level remat)
    batch = {"tokens": toks, "labels": _tokens(mu, (2, 12), 1)}
    fu = flatten_paths(pu)
    lu, gu = _loss_and_grads(mu, fu, batch)
    ls, gs = _loss_and_grads(ms, flatten_paths(ps), batch)
    assert torch.equal(lu, ls)
    want = stack_layers(gu, ms.cfg)
    assert set(want) == set(gs)
    for k in want:
        assert torch.equal(want[k], gs[k]), k


def test_two_level_remat_takes_groups_and_a_tail():
    """7 layers in groups of 2: three checkpointed groups of two
    checkpointed layers, then one checkpointed layer; without remat (or a
    segment shorter than two groups) one layer at a time."""
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **k):
        calls.append(getattr(fn, "__name__", ""))
        return orig(fn, *a, **k)

    _, ms, _, ps = _pair("two_level", remat=True)
    batch = {"tokens": _tokens(ms, (2, 8)), "labels": _tokens(ms, (2, 8), 1)}
    torch.utils.checkpoint.checkpoint = spy
    try:
        _loss_and_grads(ms, flatten_paths(ps), batch)
    finally:
        torch.utils.checkpoint.checkpoint = orig
    # the forward: 3 groups, each checkpointing its 2 layers as it runs,
    # and the tail layer; the backward recomputes each group, which
    # checkpoints its 2 layers again
    assert len(calls) == (3 + 3 * 2 + 1) + 3 * 2, calls


def _paged_decode(model, params, paged_attn):
    """Prefill two rows into pages, then one paged decode step (the
    reference's scan-mode traced-window test, tests/test_paged_attention.py
    ``test_scan_mode_traced_window_fused_decode``)."""
    rng = np.random.default_rng(31)
    B, bs, nb = 2, 4, 16
    caches = model.init_paged_cache(B, nb, bs, "cpu")
    bt = np.full((B, 4), -1, np.int32)
    ids = iter(range(1, nb))
    lens = [9, 5]
    for b in range(B):
        for pg in range(-(-lens[b] // bs)):
            bt[b, pg] = next(ids)
    toks = torch.from_numpy(rng.integers(0, 200, (B, 12)).astype(np.int32))
    with torch.no_grad():
        _, caches = model.prefill_chunk(
            params, toks, caches, CTX, start_pos=torch.zeros(B, dtype=torch.int32),
            valid_len=torch.tensor(lens, dtype=torch.int32),
            block_tables=torch.from_numpy(bt))
        for b in range(B):
            pg = lens[b] // bs
            if bt[b, pg] < 0:
                bt[b, pg] = next(ids)
        tok = torch.from_numpy(rng.integers(0, 200, (B, 1)).astype(np.int32))
        lg, caches = model.decode_step(
            params, tok, torch.tensor(lens, dtype=torch.int32), caches, CTX,
            block_tables=torch.from_numpy(bt), paged_attn=paged_attn)
    return lg, caches


@pytest.mark.parametrize("case", ["window", "hybrid"])
def test_paged_prefill_and_decode_scan_fused_equals_gather(case):
    mu, ms, pu, ps = _pair(case, dtype="bfloat16")
    out = {pa: _paged_decode(ms, ps, pa) for pa in ("fused", "gather")}
    assert torch.equal(out["fused"][0], out["gather"][0])
    # the stacked caches are written slice by slice, as the unrolled
    # model writes its layers' caches
    lu, cu = _paged_decode(mu, pu, "fused")
    assert torch.equal(lu, out["fused"][0])
    cs = out["fused"][1]
    for i in range(mu.cfg.n_layers):
        for sub, t in flatten_paths(cu[f"layers/{i}"]).items():
            assert torch.equal(flatten_paths(cs["segments/0"])[sub][i], t)
    if case == "hybrid":          # per-layer slot-major SSM views
        assert [tuple(t.shape) for t in ssm_tensors(cs)] == \
            [tuple(t.shape) for t in ssm_tensors(cu)]


@pytest.mark.parametrize("case,dtype", [("window", "bfloat16"),
                                        ("two_level", "float32")])
def test_scan_matches_reference_scan_model(case, dtype):
    """The reference's scan model on bridged (stacked) weights: logits
    within test_torch_model.py's tolerance (f32 1e-4, bf16 2^-6, of the
    logits' scale)."""
    arch, kw = CASES[case]
    jm = jget(arch, smoke=True, scan_layers=True, dtype=dtype, **kw)
    jp = jm.init(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    tm = tget(arch, smoke=True, scan_layers=True, dtype=dtype, **kw)
    tp = params_from_flat(flat, tm.cfg, "cpu")
    toks = _tokens(tm, (2, 12))
    want = np.asarray(jm.apply(jp, jnp.asarray(toks.numpy()), JCtx()),
                      np.float32)
    with torch.no_grad():
        got = tm.apply(tp, toks, CTX).float().numpy()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_of_scan_config_matches_reference(arch):
    """``LM(scan_layers=True)`` builds every arch id but the
    encoder-decoder (which the reference's dry run keeps unrolled), and
    its graph is the reference's: one scope per segment."""
    from repro.models.registry import get_smoke_config as jsmoke
    if arch == "whisper_base":             # unrolled in both packages
        specs = tget(arch, smoke=True, scan_layers=True).param_specs()
        assert not any(p.startswith("segments/") for p in specs)
        assert set(specs) == set(jget(arch, smoke=True,
                                      scan_layers=True).param_specs())
        return
    tcfg = get_smoke_config(arch, scan_layers=True)
    tget(arch, smoke=True, scan_layers=True)
    tg, jg = (tgraphs.build_lm_graph(tcfg),
              jgraphs.build_lm_graph(jsmoke(arch, scan_layers=True)))
    assert list(tg.nodes) == list(jg.nodes)
    assert sorted(tg.edges) == sorted(jg.edges)
    assert tg.quantizable_nodes() == jg.quantizable_nodes()


def test_refusals_match_the_reference():
    """calibrate_kv_scales on a scan model, and non-uniform per-layer KV
    scales under scan, are refused with the reference's messages; uniform
    per-layer scales give every segment the first entry, as there."""
    from repro.models.registry import get_smoke_config as jsmoke
    tm = tget("llama3_1b", smoke=True, scan_layers=True)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError) as got:
        tkv.calibrate_kv_scales(tm, tp, [torch.zeros(1, 4, dtype=torch.int32)])
    jm = jget("llama3_1b", smoke=True, scan_layers=True)
    with pytest.raises(ValueError) as want:
        jkv.calibrate_kv_scales(jm, None, [np.zeros((1, 4), np.int32)])
    assert str(got.value) == str(want.value)
    n = get_smoke_config("llama3_1b").n_layers
    uneven = ((("k", 1.0), ("v", 2.0)),) + ((("k", 1.0), ("v", 1.0)),) * (
        n - 1)
    with pytest.raises(ValueError) as got:
        get_smoke_config("llama3_1b", scan_layers=True,
                         kv_dequant_scales=uneven)
    with pytest.raises(ValueError) as want:
        jsmoke("llama3_1b", scan_layers=True, kv_dequant_scales=uneven)
    assert str(got.value) == str(want.value)
    even = ((("k", 0.5), ("v", 2.0)),) * n
    for scan in (False, True):
        t = get_smoke_config("llama3_1b", scan_layers=scan,
                             kv_dequant_scales=even)
        j = jsmoke("llama3_1b", scan_layers=scan, kv_dequant_scales=even)
        assert t.kv_scales_for(None) == j.kv_scales_for(None)
        assert t.kv_scales_for(1) == j.kv_scales_for(1)
    assert isinstance(t, LMConfig) and t.segments() == j.segments()


def test_segment_assignment_quantizes_every_layer_on_its_own():
    """An MP assignment keyed by a segment's op name quantizes each layer's
    slice with its own scale: the scan model under it equals the unrolled
    model under the same format on every layer's op, bit for bit; each
    layer's slice is quantized once and served from the weight cache after
    (its view is made anew at every forward), until an in-place update of
    the stack invalidates every layer's entry."""
    mu, ms, pu, ps = _pair("two_level")
    n = ms.cfg.n_layers
    seg = {"segments/0/attn/q_proj": "fp8_e4m3",
           "segments/0/mlp/down_proj": "fp8_e4m3"}
    unrolled = {f"layers/{i}/{op}": "fp8_e4m3" for i in range(n)
                for op in ("attn/q_proj", "mlp/down_proj")}
    toks = _tokens(mu, (2, 12))
    with torch.no_grad():
        want = mu.apply(pu, toks, QuantContext(mode="mp", mp=unrolled))
        weight_cache.clear()
        before = weight_cache.quantizations
        got = ms.apply(ps, toks, QuantContext(mode="mp", mp=seg))
        assert weight_cache.quantizations - before == 2 * n
        assert torch.equal(got, want)
        again = ms.apply(ps, toks, QuantContext(mode="mp", mp=seg))
        assert weight_cache.quantizations - before == 2 * n
        assert torch.equal(again, want)
        stack = ps["segments"]["0"]["attn"]["q_proj"]["w"]
        for i in range(n):
            assert weight_cache.quantize_count(stack[i]) == 1
        stack.mul_(1.0)                      # in place: a new version
        ms.apply(ps, toks, QuantContext(mode="mp", mp=seg))
        assert weight_cache.quantizations - before == 3 * n
        assert all(weight_cache.quantize_count(stack[i]) == 2
                   for i in range(n))
    kept, weights = weight_cache.nbytes(torch.device("cpu"))
    assert weights == sum(v.numel() * v.element_size()
                          for k, v in flatten_paths(ps).items()
                          if k.startswith("segments/0/")
                          and ("q_proj" in k or "down_proj" in k))
    weight_cache.clear()


def test_segment_assignment_matches_reference_scan_model():
    """The same segment-keyed assignment in both packages' scan models
    (per-tensor weight scales, per-token activation scales): logits within
    test_torch_model.py's MP tolerance (2^-4 of the logits' scale)."""
    arch, kw = CASES["window"]
    mp = {"segments/0/attn/q_proj": "fp8_e4m3",
          "segments/0/mlp/down_proj": "fp8_e4m3"}
    jm = jget(arch, smoke=True, scan_layers=True, dtype="float32", **kw)
    jp = jm.init(jax.random.key(1))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    tm = tget(arch, smoke=True, scan_layers=True, dtype="float32", **kw)
    tp = params_from_flat(flat, tm.cfg, "cpu")
    toks = _tokens(tm, (2, 12))
    want = np.asarray(jm.apply(jp, jnp.asarray(toks.numpy()),
                               JCtx(mode="mp", mp=mp, act_scale_token=True)),
                      np.float32)
    with torch.no_grad():
        got = tm.apply(tp, toks, QuantContext(mode="mp", mp=mp,
                                              act_scale_token=True))
    tol = 2.0 ** -4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_stack_layers_matches_the_reference_stacking():
    """``stack_layers`` builds the tree the reference's own test builds by
    hand (tests/test_models.py ``test_scan_layers_equivalence``): every
    segment path, stacked in layer order; the serving op names follow."""
    cfg = get_smoke_config("deepseek_v3_671b", scan_layers=True)
    mu = tget("deepseek_v3_671b", smoke=True)
    flat = {k: np.full(s.shape, i, np.float32)
            for i, (k, s) in enumerate(mu.param_specs().items())}
    got = stack_layers(flat, cfg)
    for s, (_, idxs) in enumerate(cfg.segments()):
        for path in [p for p in got if p.startswith(f"segments/{s}/")]:
            sub = path.split("/", 2)[2]
            np.testing.assert_array_equal(
                got[path], np.stack([flat[f"layers/{i}/{sub}"]
                                     for i in idxs]))
    assert "mtp/block/attn/q_a_proj/w" in got
    ms = tget("deepseek_v3_671b", smoke=True, scan_layers=True)
    assert {o for o in ms.serving_op_names() if o != "lm_head"} == {
        n for n in tgraphs.build_lm_graph(cfg).quantizable_nodes()
        if n != "lm_head"}
    assert dataclasses.replace(cfg, scan_layers=False).segments() == \
        cfg.segments()
