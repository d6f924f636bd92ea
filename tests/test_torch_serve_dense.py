"""Dense-ring continuous serving in the port, the serving API the reference
has beside it, and the shape-keyed graphed step, on the CPU.

* The port's ``CachePool`` against the reference's: slot accounting,
  ``insert``, ring widths with ``chunk_extra``; the dense ring's chunk write
  and ``_ring_logical_gather`` against the reference's functions on a
  windowed ring widened by the chunk length.
* ``ContinuousBatchingEngine(paged=False)``: dense == paged and dense
  chunked == one-shot, bit for bit, on the smoke llama ("attn") and
  DeepSeek-V3's smoke dense MLA prefix ("mla"), plain and under an MP plan
  (every CPU product is an f32 sum over the same operands); the schedule
  counters against the reference's dense engine; the reference's windowed
  regression (window 12, chunks of 8) against the one-shot engine.
* A reference caveat: the reference's dense rows between two chunks of a
  prompt take the vacant-row decode write at position 0, so its dense
  chunked tokens leave the one-shot ones once a prompt is chunked while
  others decode; the port's garbage write lands where the row's next chunk
  writes first.
* ``ServeEngine.ttft`` / ``init_caches``, ``ServeSummary.tokens_for`` and
  ``prefill_cobatch=False`` against the reference's.
* ``launch.steps.GraphedStep``: eager on the CPU, and its table of captures
  (one per input shape, dropped with other params or caches, bounded by
  ``max_captures``) driven through a stand-in for the card's graph."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.cache_pool import CachePool as JCachePool  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.serve import (CachePool, ContinuousBatchingEngine,  # noqa: E402
                               Request, ServeEngine)
from torch_serve_common import (MLA_MP, MP_ASSIGNMENT, _drain, _oneshot,  # noqa: E402
                                _pair, _scenario, assert_agree)

DENSE_COUNTERS = ("prefill_chunks", "prefill_tokens", "decode_stall_steps",
                  "max_decode_stall_run", "blocked_admissions", "preemptions",
                  "peak_live_tokens", "peak_slots_in_use", "dense_kv_bytes",
                  "peak_kv_bytes", "prefill_buckets", "distinct_prompt_lens")


def _dense(spec, **kw):
    """``spec``'s requests on a dense engine (``kw`` overrides; the paged
    pool's block size does not apply)."""
    ekw, reqs = spec
    ekw = {k: v for k, v in ekw.items() if k not in ("block_size",
                                                       "n_blocks")}
    return dict(ekw, paged=False, **kw), reqs


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# the pool and the ring against the reference's
# ---------------------------------------------------------------------------


def test_cache_pool_matches_reference_pool():
    jm, _, tm, _ = _pair("attn")
    jpool, tpool = JCachePool(jm, 3, 16), CachePool(tm, 3, 16, device="cpu")
    assert [jpool.alloc() for _ in range(3)] == [tpool.alloc()
                                                 for _ in range(3)]
    with pytest.raises(RuntimeError, match="exhausted"):
        tpool.alloc()
    for pool in (jpool, tpool):
        pool.free_slot(1)
        pool.free(0)
    assert tpool.n_free == tpool.n_free_slots == jpool.n_free_slots == 2
    assert tpool.alloc() == jpool.alloc() == 0
    with pytest.raises(ValueError):
        tpool.free(2 + 1)
    # insert overwrites a whole slot, its pos ring included
    rng = np.random.default_rng(0)
    one = {}
    for layer, leaves in tpool.caches.items():
        one[layer] = {leaf: rng.integers(-1, 16, size=(1,) + t.shape[1:])
                      if leaf == "pos" else rng.normal(
                          size=(1,) + t.shape[1:]).astype(np.float32)
                      for leaf, t in leaves.items()}
    tpool.insert(1, {layer: {leaf: torch.from_numpy(a).to(
        tpool.caches[layer][leaf].dtype) for leaf, a in d.items()}
        for layer, d in one.items()})
    jpool.insert(1, {layer: {leaf: jnp.asarray(a).astype(
        jpool.caches[layer][leaf].dtype) for leaf, a in d.items()}
        for layer, d in one.items()})
    for layer, leaves in tpool.caches.items():
        for leaf, t in leaves.items():
            np.testing.assert_array_equal(_np(t), _np(jpool.caches[layer][leaf]),
                                          err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("chunk_extra", [0, 8])
def test_windowed_ring_widths_match_reference(chunk_extra):
    jm = jget("llama3_1b", smoke=True, sliding_window=12)
    tm = get_model("llama3_1b", smoke=True, sliding_window=12)
    want = {k: v.shape for k, v in flatten_paths(JCachePool(
        jm, 2, 40, chunk_extra=chunk_extra).caches).items()}
    got = {k: tuple(v.shape) for k, v in flatten_paths(CachePool(
        tm, 2, 40, chunk_extra=chunk_extra, device="cpu").caches).items()}
    assert got == want
    assert got["layers/0/k"][1] == 12 + chunk_extra


@pytest.mark.parametrize("W", [12, 20])
def test_ring_chunk_write_and_gather_match_reference(W):
    """A ring of W rows (a window of 12, alone or widened by chunks of 8),
    written chunk by chunk (rows starting at 0, continuing, and inactive)
    and gathered into logical order after each chunk, bit for bit."""
    rng = np.random.default_rng(W)
    B, T, H, D = 3, 8, 2, 4
    jc = {"k": jnp.zeros((B, W, H, D)), "v": jnp.zeros((B, W, H, D)),
          "pos": jnp.full((B, W), -1, jnp.int32)}
    tc = {"k": torch.zeros((B, W, H, D)), "v": torch.zeros((B, W, H, D)),
          "pos": torch.full((B, W), -1, dtype=torch.int32)}
    done = np.zeros(B, np.int32)
    for step in range(5):
        valid = np.array([T, 5 if step % 2 else T, 0 if step == 2 else 3],
                         np.int32)
        start = np.where(valid > 0, done, 1).astype(np.int32)
        pos = start[:, None] + np.arange(T, dtype=np.int32)[None]
        cv = np.arange(T)[None] < valid[:, None]
        kv = {n: rng.normal(size=(B, T, H, D)).astype(np.float32)
              for n in ("k", "v")}
        jc = JL._cache_write_chunk(jc, {n: jnp.asarray(a) for n, a in
                                        kv.items()}, jnp.asarray(pos),
                                   jnp.asarray(cv), jnp.asarray(start))
        TL._cache_write_chunk(tc, {n: torch.from_numpy(a) for n, a in
                                   kv.items()}, torch.from_numpy(pos),
                              torch.from_numpy(cv), torch.from_numpy(start))
        for n in ("k", "v", "pos"):
            np.testing.assert_array_equal(_np(tc[n]), _np(jc[n]))
        jg, jkp = JL._ring_logical_gather(jc, ("k", "v"), jnp.float32,
                                          jnp.asarray(start), jnp.asarray(cv))
        tg, tkp = TL._ring_logical_gather(tc, ("k", "v"), torch.float32,
                                          torch.from_numpy(start),
                                          torch.from_numpy(cv))
        np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
        for n in ("k", "v"):
            np.testing.assert_array_equal(tg[n].numpy(), np.asarray(jg[n]))
        done = np.where(valid > 0, start + valid, done)


def test_windowed_dense_chunks_match_oneshot():
    """The reference's regression on a windowed ring (window 12, chunks of
    8, 24-token prompts: the third chunk's window straddles a chunk
    boundary): dense chunked tokens are the one-shot engine's, bit for bit
    in the port and up to a near-tie against the reference's one-shot."""
    jm = jget("llama3_1b", smoke=True, sliding_window=12)
    jp = jm.init(jax.random.key(1))
    tm = get_model("llama3_1b", smoke=True, sliding_window=12)
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    rng = np.random.default_rng(9)
    ps = [rng.integers(0, 500, size=24).astype(np.int32) for _ in range(2)]
    one = JServeEngine(jm, donate=False)
    want = [np.asarray(one.generate(jp, {"tokens": jnp.asarray(p)[None]},
                                    max_new_tokens=4).tokens)[0] for p in ps]
    ref = _oneshot(tm, tp, ps, 4)
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_len=40, paged=False,
                                   chunk_len=8, device="cpu")
    summ = eng.serve(tp, [Request(rid=i, tokens=p, max_new_tokens=4)
                          for i, p in enumerate(ps)])
    assert summ.counters["prefill_chunks"] == 3
    for i, (tok, gaps) in enumerate(ref):
        np.testing.assert_array_equal(summ.tokens_for(i), tok)
        assert_agree(want[i], tok, gaps)


# ---------------------------------------------------------------------------
# the dense engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("arch", ["attn", "mla"])
def test_dense_equals_paged_and_chunked_equals_oneshot(arch, mp):
    """The chunked scenario (prompts of 5 to 29 tokens arriving while
    others decode) on the paged engine, the dense engine (one bucketed
    chunk a prompt) and the dense engine in chunks of 8: every request's
    tokens bit-equal across the three and to the one-shot engine's."""
    _, _, tm, tp = _pair(arch)
    plan = (MLA_MP if arch == "mla" else MP_ASSIGNMENT) if mp else None
    spec = _scenario("chunked")
    paged = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                   device="cpu", mp=plan)
    dense = _drain(ContinuousBatchingEngine, Request, tm, tp,
                   _dense(spec, chunk_len=None), device="cpu", mp=plan)
    chunked = _drain(ContinuousBatchingEngine, Request, tm, tp, _dense(spec),
                     device="cpu", mp=plan)
    assert chunked.counters["prefill_chunks"] == paged.counters[
        "prefill_chunks"] > dense.counters["prefill_chunks"]
    assert chunked.counters["decode_stall_steps"] > 0
    assert not dense.counters["paged"] and "paged_attn" not in \
        dense.counters
    ref = _oneshot(tm, tp, [p for _, p, *_ in spec[1]], spec[1][0][2],
                   mp=plan)
    for rid, (tok, _) in enumerate(ref):
        for out in (paged, dense, chunked):
            assert out.results[rid].status == "ok"
            np.testing.assert_array_equal(out.tokens_for(rid), tok)


@pytest.mark.parametrize("chunk_len", [None, 8], ids=["bucketed", "chunked"])
def test_dense_engine_counters_match_reference(chunk_len):
    """The dense engine and the reference's (``paged=False``, lockstep) on
    the same requests and weights: equal schedule and KV-bytes counters
    and decode steps. Bucketed, the tokens agree with the port's one-shot
    engine (bit for bit in the port, up to a near-tie in the reference)."""
    jm, jp, tm, tp = _pair("attn")
    spec = _dense(_scenario("chunked"), chunk_len=chunk_len)
    want = _drain(JEngine, JRequest, jm, jp, spec)
    got = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                 device="cpu")
    for key in DENSE_COUNTERS:
        assert got.counters[key] == want.counters[key], key
    assert got.n_steps == want.n_steps
    assert got.counters["peak_kv_bytes"] == got.counters["dense_kv_bytes"]
    if chunk_len is None:
        ref = _oneshot(tm, tp, [p for _, p, *_ in spec[1]], 4)
        for rid, (tok, gaps) in enumerate(ref):
            np.testing.assert_array_equal(got.tokens_for(rid), tok)
            assert_agree(np.asarray(want.tokens_for(rid)), tok, gaps)


def test_caveat_reference_dense_chunks_lose_position_zero():
    """In the reference's dense engine a row between two chunks of its
    prompt is decoded as a vacant row, at position 0 of its own ring: the
    garbage K/V replaces its prompt's first token, and its later chunks
    attend to it. The port decodes such a row at the position its next
    chunk writes first (the reference's intent: vacant-row writes never
    reach a request), so its tokens stay the one-shot ones where the
    reference's leave them."""
    jm, jp, tm, tp = _pair("attn")
    spec = _dense(_scenario("chunked"))
    want = _drain(JEngine, JRequest, jm, jp, spec)
    got = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                 device="cpu")
    ref = _oneshot(tm, tp, [p for _, p, *_ in spec[1]], 4)
    lost = [rid for rid, (tok, gaps) in enumerate(ref)
            if not np.array_equal(want.tokens_for(rid), tok)]
    assert lost
    for rid, (tok, _) in enumerate(ref):
        np.testing.assert_array_equal(got.tokens_for(rid), tok)


def test_prefill_cobatch_false_matches_reference():
    """Three prompts of three buckets arriving at once: co-batched, one
    prefill step; ``prefill_cobatch=False``, one step per bucket group, as
    the reference counts them; the same tokens either way."""
    jm, jp, tm, tp = _pair("attn")
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, 200, size=n).astype(np.int32), 3, 0, 0)
            for i, n in enumerate((5, 13, 29))]
    spec = (dict(n_slots=3, max_len=40, block_size=4), reqs)
    want = _drain(JEngine, JRequest, jm, jp, spec, prefill_cobatch=False)
    legacy = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                    device="cpu", prefill_cobatch=False)
    cobatch = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                     device="cpu")
    assert legacy.counters["prefill_chunks"] == want.counters[
        "prefill_chunks"] == 3
    assert cobatch.counters["prefill_chunks"] == 1
    assert not legacy.counters["prefill_cobatch"]
    assert legacy.counters["prefill_buckets"] == want.counters[
        "prefill_buckets"] == 3
    ref = _oneshot(tm, tp, [p for _, p, *_ in reqs], 3)
    for rid, (tok, gaps) in enumerate(ref):
        np.testing.assert_array_equal(legacy.tokens_for(rid), tok)
        np.testing.assert_array_equal(cobatch.tokens_for(rid), tok)
        assert_agree(np.asarray(want.tokens_for(rid)), tok, gaps)


def test_dense_engine_refusals_and_pool_reuse():
    _, _, tm, tp = _pair("attn")
    for kw, match in (({"n_blocks": 8}, "n_blocks"),
                      ({"paged_attn": "gather"}, "paged_attn"),
                      ({"prefix_cache": True}, "prefix_cache")):
        with pytest.raises(ValueError, match=match):
            ContinuousBatchingEngine(tm, paged=False, device="cpu", **kw)
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_len=24, paged=False,
                                   preemption=True, device="cpu")
    assert not eng.preemption and not eng.prefix_cache
    reqs = [Request(rid=i, tokens=np.arange(10, dtype=np.int32) + i,
                    max_new_tokens=3, arrival=i) for i in range(3)]
    first = eng.serve(tp, reqs)
    pool = eng._pool
    leaves = [t for d in pool.caches.values() for t in d.values()]
    again = eng.serve(tp, reqs, sync=True)
    assert eng._pool is pool and all(a is b for a, b in zip(
        (t for d in pool.caches.values() for t in d.values()), leaves))
    for rid in first.results:
        np.testing.assert_array_equal(again.tokens_for(rid),
                                      first.tokens_for(rid))


def test_launcher_serves_dense_slots(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--continuous", "--dense-slots",
          "--requests", "3", "--prompt-len", "13", "--chunk-len", "8",
          "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "dense KV slots" in out and "6 chunk steps" in out
    main(["--smoke", "--device", "cpu", "--continuous", "--requests", "3",
          "--prompt-len", "10", "--new-tokens", "4"])
    assert "vs dense" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="dense-slots"):
        main(["--smoke", "--device", "cpu", "--continuous", "--dense-slots",
              "--n-blocks", "9"])


# ---------------------------------------------------------------------------
# the one-shot engine's API
# ---------------------------------------------------------------------------


def test_serve_engine_api_matches_reference():
    """``init_caches``: the reference's shapes, dtypes and fill;
    ``ttft``: ``n_warmup + n_iters`` prefills, the median of the timed
    ones, as the reference times; ``tokens_for``: a request's tokens."""
    jm, jp, tm, tp = _pair("attn")
    jeng, teng = JServeEngine(jm, donate=False), ServeEngine(tm, device="cpu")
    want = flatten_paths(jeng.init_caches(2, 24))
    got = flatten_paths(teng.init_caches(2, 24))
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        np.testing.assert_array_equal(_np(t), _np(want[k]))
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(2, 12)}
    calls = {}
    for name, eng in (("ref", jeng), ("port", teng)):
        prefill, calls[name] = eng._prefill, []

        def counted(*a, prefill=prefill, seen=calls[name]):
            seen.append(1)
            return prefill(*a)
        eng._prefill = counted
    assert jeng.ttft(jp, {"tokens": jnp.asarray(batch["tokens"])}, 24,
                     n_iters=3, n_warmup=1) > 0
    assert teng.ttft(tp, batch, 24, n_iters=3, n_warmup=1) > 0
    assert len(calls["port"]) == len(calls["ref"]) == 4
    assert teng.prefill_compile_keys == jeng.prefill_compile_keys == {16}
    # the kept caches are reset between calls: generate after ttft gives
    # the tokens of a fresh engine
    again = teng.generate(tp, batch, max_new_tokens=4).tokens
    fresh = ServeEngine(tm, device="cpu").generate(tp, batch,
                                                   max_new_tokens=4).tokens
    np.testing.assert_array_equal(again, fresh)
    summ = ContinuousBatchingEngine(tm, n_slots=2, max_len=24,
                                    device="cpu").serve(
        tp, [Request(rid=7, tokens=batch["tokens"][0], max_new_tokens=4)])
    np.testing.assert_array_equal(summ.tokens_for(7), fresh[0])


# ---------------------------------------------------------------------------
# the graphed step
# ---------------------------------------------------------------------------


def test_every_step_kind_is_graphed_and_eager_on_the_cpu():
    _, _, tm, tp = _pair("attn")
    kinds = ("prefill", "bucketed_prefill", "chunked_prefill",
             "dense_chunked_prefill", "decode", "paged_decode")
    for kind in kinds:
        step = tsteps.get_serving_step(tm, kind)
        assert isinstance(step, tsteps.GraphedStep) and step.kind == kind
        assert step.max_captures == (1 if kind == "prefill" else None)
        assert tsteps.get_serving_step(tm, kind) is step
    caches = tm.init_cache(2, 16, "cpu")
    tok = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    step = tsteps.get_serving_step(tm, "bucketed_prefill")
    args = (tok, torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 8, dtype=torch.int32))
    logits, _, nxt = step(tp, caches, *args)
    want, _, want_nxt = tsteps.make_bucketed_prefill_step(tm)(
        tp, tm.init_cache(2, 16, "cpu"), *args)
    assert torch.equal(logits, want) and torch.equal(nxt, want_nxt)
    assert step.captures == step.replays == 0 and not step._table


class _Graph:
    """Stands in for a captured CUDA graph: a replay runs the step over the
    capture's static inputs into its static outputs."""

    def __init__(self, fn, params, caches, static, outs):
        self.fn, self.args, self.outs = fn, (params, caches) + static, outs

    def replay(self):
        n = tpa.launches                   # a replay runs no Python
        logits, _, nxt = self.fn(*self.args)
        tpa.launches = n
        self.outs[0].copy_(logits)
        self.outs[1].copy_(nxt)

    def pool(self):
        return ("pool of", id(self))


class _Cardless(tsteps.GraphedStep):
    """The graphed step's bookkeeping with the capture swapped for
    ``_Graph``: every input counts as on the card."""

    def __init__(self, fn, **kw):
        super().__init__(fn, kind="fake", **kw)
        self.pools = []

    @staticmethod
    def _on_card(inputs):
        return True

    def _warm_up(self, params, caches, inputs):
        return self.fn(params, caches, *inputs)

    def _record(self, params, caches, static, pool):
        self.pools.append(pool)
        logits, _, nxt = self.fn(params, caches, *static)
        return _Graph(self.fn, params, caches, static, (logits, nxt)), \
            logits, nxt


def test_capture_table_is_keyed_by_input_shape():
    """One capture per input shape, replays after; other caches drop the
    table and a rebound weight its graph; captures share one pool; a view
    is copied into a static input of its own; launches are counted once
    per run (the capture's subtracted, each replay's added)."""
    calls = []

    def fn(params, caches, tok, scale):
        calls.append(tuple(tok.shape))
        tpa.launches += 2
        logits = (tok.float() * params["w"] * scale)[:, None, :]
        return logits, caches, tsteps.greedy_next_token(logits)

    step = _Cardless(fn)
    params, caches = {"w": torch.tensor(2.0)}, {}
    one = torch.ones(())
    caps0 = tsteps.graph_captures["fake"]
    n0 = tpa.launches
    a = torch.tensor([[1, 5, 2], [7, 0, 1]], dtype=torch.int32)
    logits, _, nxt = step(params, caches, a, one)
    assert step.captures == 1 and len(calls) == 2        # warm-up, capture
    assert nxt.tolist() == [1, 0] and tpa.launches - n0 == 2
    b = torch.tensor([[0, 0, 9], [3, 8, 1]], dtype=torch.int32)
    logits2, _, nxt2 = step(params, caches, b, one)
    assert step.replays == 1 and step.captures == 1
    assert nxt2.tolist() == [2, 1] and tpa.launches - n0 == 4
    assert torch.equal(logits2, 2.0 * b.float()[:, None, :])
    # the capture's tensors are its static inputs: b was copied into a
    assert torch.equal(a, b)
    assert logits2 is step._table[next(iter(step._table))].logits
    # another bucket, first seen through a view (of another step's output,
    # say): its own capture, in the first one's pool, over a buffer of its
    # own
    big = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    view = big[:, 1:5]
    _, _, got = step(params, caches, view, one)
    assert step.captures == 2 and got.tolist() == [3, 3]
    cap = step._table[((2, 4), torch.int32, torch.device("cpu")),
                      ((), torch.float32, torch.device("cpu"))]
    assert cap.inputs[0] is not view and cap.inputs[0]._base is None
    assert step.pools[0] is None and step.pools[1] is not None
    step(params, caches, a, one)
    _, _, got = step(params, caches, torch.flip(view, (1,)), one)
    assert (step.captures, step.replays) == (2, 3)
    assert got.tolist() == [0, 0] and tpa.launches - n0 == 10
    # a weight rebound under the same dict: that graph is captured again
    params["w"] = torch.tensor(-1.0)
    _, _, got = step(params, caches, a, one)
    assert step.captures == 3 and got.tolist() == [0, 2]
    # other caches: the table goes, with its pool
    step(params, {}, a, one)
    assert step.captures == 4 and len(step._table) == 1
    assert step.pools[-1] is None
    assert tsteps.graph_captures["fake"] - caps0 == 4
    # at most one graph at a time
    wide = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    solo = _Cardless(fn, max_captures=1)
    solo(params, caches, a, one)
    solo(params, caches, wide, one)
    solo(params, caches, wide, one)
    assert (solo.captures, solo.replays, len(solo._table)) == (2, 1, 1)
    assert solo.pools == [None, None]


def test_failed_capture_raises_without_a_fallback():
    def fn(params, caches, tok):
        logits = tok.float()[:, None, :]
        return logits, caches, tsteps.greedy_next_token(logits)

    class Refuses(_Cardless):
        def _record(self, params, caches, static, pool):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    step = Refuses(fn)
    with pytest.raises(RuntimeError, match="fake step: CUDA graph capture "
                                           "failed"):
        step({}, {}, torch.ones((1, 2), dtype=torch.int32))
    assert step.captures == 0 and not step._table
