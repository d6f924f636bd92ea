"""The continuous engine's pipelined drain and its control plane (the port
of the drain tests of ``tests/test_serve.py``): the pipelined drain against
the lockstep one bit for bit (tokens, and the logits behind them on every
live row, with the prefix cache, preemption and chunked prefill), the
``on_token`` stream, ``cancel`` / ``shutdown`` / ``Request.timeout_steps``
(also against the reference engine on the same weights), a callback or a
read-back that raises, and the counters the reference reports.

On the CPU the consumer thread runs over CPU tensors with no events; every
product is an f32 sum over the same operands, so the port's continuous
engine gives the port's one-shot tokens exactly, and those are the
reference here (as in ``test_torch_serve.py``)."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.nn.spec import default_generator  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, Request,  # noqa: E402
                               ServeEngine)
from torch_serve_common import SCHEDULE_COUNTERS, _pair, _scenario  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return get_model("llama3_1b", smoke=True)


@pytest.fixture(scope="module")
def params(model):
    return model.init(default_generator(0, "cpu"), "cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, 500, size=12).astype(np.int32) for _ in range(4)]


def _oneshot(model, params, prompts, max_new) -> list:
    eng = ServeEngine(model, device="cpu")
    return [eng.generate(params, {"tokens": p[None]},
                         max_new_tokens=max_new).tokens[0] for p in prompts]


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _reqs(prompts, max_new, **kw):
    return [Request(rid=i, tokens=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(prompts)]


def _record_live_logits(eng) -> list:
    """Wrap the engine's steps so each call appends the logits of its live
    rows: a prefill row with valid tokens, a decode row with a block
    table."""
    rows = []

    def wrap(step, decode):
        def recorded(params, caches, *inputs):
            out = step(params, caches, *inputs)
            live = (inputs[2][:, 0] >= 0) if decode else (inputs[2] > 0)
            rows.append(out[0][live, -1].clone())
            return out
        return recorded

    eng.prefill_chunk_step = wrap(eng.prefill_chunk_step, False)
    eng.decode_step = wrap(eng.decode_step, True)
    return rows


# ---------------------------------------------------------------------------
# pipelined == lockstep
# ---------------------------------------------------------------------------


def test_seed_divergence_shape_regression(model, params):
    """Three 16-token prompts, four new tokens: cold and warm drains,
    pipelined and lockstep, give the one-shot tokens (a reused host buffer
    that a queued step still reads would corrupt the pipelined drain)."""
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, 500, size=16).astype(np.int32) for _ in range(3)]
    ref = _oneshot(model, params, ps, 4)
    for sync in (False, True):
        eng = _engine(model, n_slots=4, max_len=32, block_size=8)
        for drain in ("cold", "warm"):
            summ = eng.serve(params, _reqs(ps, 4), sync=sync)
            for i in range(3):
                np.testing.assert_array_equal(
                    summ.results[i].tokens, ref[i],
                    err_msg=f"sync={sync}/{drain}")


@pytest.mark.parametrize("max_in_flight", [1, 2, 8])
def test_pipelined_matches_lockstep_bitwise(model, params, prompts,
                                            max_in_flight):
    """The same device schedule in both drains: tokens bit-equal, and the
    counters say how each moved tokens to the host."""
    reqs = _reqs(prompts, 6)
    for r in reqs:
        r.arrival = r.rid
    eng = _engine(model, n_slots=2, max_len=32)
    s_sync = eng.serve(params, reqs, sync=True)
    s_async = eng.serve(params, reqs, max_in_flight=max_in_flight)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(s_async.results[i].tokens,
                                      s_sync.results[i].tokens)
    cs, ca = s_sync.counters, s_async.counters
    assert cs["sync"] and not ca["sync"]
    assert cs["readback_batch_max"] == 1
    assert cs["n_readbacks"] >= s_sync.n_steps
    assert cs["steps_in_flight_peak"] == 0
    assert ca["n_readbacks"] <= cs["n_readbacks"]
    assert 1 <= ca["readback_batch_max"] <= max_in_flight
    assert ca["steps_in_flight_peak"] <= max_in_flight
    assert ca["host_blocked_s"] >= 0.0 and ca["drain_wait_s"] >= 0.0
    assert s_async.n_steps == s_sync.n_steps
    assert s_async.decode_s > 0 and ca["wall_tokens_per_s"] > 0


@pytest.mark.parametrize("scenario", ["share", "preempt", "chunked"])
@pytest.mark.parametrize("arch", ["attn", "mla"])
def test_pipelined_matches_lockstep_with_features(arch, scenario):
    """With the prefix cache (forks included), a preemption and chunked
    prefill, on the smoke llama and DeepSeek's smoke dense prefix: the
    pipelined drain gives the lockstep drain's schedule, tokens and the
    logits of every live row of every step, bit for bit."""
    _, _, tm, tp = _pair(arch)
    ekw, spec = _scenario(scenario)
    out = {}
    for sync in (True, False):
        eng = _engine(tm, **ekw)
        rows = _record_live_logits(eng)
        reqs = [Request(rid=rid, tokens=p, max_new_tokens=m, arrival=a,
                        priority=pr) for rid, p, m, a, pr in spec]
        out[sync] = eng.serve(tp, reqs, sync=sync), rows
    (lock, lrows), (pipe, prows) = out[True], out[False]
    for key in SCHEDULE_COUNTERS:
        assert pipe.counters[key] == lock.counters[key], key
    assert pipe.n_steps == lock.n_steps
    assert lock.counters[{"share": "cow_forks", "preempt": "preemptions",
                          "chunked": "decode_stall_steps"}[scenario]] >= 1
    for rid, res in lock.results.items():
        np.testing.assert_array_equal(pipe.results[rid].tokens, res.tokens)
        assert pipe.results[rid].status == res.status == "ok"
    assert len(prows) == len(lrows)
    for a, b in zip(prows, lrows):
        assert torch.equal(a, b)


def test_pipelined_drain_under_a_short_switch_interval(model, params):
    """The producer and the consumer share each request's token list, the
    ring's free sets and the control set: with the interpreter switching
    threads every 10 us, a pipelined drain of more steps than ring sets,
    cancelling from the callback, still gives the lockstep drain's tokens
    for every request it did not cancel, and a prefix of them for the
    one it did."""
    import sys
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 500, size=int(n)).astype(np.int32)
          for n in rng.integers(4, 20, size=10)]
    reqs = [Request(rid=i, tokens=p, max_new_tokens=6, arrival=i)
            for i, p in enumerate(ps)]
    want = _engine(model, n_slots=3, max_len=32).serve(params, reqs,
                                                       sync=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng = _engine(model, n_slots=3, max_len=32)
        got = eng.serve(params, reqs, max_in_flight=2,
                        on_token=lambda rid, idx, tok: eng.cancel(9)
                        if rid == 8 and idx == 0 else None)
    finally:
        sys.setswitchinterval(interval)
    assert got.results[9].status == "cancelled"
    np.testing.assert_array_equal(
        got.results[9].tokens,
        want.results[9].tokens[:len(got.results[9].tokens)])
    for rid in range(9):
        assert got.results[rid].status == "ok"
        np.testing.assert_array_equal(got.results[rid].tokens,
                                      want.results[rid].tokens)


def test_on_token_stream_order_and_parity(model, params, prompts):
    """The pipelined ``on_token`` stream delivers each request's tokens in
    index order, equal to the lockstep drain's results; TTFT is stamped at
    delivery."""
    reqs = _reqs(prompts, 5)
    for r in reqs:
        r.arrival = r.rid
    eng = _engine(model, n_slots=2, max_len=32)
    ref = eng.serve(params, reqs, sync=True)
    events = {i: [] for i in range(len(prompts))}

    def on_token(rid, idx, tok):
        events[rid].append((idx, tok))

    summ = eng.serve(params, reqs, on_token=on_token)
    for i in range(len(prompts)):
        idxs = [e[0] for e in events[i]]
        assert idxs == list(range(len(idxs))), f"rid {i}: out of order"
        streamed = np.asarray([e[1] for e in events[i]], np.int32)
        np.testing.assert_array_equal(streamed, ref.results[i].tokens)
        np.testing.assert_array_equal(summ.results[i].tokens, streamed)
        assert summ.results[i].ttft_s > 0


# ---------------------------------------------------------------------------
# cancellation, timeouts, shutdown
# ---------------------------------------------------------------------------


def test_cancel_waiting_request(model, params, prompts):
    """A queued request leaves without device work; the running one is
    untouched."""
    ref = _oneshot(model, params, prompts[:2], 6)
    eng = _engine(model, n_slots=1, max_len=32)

    def on_token(rid, idx, tok):
        if rid == 0 and idx == 0:
            eng.cancel(1)        # rid 1 still waits for the only slot

    summ = eng.serve(params, _reqs(prompts[:2], 6), sync=True,
                     on_token=on_token)
    np.testing.assert_array_equal(summ.results[0].tokens, ref[0])
    assert summ.results[0].status == "ok"
    assert summ.results[1].status == "cancelled"
    assert len(summ.results[1].tokens) == 0
    assert summ.counters["n_cancelled"] == 1


def test_cancel_mid_decode_sync_deterministic(model, params, prompts):
    """Lockstep cancellation is step-deterministic: a cancel issued from the
    delivery of token 2 applies at the next tick, so the request keeps
    exactly 3 tokens, a prefix of the reference."""
    ref = _oneshot(model, params, prompts[:2], 6)
    eng = _engine(model, n_slots=2, max_len=32)

    def on_token(rid, idx, tok):
        if rid == 0 and idx == 2:
            eng.cancel(0)

    summ = eng.serve(params, _reqs(prompts[:2], 6), sync=True,
                     on_token=on_token)
    assert summ.results[0].status == "cancelled"
    np.testing.assert_array_equal(summ.results[0].tokens, ref[0][:3])
    assert summ.results[1].status == "ok"
    np.testing.assert_array_equal(summ.results[1].tokens, ref[1])
    assert summ.counters["n_cancelled"] == 1


def test_cancel_mid_decode_async_prefix(model, params, prompts):
    """Pipelined cancellation lands within the pipeline's depth: the
    request keeps a prefix of the reference, the other is untouched
    (``max_in_flight=2`` bounds the run-ahead at about 6 tokens of 14)."""
    ref = _oneshot(model, params, prompts[:2], 14)
    eng = _engine(model, n_slots=2, max_len=32)

    def on_token(rid, idx, tok):
        if rid == 0 and idx == 1:
            eng.cancel(0)

    summ = eng.serve(params, _reqs(prompts[:2], 14), on_token=on_token,
                     max_in_flight=2)
    r0 = summ.results[0]
    assert r0.status == "cancelled"
    assert 1 <= len(r0.tokens) <= 8
    np.testing.assert_array_equal(r0.tokens, ref[0][:len(r0.tokens)])
    np.testing.assert_array_equal(summ.results[1].tokens, ref[1])
    assert summ.results[1].status == "ok"


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_cancel_mid_prefill_frees_blocks(model, params, prompts, sync):
    """A request cancelled part way through its chunked prefill frees its
    slot and every block it took; the decoding request keeps its tokens."""
    rng = np.random.default_rng(13)
    long_p = rng.integers(0, 500, size=40).astype(np.int32)
    ref = _oneshot(model, params, [prompts[0]], 8)
    eng = _engine(model, n_slots=2, max_len=64, block_size=8, chunk_len=8,
                  chunk_budget=1, prefix_cache=False)
    cancelled = []

    def on_token(rid, idx, tok):
        if rid == 0 and idx == 2:
            cancelled.append(eng._pool.n_free_blocks)
            eng.cancel(1)        # rid 1 is a chunk into its 5-chunk prompt

    summ = eng.serve(
        params, [Request(rid=0, tokens=prompts[0], max_new_tokens=8),
                 Request(rid=1, tokens=long_p, max_new_tokens=8, arrival=1)],
        sync=sync, on_token=on_token, max_in_flight=1)
    np.testing.assert_array_equal(summ.results[0].tokens, ref[0])
    assert summ.results[1].status == "cancelled"
    assert len(summ.results[1].tokens) == 0      # never finished prefill
    assert summ.counters["free_blocks_final"] == \
        summ.counters["n_blocks"] - 1
    assert eng._pool.check_consistency()["ok"]


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_timeout_steps_deterministic(model, params, prompts, sync):
    """``timeout_steps`` runs on the engine clock: arrival 0 with timeout 2
    retires at tick 2 with exactly 3 tokens (prefill and two decode steps)
    in either drain."""
    ref = _oneshot(model, params, prompts[:2], 6)
    eng = _engine(model, n_slots=2, max_len=32)
    summ = eng.serve(
        params, [Request(rid=0, tokens=prompts[0], max_new_tokens=6,
                         timeout_steps=2),
                 Request(rid=1, tokens=prompts[1], max_new_tokens=6)],
        sync=sync)
    assert summ.results[0].status == "timeout"
    np.testing.assert_array_equal(summ.results[0].tokens, ref[0][:3])
    assert summ.results[0].finished_step == 2
    assert summ.results[1].status == "ok"
    np.testing.assert_array_equal(summ.results[1].tokens, ref[1])
    assert summ.counters["n_cancelled"] == 1


def test_timeout_steps_match_reference_engine():
    """The same requests, some with ``timeout_steps`` (one times out while
    it waits for a slot, one mid-decode, one has time to finish), through
    the reference engine's lockstep drain and the port's two drains on the
    same float32 weights: equal statuses, tokens and finishing ticks. (In
    bf16 the smoke model's logits, all below 1, tie exactly often enough —
    0.5390625 twice for one of these prompts — that the reference's
    compiled steps and its op-by-op ones, which the port follows, break a
    tie apart; ``test_torch_model.py`` holds the bf16 tokens.)"""
    import jax
    from repro.models.registry import get_model as jget
    from repro.nn.spec import flatten_paths
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.bridge import params_from_flat
    jm = jget("llama3_1b", smoke=True, dtype="float32")
    jp = jm.init(jax.random.key(0))
    tm = get_model("llama3_1b", smoke=True, dtype="float32")
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, 200, size=12).astype(np.int32) for _ in range(4)]
    spec = [(0, 6, 0, 3), (1, 6, 0, None), (2, 6, 1, 2), (3, 4, 2, 20)]

    want = JEngine(jm, n_slots=2, max_len=32, block_size=4).serve(
        jp, [JRequest(rid=rid, tokens=ps[rid], max_new_tokens=m, arrival=a,
                      timeout_steps=t) for rid, m, a, t in spec], sync=True)
    assert sorted(r.status for r in want.results.values()) == [
        "ok", "ok", "timeout", "timeout"]
    for sync in (True, False):
        got = _engine(tm, n_slots=2, max_len=32, block_size=4).serve(
            tp, [Request(rid=rid, tokens=ps[rid], max_new_tokens=m,
                         arrival=a, timeout_steps=t)
                 for rid, m, a, t in spec], sync=sync)
        for rid, w in want.results.items():
            g = got.results[rid]
            assert g.status == w.status, (sync, rid)
            assert g.finished_step == w.finished_step, (sync, rid)
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens),
                                          err_msg=f"sync={sync} rid={rid}")
        assert got.counters["n_cancelled"] == want.counters["n_cancelled"]


def test_shutdown_drains_partial_results(model, params, prompts):
    """``shutdown`` from a callback cancels everything unfinished at the
    next tick and returns partial results, each a prefix of the
    reference."""
    ref = _oneshot(model, params, prompts, 6)
    eng = _engine(model, n_slots=4, max_len=32)

    def on_token(rid, idx, tok):
        if rid == 0 and idx == 1:
            eng.shutdown()

    summ = eng.serve(params, _reqs(prompts, 6), sync=True, on_token=on_token)
    assert set(summ.results) == set(range(len(prompts)))
    assert summ.counters["n_cancelled"] == len(prompts)
    for i in range(len(prompts)):
        r = summ.results[i]
        assert r.status == "cancelled"
        np.testing.assert_array_equal(r.tokens, ref[i][:len(r.tokens)])
        assert len(r.tokens) >= 1            # prefill had landed


def _books_settled(eng):
    pool = eng._pool
    rep = pool.check_consistency()
    assert rep["ok"], rep
    mat = [int(x) for s in range(pool.n_slots)
           for x in pool.block_tables[s] if x >= 0]
    assert Counter(mat) == pool._ref


@pytest.mark.parametrize("sync", [False, True])
def test_on_token_error_cancels_and_reraises(model, params, prompts, sync):
    """A callback that raises is a shutdown in both drains: what is in
    flight is delivered (no producer deadlock), the error re-raises from
    ``serve``, the pool's books are settled, and the engine serves
    again."""
    eng = _engine(model, n_slots=2, max_len=32)

    def on_token(rid, idx, tok):
        if idx == 1:
            raise RuntimeError("client went away")

    reqs = _reqs(prompts[:2], 6)
    with pytest.raises(RuntimeError, match="client went away"):
        eng.serve(params, reqs, sync=sync, on_token=on_token)
    _books_settled(eng)
    ref = _oneshot(model, params, prompts[:2], 6)
    summ = eng.serve(params, reqs)
    for i in range(2):
        np.testing.assert_array_equal(summ.results[i].tokens, ref[i])
        assert summ.results[i].status == "ok"


class _FailingReadBack:
    """A ring set's token buffer whose read-back raises."""

    def __init__(self, t):
        self.t = t

    def copy_(self, src, non_blocking=False):
        self.t.copy_(src)

    def numpy(self):
        raise RuntimeError("read-back failed")


def test_drain_after_a_raised_drain_starts_over_a_clean_pool(model, params,
                                                             prompts):
    """A read-back that fails on the consumer thread re-raises from
    ``serve`` after the drain (never a silent switch to the lockstep
    drain); the next drain finds settled books and serves the one-shot
    tokens, prefix hits included."""
    eng = _engine(model, n_slots=2, max_len=32, block_size=4)
    reqs = _reqs(prompts[:3], 5)
    first = eng.serve(params, reqs)
    ring = list(eng._ring)
    for h in eng._ring:
        h.tok = _FailingReadBack(h.tok)
    with pytest.raises(RuntimeError, match="read-back failed"):
        eng.serve(params, reqs)
    _books_settled(eng)
    assert eng._pool.n_free_slots == 2
    for h, old in zip(eng._ring, ring):
        h.tok = old.tok.t
    again = eng.serve(params, reqs)
    assert again.counters["prefix_hit_requests"] == 3
    ref = _oneshot(model, params, prompts[:3], 5)
    for i in range(3):
        np.testing.assert_array_equal(first.results[i].tokens, ref[i])
        np.testing.assert_array_equal(again.results[i].tokens, ref[i])


# the port's own counters: kernel launches, graph captures and replays (in
# all and by step kind), the step count and the TTFT median
PORT_ONLY = {"n_decode_steps", "kernel_launches", "mesh_kernel_launches",
             "graph_captures", "graph_replays", "graph_captures_by_kind",
             "graph_replays_by_kind", "ttft_p50_s"}


def test_counter_keys_are_the_references():
    """Every counter the port reports under the reference's name is one
    the reference reports, in both drains."""
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve.scheduler import Request as JRequest
    jm, jp, tm, tp = _pair("attn")
    ps = [np.arange(10, dtype=np.int32) + i for i in range(3)]
    want = JEngine(jm, n_slots=2, max_len=24, block_size=4).serve(
        jp, [JRequest(rid=i, tokens=p, max_new_tokens=3)
             for i, p in enumerate(ps)], sync=True).counters
    for sync in (True, False):
        got = _engine(tm, n_slots=2, max_len=24, block_size=4).serve(
            tp, [Request(rid=i, tokens=p, max_new_tokens=3)
                 for i, p in enumerate(ps)], sync=sync).counters
        assert set(got) - PORT_ONLY <= set(want), \
            set(got) - PORT_ONLY - set(want)
        for key in ("sync", "host_blocked_s", "drain_wait_s", "n_readbacks",
                    "readback_batch_mean", "steps_in_flight_peak",
                    "n_cancelled", "n_failed", "n_retried"):
            assert key in got, key
        assert got["n_failed"] == got["n_retried"] == 0


def test_launcher_takes_sync_engine(capsys):
    from repro_torch.launch.serve import main
    base = ["--smoke", "--device", "cpu", "--continuous", "--requests", "3",
            "--prompt-len", "10", "--new-tokens", "4"]
    main(base)
    assert "drain: pipelined" in capsys.readouterr().out
    main(base + ["--sync-engine"])
    out = capsys.readouterr().out
    assert "drain: lockstep" in out and "0 cancelled or timed out" in out
