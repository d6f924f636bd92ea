"""The serving steps replayed as CUDA graphs
(``repro_torch.launch.steps.GraphedStep``: decode once, prefill once per
bucket) against the same steps run eagerly, on the card: bit-equal logits
(of every live decode and prefill row) and tokens for llama3_1b at full
width and DeepSeek-V3's smoke dense prefix (absorbed MLA decode), fused and
gather, plain and under an MP plan; two drains in a row over different
params, and a weight changed in place, each against its eager drain; a
drain with copy-on-write forks and a preemption, captured once per step
kind and bucket, against its eager drain, and the forked blocks' parents
against a drain without forks; chunked, prefix-shared and preempted
drains, pipelined and lockstep, against their eager twins, one capture per
bucket and only replays in a second drain; the dense-ring engine and the
one-shot engine against their eager twins; the launch counters against
steps x layers; a failed capture (decode or prefill) raises; the weight
cache's operands against quantizing per call; the pipelined drain against
the lockstep one at 1, 2 and 8 steps in flight, a capture made while the
consumer thread and another thread wait on events, and the pinned host
sets reused only after the event behind their copies.

These tests need a CUDA device and skip without one. They import neither
``jax`` nor ``repro``, so they run on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_serve_graph_cuda.py

Equality is exact on the rows that serve a request: the graph replays the
kernels the eager step launches, on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.core.mpconfig import MPPlan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import quant_cast as qc  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.registry import (dense_prefix_overrides,  # noqa: E402
                                         get_model)
from repro_torch.nn.spec import default_generator  # noqa: E402
from repro_torch.quant import qops, weight_cache  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402

pytestmark = pytest.mark.gpu
DS = "deepseek_v3_671b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graph and the kernels "
                    "have no CPU mode")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


_MODELS: dict = {}


def _model(arch: str):
    if arch not in _MODELS:
        if arch == DS:
            m = get_model(DS, smoke=True, mla_absorb_decode=True,
                          **dense_prefix_overrides(DS, smoke=True))
        else:
            m = get_model(arch)
        _MODELS[arch] = m
    return _MODELS[arch]


def _params(model, seed=0):
    return model.init(default_generator(seed, "cuda"), "cuda")


def _plan(model) -> MPPlan:
    """fp8 on the linear ops of the second half of the layers and the last
    layer's BGEMMs (which then gathers)."""
    n = model.cfg.n_layers
    ops = ("attn/q_a_proj", "attn/q_b_proj", "attn/kv_a_proj",
           "attn/o_proj") if model.cfg.block_types[0] == "mla" else (
        "attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj")
    mp = {f"layers/{i}/{op}": "fp8_e4m3" for i in range(n // 2, n)
          for op in ops + ("mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")}
    mp[f"layers/{n - 1}/attn/qk_matmul"] = "fp8_e4m3"
    mp[f"layers/{n - 1}/attn/av_matmul"] = "fp8_e4m3"
    return MPPlan(assignment=mp, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)


def _eager_steps(eng) -> None:
    """The closures the engine's graphs capture, run eagerly."""
    m, mp = eng.model, eng.mp
    if eng.paged:
        eng.decode_step = tsteps.make_paged_decode_step(
            m, mp=mp, paged_attn=eng.paged_attn)
        eng.prefill_chunk_step = tsteps.make_chunked_prefill_step(m, mp=mp)
    else:
        eng.decode_step = tsteps.make_decode_step(m, mp=mp)
        eng.prefill_chunk_step = (
            tsteps.make_bucketed_prefill_step if eng.chunk_len is None
            else tsteps.make_dense_chunked_prefill_step)(m, mp=mp)


def _engine(model, mp, paged_attn, eager: bool, **kw):
    """A continuous engine whose steps record their live rows' logits (a
    prefill row with valid tokens, a paged decode row with a block table,
    every dense decode row); the prefix cache is off unless ``kw`` turns it
    on, so that a second drain of the same prompts prefills them again."""
    paged = kw.get("paged", True)
    kw = dict(dict(n_slots=4, max_len=48, block_size=16,
                   prefix_cache=False if paged else None), **kw)
    eng = ContinuousBatchingEngine(
        model, mp=mp, paged_attn=paged_attn if paged else None,
        device="cuda", **kw)
    if eager:
        _eager_steps(eng)
    logits = []

    def wrap(step, decode):
        def recorded(params, caches, *inputs):
            out = step(params, caches, *inputs)
            # the live rows' logits (a graph's outputs are overwritten by
            # the next replay); a vacant row decodes garbage whose K/V
            # writes all land in the trash block, where the last of several
            # writes to one slot wins in no fixed order, eager or graphed
            live = ((inputs[2][:, 0] >= 0) if decode and len(inputs) == 3
                    else (inputs[2] > 0) if not decode
                    else torch.ones_like(inputs[1], dtype=torch.bool))
            logits.append(out[0][live].clone())
            return out
        return recorded
    eng.decode_step = wrap(eng.decode_step, True)
    eng.prefill_chunk_step = wrap(eng.prefill_chunk_step, False)
    return eng, logits


def _one_per_bucket(eng, out) -> None:
    """A drain that captured: the decode step once, the prefill step once
    for each bucket the engine has run; every other call replayed."""
    c = out.counters
    decode = "paged_decode" if eng.paged else "decode"
    assert c["graph_captures_by_kind"] == {
        decode: 1, eng._prefill_kind: len(eng.prefill_compile_keys)}
    assert c["graph_replays_by_kind"].get(decode, 0) == out.n_steps - 1
    assert c["graph_replays_by_kind"].get(eng._prefill_kind, 0) == \
        c["prefill_chunks"] - len(eng.prefill_compile_keys)


def _replays_only(out) -> None:
    c = out.counters
    assert c["graph_captures"] == 0
    assert c["graph_replays"] == out.n_steps + c["prefill_chunks"]


def _drain(eng, logits, params, reqs):
    del logits[:]
    out = eng.serve(params, reqs)
    torch.cuda.synchronize()
    toks = {rid: r.tokens for rid, r in out.results.items()}
    return out, toks, torch.cat(logits)


def _reqs(model, n=6):
    return make_requests(model.cfg.vocab_size, n, 24, 8, 2)


@pytest.mark.parametrize("paged_attn", ["fused", "gather"])
@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("arch", ["llama3_1b", DS])
def test_graphed_drain_equals_eager_drain(cuda, arch, mp, paged_attn):
    model = _model(arch)
    params = _params(model)
    plan = _plan(model) if mp else None
    reqs = _reqs(model)
    eager, e_log = _engine(model, plan, paged_attn, eager=True)
    _, e_toks, e_logits = _drain(eager, e_log, params, reqs)
    graphed, g_log = _engine(model, plan, paged_attn, eager=False)
    out, g_toks, g_logits = _drain(graphed, g_log, params, reqs)
    _one_per_bucket(graphed, out)
    assert g_toks.keys() == e_toks.keys()
    for rid in e_toks:
        np.testing.assert_array_equal(g_toks[rid], e_toks[rid])
    assert torch.equal(g_logits, e_logits)
    # the next drain over the same params and pool replays only; the pool's
    # free slots now come in another order, as on the eager engine
    _, _, e_logits2 = _drain(eager, e_log, params, reqs)
    again, g_toks2, g_logits2 = _drain(graphed, g_log, params, reqs)
    _replays_only(again)
    assert torch.equal(g_logits2, e_logits2)


def test_drains_over_other_params_each_match_their_eager_drain(cuda):
    model = _model("llama3_1b")
    plan = _plan(model)
    reqs = _reqs(model, 4)
    # the eager engine drains what the graphed one does, in the same order,
    # so both pools hand out slots and blocks alike
    graphed, g_log = _engine(model, plan, "fused", eager=False)
    eager, e_log = _engine(model, plan, "fused", eager=True)
    for seed in (0, 1):
        params = _params(model, seed)
        _, _, want = _drain(eager, e_log, params, reqs)
        out, _, got = _drain(graphed, g_log, params, reqs)
        _one_per_bucket(graphed, out)
        assert torch.equal(got, want)
        del params
    # a weight changed in place: quantized again, captured again
    params = _params(model, 2)
    _drain(eager, e_log, params, reqs)
    _drain(graphed, g_log, params, reqs)
    w = params["layers"][str(model.cfg.n_layers - 1)]["mlp"]["up_proj"]["w"]
    w.mul_(1.5)
    out, _, got = _drain(graphed, g_log, params, reqs)
    _one_per_bucket(graphed, out)
    assert weight_cache.quantize_count(w, ("fake", "fp8_e4m3")) == 2
    _, _, want = _drain(eager, e_log, params, reqs)
    assert torch.equal(got, want)


def _fork_and_preempt_reqs(model):
    """r0 and r1 share a 32-token prompt (two blocks of 16): r1's tail
    chunk forks r0's second block. The pool holds r0's and r1's worst
    cases and no more, so r2 (priority 1, arriving at step 3) evicts r1,
    which resumes through its still-cached prefix."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(11)
    p0, p2 = (rng.integers(0, model.cfg.vocab_size, size=32).astype(np.int32)
              for _ in range(2))
    return [Request(rid=0, tokens=p0, max_new_tokens=16),
            Request(rid=1, tokens=p0, max_new_tokens=16, arrival=1),
            Request(rid=2, tokens=p2, max_new_tokens=16, arrival=3,
                    priority=1)]


@pytest.mark.parametrize("arch", ["llama3_1b", DS])
def test_forks_and_preemption_replay_one_graph(cuda, arch):
    model = _model(arch)
    params = _params(model)
    reqs = _fork_and_preempt_reqs(model)
    kw = dict(n_slots=2, max_len=48, n_blocks=6, prefix_cache=True)
    eager, e_log = _engine(model, None, "fused", eager=True, **kw)
    e_out, e_toks, e_logits = _drain(eager, e_log, params, reqs)
    graphed, g_log = _engine(model, None, "fused", eager=False, **kw)
    out, g_toks, g_logits = _drain(graphed, g_log, params, reqs)
    c = out.counters
    assert c["cow_forks"] >= 1 and c["preemptions"] >= 1
    assert c["prefix_hit_requests"] >= 2
    _one_per_bucket(graphed, out)
    for key in ("cow_forks", "preemptions", "prefix_hit_tokens"):
        assert e_out.counters[key] == c[key], key
    assert g_toks.keys() == e_toks.keys() == {0, 1, 2}
    for rid in e_toks:
        np.testing.assert_array_equal(g_toks[rid], e_toks[rid])
    assert torch.equal(g_logits, e_logits)
    # r0's prompt blocks hold what a drain of r0 alone leaves there
    pool = graphed._pool
    blocks = pool._match_blocks(pool.prefix_digests(reqs[0].tokens))
    assert len(blocks) == 2
    kept = {(layer, name): t[blocks].clone()
            for layer, d in pool.caches.items() for name, t in d.items()}
    # the next drain hits r0's and r2's prompts and replays only
    again, _, _ = _drain(graphed, g_log, params, reqs)
    assert again.counters["graph_captures_by_kind"].get("paged_decode",
                                                         0) == 0
    assert again.counters["prefix_hit_requests"] >= 3
    alone, a_log = _engine(model, None, "fused", eager=False, **kw)
    _drain(alone, a_log, params, reqs[:1])
    ref = alone._pool
    assert ref._match_blocks(ref.prefix_digests(reqs[0].tokens)) == blocks
    for (layer, name), t in kept.items():
        assert torch.equal(t, ref.caches[layer][name][blocks]), (layer, name)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
def test_launch_counters_count_replays(cuda, mp):
    """Launches = decode steps x fused layers, all through ``gqa_mma``:
    the warm-up's launches and each replay's, never the capture's."""
    model = _model("llama3_1b")
    params = _params(model)
    plan = _plan(model) if mp else None
    reqs = _reqs(model)
    eng, log = _engine(model, plan, "fused", eager=False)
    for _ in range(2):                     # capture, then replays only
        n0 = tpa.launches
        routes0 = dict(tpa.launches_by_route)
        out, _, _ = _drain(eng, log, params, reqs)
        n_fused = model.cfg.n_layers - (1 if mp else 0)
        assert tpa.launches - n0 == out.n_steps * n_fused
        assert out.counters["kernel_launches"] == out.n_steps * n_fused
        assert tpa.launches_by_route["gqa_mma"] - routes0["gqa_mma"] == \
            out.n_steps * n_fused


@pytest.mark.parametrize("kind", ["paged_decode", "chunked_prefill"])
def test_failed_capture_raises(cuda, kind):
    model = _model("llama3_1b")
    inner = tsteps.make_paged_decode_step(model) if kind == "paged_decode" \
        else tsteps.make_chunked_prefill_step(model)

    def refuses_capture(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return inner(*args)

    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=48,
                                   device="cuda")
    step = tsteps.GraphedStep(refuses_capture, kind)
    if kind == "paged_decode":
        eng.decode_step = step
    else:
        eng.prefill_chunk_step = step
    with pytest.raises(RuntimeError, match=f"{kind} step: CUDA graph "
                                           f"capture failed"):
        eng.serve(_params(model), _reqs(model, 2))
    assert step.captures == 0


def test_fp8_linear_cached_weight_equals_per_call(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(300, 2048, generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn(8192, 2048, generator=g,
                            device="cuda")).bfloat16()
    n0 = dict(qc.launches)
    first, again = kops.fp8_linear(x, w), kops.fp8_linear(x, w)
    assert qc.launches["amax"] - n0["amax"] == 3        # x twice, w once
    xq, sx = qc.quantize_fp8(kops._pad_to(x, 128))
    wq, sw = qc.quantize_fp8(kops._pad_to(w, 128))
    from repro_torch.kernels import fp8_matmul as mm
    want = mm.fp8_matmul(xq, wq, sx, sw)[:300, :8192]
    assert torch.equal(first, want) and torch.equal(again, want)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"])
def test_cached_weight_operand_equals_per_call_on_the_card(cuda, fmt):
    """The weight cache's dequant (one-byte codes widened to bf16, times the
    host scale) against per-call fake quant of the same weight, bitwise."""
    g = torch.Generator(device="cuda").manual_seed(1)
    w = (0.02 * torch.randn(8192, 2048, generator=g,
                            device="cuda")).bfloat16()
    want = qops._quantize_operand(w, fmt, "simulate", None, None)
    assert torch.equal(qops._weight_operand(w, fmt, None), want)
    assert torch.equal(qops._weight_operand(w, fmt, None), want)
    assert weight_cache.quantize_count(w, ("fake", fmt)) == 1


@pytest.mark.parametrize("lengths", [(160, 152, 144, 136), (16, 40, 100, 9)])
def test_mla_kernel_replayed_in_a_graph_equals_eager(cuda, lengths):
    """The MLA kernel (route ``mla_mma``, latents resident in shared
    memory at the serving cell: B 4, 128 heads on one latent head, 512 +
    64) replayed back to back in a CUDA graph, a bf16 GEMM between calls
    to leave other data in shared memory, gives its eager output bit for
    bit every time: each copy it reads has landed (a copy it never
    committed to a group once did not, only under replay)."""
    rng = np.random.default_rng(3)
    B, H, R, DR, bs, n_pages = 4, 128, 512, 64, 16, 10
    n_blocks = 1 + B * n_pages
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).astype(
        np.int32).reshape(B, n_pages)).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda()
    ckv, kr = randn(n_blocks, bs, 1, R).bfloat16(), randn(
        n_blocks, bs, 1, DR).bfloat16()
    q1, q2 = randn(B, 1, H, R), randn(B, 1, H, DR)
    a, b = randn(2048, 2048).bfloat16(), randn(2048, 2048).bfloat16()

    def call():
        return tpa.paged_decode_attention(
            q1, ckv, None, tables, lens, q2=q2, k2=kr,
            scale=1.0 / np.sqrt(192.0), scale_mode="mul",
            out_dtype=torch.float32)
    assert tpa.route(torch.float32, torch.bfloat16, False, DR, R, R,
                     False, n_pages, bs) == "mla_mma"
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        a @ b
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(8):
            outs.append(call())
            a @ b
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            assert torch.equal(o, want)


# ---------------------------------------------------------------------------
# the pipelined drain on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_in_flight", [1, 2, 8])
def test_pipelined_graphed_drain_equals_lockstep(cuda, max_in_flight):
    """llama3_1b at full width, fused, graphed: the pipelined drain and the
    lockstep one give the same tokens and the same live-row logits, bit
    for bit, and the pipelined drain ran ahead of its read-backs."""
    model = _model("llama3_1b")
    params = _params(model)
    reqs = _reqs(model, 8)
    drains = {}
    for sync in (True, False):
        eng, log = _engine(model, None, "fused", eager=False)
        eng.serve(params, reqs[:1], sync=sync)           # capture
        del log[:]
        out = eng.serve(params, reqs, sync=sync, max_in_flight=max_in_flight)
        torch.cuda.synchronize()
        _replays_only(out)
        drains[sync] = out, torch.cat(log)
    (lock, l_logits), (pipe, p_logits) = drains[True], drains[False]
    assert pipe.n_steps == lock.n_steps
    for rid, res in lock.results.items():
        np.testing.assert_array_equal(pipe.results[rid].tokens, res.tokens)
    assert torch.equal(p_logits, l_logits)
    c = pipe.counters
    assert not c["sync"] and 1 <= c["steps_in_flight_peak"] <= max_in_flight
    assert c["readback_batch_max"] <= max_in_flight


def test_capture_while_the_consumer_thread_runs(cuda):
    """A fresh engine's pipelined drain captures its decode graph while the
    consumer thread is alive, and another thread waits on and polls CUDA
    events all the while: the capture succeeds (captured in thread-local
    mode) and the drain equals a lockstep drain of an engine that captured
    alone."""
    import threading
    model = _model("llama3_1b")
    params = _params(model)
    reqs = _reqs(model, 6)
    ref_eng, ref_log = _engine(model, None, "fused", eager=False)
    want = ref_eng.serve(params, reqs, sync=True)
    torch.cuda.synchronize()
    stop = threading.Event()
    ev = torch.cuda.Event()
    ev.record()
    polls = []

    def poll():
        while not stop.is_set():
            ev.synchronize()
            polls.append(ev.query())

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        eng, log = _engine(model, None, "fused", eager=False)
        seen = []
        got = eng.serve(params, reqs,
                        on_token=lambda rid, idx, tok: seen.append(rid))
        torch.cuda.synchronize()
    finally:
        stop.set()
        poller.join()
    assert polls
    _one_per_bucket(eng, got)
    assert len(seen) == sum(len(r.tokens) for r in got.results.values())
    for rid, res in want.results.items():
        np.testing.assert_array_equal(got.results[rid].tokens, res.tokens)
    assert torch.equal(torch.cat(log), torch.cat(ref_log))


class _CheckedEvent:
    """A ring set's event that counts the times it is recorded again
    before its last recording completed (a set reused too early)."""

    def __init__(self, ev):
        self.ev, self.early, self.records = ev, 0, 0

    def record(self):
        self.early += not self.ev.query()
        self.records += 1
        self.ev.record()

    def synchronize(self):
        self.ev.synchronize()

    def query(self):
        return self.ev.query()


def test_pinned_sets_are_reused_only_after_their_event(cuda):
    """Two pinned sets (``max_in_flight=1``) behind 8 requests of 8 tokens
    and a slow consumer: the producer must wait for sets, never rewrites
    one before the event behind its copies completed, and the tokens equal
    the lockstep drain's."""
    import time
    model = _model("llama3_1b")
    params = _params(model)
    reqs = _reqs(model, 8)
    eng, _ = _engine(model, None, "fused", eager=False)
    want = eng.serve(params, reqs, sync=True)
    eng.serve(params, reqs[:1], max_in_flight=1)         # builds the sets
    for h in eng._ring:
        h.event = _CheckedEvent(h.event)
    got = eng.serve(params, reqs, max_in_flight=1,
                    on_token=lambda rid, idx, tok: time.sleep(1e-3))
    torch.cuda.synchronize()
    sets = eng._ring[:2]
    assert sum(h.event.records for h in sets) > got.n_steps > 2 * len(sets)
    assert sum(h.event.early for h in sets) == 0
    assert got.counters["host_blocked_s"] > 0
    for rid, res in want.results.items():
        np.testing.assert_array_equal(got.results[rid].tokens, res.tokens)


# ---------------------------------------------------------------------------
# prefill graphs: one per bucket, every engine
# ---------------------------------------------------------------------------


def _chunked_reqs(model):
    """Three requests decode while a 100-token prompt arrives in chunks of
    32 (its last chunk 4 tokens: buckets 32 and 8), plus prompts of 24 and
    40 tokens (buckets 32, and 32 then 8)."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(12)
    lens = (24, 40, 24, 100)
    return [Request(rid=i, tokens=rng.integers(
                0, model.cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=12, arrival=(0, 0, 1, 4)[i])
            for i, n in enumerate(lens)]


_DRAINS = {
    "chunked": (_chunked_reqs, dict(n_slots=4, max_len=128, chunk_len=32)),
    "shared_preempted": (_fork_and_preempt_reqs,
                         dict(n_slots=2, max_len=48, n_blocks=6,
                              prefix_cache=True)),
}


@pytest.mark.parametrize("sync", [False, True], ids=["pipelined",
                                                     "lockstep"])
@pytest.mark.parametrize("drain", sorted(_DRAINS))
def test_graphed_prefill_equals_eager_prefill(cuda, drain, sync):
    """Every prefill chunk and decode step replayed from its graph: the
    live rows' logits of both steps and the tokens equal the eager drain's
    bit for bit; the drain captures the decode step once and the prefill
    step once per bucket it ran, and a second drain (with the prefix index
    it left, for the shared prompts) only replays."""
    model = _model("llama3_1b")
    params = _params(model)
    make, kw = _DRAINS[drain]
    reqs = make(model)
    eager, e_log = _engine(model, None, "fused", eager=True, **kw)
    e_out = eager.serve(params, reqs, sync=sync)
    graphed, g_log = _engine(model, None, "fused", eager=False, **kw)
    out = graphed.serve(params, reqs, sync=sync)
    torch.cuda.synchronize()
    assert len(graphed.prefill_compile_keys) >= 2
    _one_per_bucket(graphed, out)
    for key in ("prefill_chunks", "cow_forks", "preemptions",
                "decode_stall_steps"):
        assert out.counters[key] == e_out.counters[key], key
    for rid, res in e_out.results.items():
        np.testing.assert_array_equal(out.tokens_for(rid), res.tokens)
    assert torch.equal(torch.cat(g_log), torch.cat(e_log))
    del e_log[:], g_log[:]
    seen = set(graphed.prefill_compile_keys)
    e_again = eager.serve(params, reqs, sync=sync)
    again = graphed.serve(params, reqs, sync=sync)
    torch.cuda.synchronize()
    # prefix hits may cut a prompt into a bucket the first drain never ran
    new = len(graphed.prefill_compile_keys) - len(seen)
    c = again.counters
    assert c["graph_captures_by_kind"].get("chunked_prefill", 0) == new
    assert c["graph_replays"] == again.n_steps + c["prefill_chunks"] - new
    for rid, res in e_again.results.items():
        np.testing.assert_array_equal(again.tokens_for(rid), res.tokens)
    assert torch.equal(torch.cat(g_log), torch.cat(e_log))


@pytest.mark.parametrize("chunk_len", [None, 16], ids=["bucketed",
                                                        "chunked"])
def test_dense_engine_graphed_equals_eager(cuda, chunk_len):
    """The dense-ring engine (``paged=False``), every step graphed, against
    its eager twin: tokens and every row's logits bit for bit, one capture
    per step kind and bucket, replays only in the next drain; dense against
    the paged engine up to the near-tie rule of the chunk paths."""
    model = _model("llama3_1b")
    params = _params(model)
    reqs = _chunked_reqs(model)
    kw = dict(paged=False, n_slots=4, max_len=128, chunk_len=chunk_len)
    eager, e_log = _engine(model, None, None, eager=True, **kw)
    e_out = eager.serve(params, reqs)
    graphed, g_log = _engine(model, None, None, eager=False, **kw)
    out = graphed.serve(params, reqs)
    torch.cuda.synchronize()
    _one_per_bucket(graphed, out)
    assert out.counters["kernel_launches"] == 0
    for rid, res in e_out.results.items():
        np.testing.assert_array_equal(out.tokens_for(rid), res.tokens)
    assert torch.equal(torch.cat(g_log), torch.cat(e_log))
    again = graphed.serve(params, reqs)
    torch.cuda.synchronize()
    _replays_only(again)
    for rid, res in out.results.items():
        np.testing.assert_array_equal(again.tokens_for(rid), res.tokens)


def test_serve_engine_graphed_equals_eager(cuda):
    """The one-shot engine with its bucketed prefill and dense decode
    graphed (the decode position read from the device, one graph for every
    position) against the same steps eager: tokens and logits bit for bit;
    a second batch of the same shape replays only; ``ttft`` times
    replays."""
    from repro_torch.serve import ServeEngine
    model = _model("llama3_1b")
    params = _params(model)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, model.cfg.vocab_size, size=(4, 40))}
    runs = {}
    for arm in ("eager", "graphed"):
        eng = ServeEngine(model, device="cuda")
        graphed = (eng.bucketed_prefill_step, eng.decode_step)
        if arm == "eager":
            eng.bucketed_prefill_step = tsteps.make_bucketed_prefill_step(
                model)
            eng.decode_step = tsteps.make_decode_step(model)
        logits = []
        for name in ("bucketed_prefill_step", "decode_step"):
            def recorded(*a, step=getattr(eng, name)):
                out = step(*a)
                logits.append(out[0].clone())
                return out
            setattr(eng, name, recorded)
        c0 = sum(g.captures for g in graphed)
        r0 = sum(g.replays for g in graphed)
        first = eng.generate(params, batch, max_new_tokens=10).tokens
        second = eng.generate(params, batch, max_new_tokens=10).tokens
        torch.cuda.synchronize()
        runs[arm] = (first, second, torch.cat(logits),
                     sum(g.captures for g in graphed) - c0,
                     sum(g.replays for g in graphed) - r0)
        if arm == "graphed":
            assert eng.ttft(params, batch, 50) > 0
    (e1, e2, e_logits, e_caps, _), (g1, g2, g_logits, caps, replays) = \
        runs["eager"], runs["graphed"]
    np.testing.assert_array_equal(g1, e1)
    np.testing.assert_array_equal(g2, e2)
    np.testing.assert_array_equal(g1, g2)
    assert torch.equal(g_logits, e_logits)
    assert (e_caps, caps, replays) == (0, 2, 2 * 10 - 2)


# ---------------------------------------------------------------------------
# serving robustness: faults, the shadow step and the gather fallback, all
# through graphs
# ---------------------------------------------------------------------------

FAULT_MATRIX = [
    ("step_exception", dict(step=2, phase="decode")),
    ("step_exception", dict(step=0, phase="prefill")),
    ("nan_page", dict(step=2, slot=0, page=0)),
    ("nan_logits", dict(step=2, slot=1)),
    ("alloc_failure", dict(step=1, slot=2)),
    ("consumer_error", dict(step=2, slot=3)),
    ("consumer_stall", dict(step=2, hang_s=0.001)),
    ("hung_step", dict(step=2, phase="decode", hang_s=0.001)),
]
_FAULT_ENGINE: dict = {}


def _warm_buckets(eng, params, longest: int) -> None:
    """The prefill step once at every bucket a prompt (a retried one
    included) of up to ``longest`` tokens can take, every row inactive."""
    from repro_torch.serve.engine import prefill_bucket
    n, b = eng.n_slots, eng.min_bucket
    top = prefill_bucket(longest, eng.chunk_len, eng.min_bucket)
    while b <= top:
        args = (torch.zeros((n, b), dtype=torch.int32),
                torch.ones(n, dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32),
                torch.full((n, eng._pool.max_blocks), -1, dtype=torch.int32))
        eng.prefill_chunk_step(params, eng._pool.caches,
                               *(a.cuda() for a in args))
        b *= 2


def _fault_engine():
    """One llama3_1b engine (fused, pipelined, its pool twice the cell),
    warmed at every bucket, with its fault-free drain of 4 requests
    arriving together."""
    if not _FAULT_ENGINE:
        model = _model("llama3_1b")
        params = _params(model)
        reqs = make_requests(model.cfg.vocab_size, 4, 24, 8, 0)
        eng = ContinuousBatchingEngine(
            model, paged_attn="fused", device="cuda", n_slots=4, max_len=32,
            block_size=16, n_blocks=1 + 2 * 4 * 2, prefix_cache=False)
        eng.serve(params, reqs[:1])
        _warm_buckets(eng, params, 32)
        base = eng.serve(params, reqs)
        torch.cuda.synchronize()
        _replays_only(base)
        _FAULT_ENGINE.update(eng=eng, params=params, reqs=reqs, base={
            rid: r.tokens for rid, r in base.results.items()})
    return _FAULT_ENGINE


@pytest.mark.parametrize("kind,kw", FAULT_MATRIX,
                         ids=[f"{k}-{kw.get('phase', 'any')}"
                              for k, kw in FAULT_MATRIX])
def test_fault_matrix_replays_graphs_only(cuda, kind, kw):
    """Each fault kind in the pipelined drain on the card: no capture and
    no eager step (every decode step and prefill chunk a replay), every
    request ends, a request no fault reached bit-equal to the fault-free
    drain (all four prefill in one chunk, and a retry prefills alone), a
    completed retry of the same length; a NaN page reaches its row's
    logits through the fused kernel and is quarantined."""
    from repro_torch.serve import FaultInjector, FaultSpec
    fx = _fault_engine()
    eng, params, reqs = fx["eng"], fx["params"], fx["reqs"]
    eng.faults = FaultInjector([FaultSpec(kind=kind, **kw)])
    try:
        out = eng.serve(params, reqs)
    finally:
        eng.faults = None
    torch.cuda.synchronize()
    _replays_only(out)
    f = out.counters["faults"]
    assert f["injected"] == {kind: 1}
    assert eng._pool.check_consistency()["ok"]
    for rid, res in out.results.items():
        want = fx["base"][rid]
        if res.status == "ok":
            np.testing.assert_array_equal(res.tokens, want)
        elif res.status == "retried":
            assert len(res.tokens) == len(want)
        else:
            assert res.status == "failed" and kind == "consumer_error"
            np.testing.assert_array_equal(res.tokens,
                                          want[:len(res.tokens)])
    if kind in ("nan_page", "nan_logits"):
        assert f["seen"].get("nonfinite_logits", 0) >= 1
        assert f["quarantined_blocks"] > 0
    assert not f["degraded_paged_attn"]


def test_shadow_and_gather_steps_capture_once(cuda):
    """Under a plan with a guardrail at every step, two hung steps degrade
    the drain to gather: the plan's fused and gather decode steps and the
    unquantized shadow of each are captured once, in that drain; the next
    drain (gather from the start) replays them only."""
    from repro_torch.serve import (FaultInjector, FaultSpec,
                                   NumericalGuardrail)
    model = _model("llama3_1b")
    params = _params(model)
    plan = _plan(model)
    reqs = make_requests(model.cfg.vocab_size, 4, 24, 8, 0)
    eng = ContinuousBatchingEngine(model, mp=plan, paged_attn="fused",
                                   device="cuda", n_slots=4, max_len=32,
                                   prefix_cache=False)
    steps = {(name, pa): tsteps.get_serving_step(model, "paged_decode",
                                                 mp=mp, paged_attn=pa)
             for name, mp in (("plan", plan), ("plain", None))
             for pa in ("fused", "gather")}
    caps0 = {k: s.captures for k, s in steps.items()}
    eng.faults = FaultInjector([FaultSpec("hung_step", step=1, hang_s=0.0),
                                FaultSpec("hung_step", step=2, hang_s=0.0)])
    eng.guardrail = NumericalGuardrail(every=1, budget=1e9)
    first = eng.serve(params, reqs)
    torch.cuda.synchronize()
    f, g = first.counters["faults"], first.counters["guardrail"]
    assert f["degraded_paged_attn"] and eng.paged_attn == "gather"
    assert g["checks"] == first.n_steps and g["breaches"] == 0
    assert {k: s.captures - caps0[k] for k, s in steps.items()} == \
        dict.fromkeys(steps, 1)
    assert first.counters["graph_captures_by_kind"]["paged_decode"] == 4
    eng.faults = None
    eng.guardrail = NumericalGuardrail(every=1, budget=1e9)
    again = eng.serve(params, reqs)
    torch.cuda.synchronize()
    c = again.counters
    assert c["graph_captures"] == 0
    assert c["graph_replays_by_kind"]["paged_decode"] == 2 * again.n_steps
    assert c["graph_replays"] == 2 * again.n_steps + c["prefill_chunks"]
    assert all(r.status == "ok" for r in again.results.values())


@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2", "bfloat16"])
def test_poisoned_block_stays_nan_on_the_card(cuda, kv):
    """``PagedCachePool.poison_block`` on CUDA caches: NaN in every K/V
    leaf of the block, fp8 included (not saturated to the format's
    largest value), nothing else touched."""
    from repro_torch.serve import PagedCachePool
    model = get_model("llama3_1b", smoke=True, kv_cache_dtype=kv)
    pool = PagedCachePool(model, n_slots=1, max_len=16, block_size=4,
                          n_blocks=6, device="cuda")
    pool.poison_block(3)
    for layer in pool.caches.values():
        for t in layer.values():
            assert torch.isnan(t[3].float()).all()
            assert (t[[1, 2, 4, 5]].float() == 0).all()


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
def test_graphed_forward_equals_eager(cuda, mp):
    """``launch.steps.GraphedForward``, the forward the measured tier
    times: its first call (eager warm-up, then the capture) and its
    replays give the logits of ``model.apply`` run eagerly, bit for bit;
    the capture adds nothing to the fp8 kernels' counters and each replay
    adds what it recorded, 1 amax + 1 scale_cast + 1 fp8_matmul per fp8
    linear op (the weights were quantized once, before)."""
    from repro_torch.kernels import fp8_matmul as mm
    model = _model("llama3_1b")
    params = _params(model)
    assign = ({"layers/3/mlp/up_proj": "fp8_e4m3", "lm_head": "fp8_e4m3",
               "layers/5/attn/qk_matmul": "fp8_e4m3"} if mp else {})
    n_fp8 = 2 if mp else 0
    ctx = qops.QuantContext(mode="mp", mp=assign, impl="kernel")
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 64), generator=g,
                           device="cuda", dtype=torch.int32)
    with torch.no_grad():
        want = model.apply(params, prompt, ctx)
    fwd = tsteps.GraphedForward(model, ctx)
    counts = []
    for _ in range(3):
        n0 = (qc.launches["amax"], qc.launches["scale_cast"], mm.launches)
        got = fwd(params, prompt)
        torch.cuda.synchronize()
        counts.append((qc.launches["amax"] - n0[0],
                       qc.launches["scale_cast"] - n0[1],
                       mm.launches - n0[2]))
        assert torch.equal(got, want)
    assert counts == [(n_fp8,) * 3] * 3
    assert (fwd.step.captures, fwd.step.replays) == (1, 2)
    rec = fwd.step.recorded()
    assert (rec["amax"], rec["scale_cast"], rec["fp8_matmul"]) == \
        (n_fp8,) * 3
    fwd.release()
    assert torch.equal(fwd(params, prompt), want)
    assert fwd.step.captures == 2
