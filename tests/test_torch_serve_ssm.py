"""Serving Mamba-2 and Hymba in the port: the continuous engine, paged and
dense, plain and chunked, against the reference's one-shot ``ServeEngine``
on the same float32 smoke weights (mirroring the reference's
``test_paged_parity_sliding_window_long_prompt`` and the mamba and hybrid
cases of ``test_chunked_bucketed_prefill_parity``), against the port's own
one-shot engine bit for bit under an MP plan, a preempted request against
its uninterrupted twin, the slot-major SSM state in the pools' accounting,
the engine's refusals (``prefix_cache`` and a ``chunk_len`` off the SSD
chunk) and the launcher.

On the CPU every path agrees on every token, so token equality is asserted
exactly; cross-framework runs use float32 weights (smoke bf16 logits tie
too often for a greedy comparison across frameworks)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn.mamba import SSMConfig  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.serve.cache_pool import paged_slot_bytes  # noqa: E402
from torch_serve_common import _drain, _scenario  # noqa: E402

SSM_ARCHS = ["mamba2_370m", "hymba_1p5b"]
CHUNK_LEN = 8
# the SSD chunk shrunk to the engine's chunk length, as the reference's
# chunked-prefill matrix does, so chunk boundaries align with the recurrence
SSM_CHUNKED = {
    "mamba2_370m": SSMConfig(d_model=128, d_inner=256, d_state=32,
                             head_dim=32, chunk=CHUNK_LEN),
    "hymba_1p5b": SSMConfig(d_model=128, d_inner=256, d_state=16,
                            head_dim=32, chunk=CHUNK_LEN)}
_PAIRS: dict = {}


def _pair(arch: str, **ov):
    key = (arch, tuple(sorted(ov.items())))
    if key not in _PAIRS:
        jm = jget(arch, smoke=True, dtype="float32", **ov)
        jp = jm.init(jax.random.key(1))
        tm = tget(arch, smoke=True, dtype="float32", **ov)
        tp = params_from_flat({k: np.asarray(v) for k, v in
                               flatten_paths(jp).items()}, tm.cfg, "cpu")
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


_REFERENCE: dict = {}


def _reference_oneshot(jm, jp, prompts, max_new):
    """The reference's one-shot tokens, one prompt at a time (kept per
    model and prompts: the paged and dense cases share them)."""
    key = (id(jm), tuple(p.tobytes() for p in prompts), max_new)
    if key not in _REFERENCE:
        eng = JServeEngine(jm, donate=False)
        _REFERENCE[key] = [np.asarray(eng.generate(
            jp, {"tokens": jnp.asarray(p)[None]},
            max_new_tokens=max_new).tokens)[0] for p in prompts]
    return _REFERENCE[key]


def _prompts(lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 200, size=n).astype(np.int32) for n in lens]


def _serve(tm, tp, prompts, max_new, **kw):
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=max_new, arrival=i)
            for i, p in enumerate(prompts)]
    return eng, eng.serve(tp, reqs)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_continuous_engine_matches_reference_oneshot(arch, paged):
    """Staggered arrivals over two slots (slot reuse: a new request's
    first chunk resets the slot's SSM state), prompts of 12, 27 and 5
    tokens: the reference's one-shot tokens, paged and over dense rings."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts((12, 27, 5))
    want = _reference_oneshot(jm, jp, prompts, 4)
    kw = dict(block_size=4) if paged else dict(paged=False)
    _, summ = _serve(tm, tp, prompts, 4, n_slots=2, max_len=40, **kw)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(summ.tokens_for(i), w)
    if paged:
        # slot-major SSM state is counted per slot beside the blocks
        slot = paged_slot_bytes(tm, 4)
        assert slot > 0
        assert summ.counters["peak_kv_bytes"] >= 2 * slot
        assert summ.counters["prefix_cache"] is False


def test_hybrid_prompt_longer_than_its_window():
    """A 48-token prompt over Hymba's 32-token window, paged (the window
    masks a table longer than it): the reference's one-shot tokens.
    ``global_attn_layers=()`` as in the reference's test: a dense ring
    holds only ``window`` keys for every layer, global ones included, so
    the one-shot engine is the reference only for uniformly windowed
    layers."""
    jm, jp, tm, tp = _pair("hymba_1p5b", global_attn_layers=())
    prompts = _prompts((48, 48), seed=5)
    want = _reference_oneshot(jm, jp, prompts, 4)
    for attn in ("fused", "gather"):
        _, summ = _serve(tm, tp, prompts, 4, n_slots=2, max_len=64,
                         block_size=16, paged_attn=attn)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(summ.tokens_for(i), w, attn)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_chunked_prefill_matches_oneshot(arch, mp):
    """Chunks of 8 (= the SSD chunk) for prompts of 20, 11 and 7 tokens,
    paged and over dense rings: the port's one-shot tokens bit for bit,
    plain and under an MP plan on an SSD product and two linears; plain,
    also the reference's one-shot tokens."""
    jm, jp, tm, tp = _pair(arch, ssm=SSM_CHUNKED[arch])
    plan = ({"layers/0/mamba/cb_matmul": "fp8_e4m3",
             "layers/1/mamba/in_proj": "fp8_e4m3",
             "layers/2/mamba/out_proj": "fp8_e4m3", "lm_head": "fp8_e4m3"}
            if mp else None)
    prompts = _prompts((20, 11, 7))
    one = ServeEngine(tm, mp=plan, device="cpu")
    want = [one.generate(tp, {"tokens": p[None]}, max_new_tokens=4).tokens[0]
            for p in prompts]
    if not mp:
        for w, r in zip(want, _reference_oneshot(jm, jp, prompts, 4)):
            np.testing.assert_array_equal(w, r)
    for kw in (dict(block_size=4), dict(paged=False)):
        _, summ = _serve(tm, tp, prompts, 4, n_slots=2, max_len=40,
                         chunk_len=CHUNK_LEN, mp=plan, **kw)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(summ.tokens_for(i), w, str(kw))
        assert summ.counters["prefill_chunks"] >= 3


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_preempted_request_equals_its_uninterrupted_run(arch):
    """A priority-1 request evicts a decoding priority-0 one; the evicted
    request re-prefills from its first token (its SSM state reset by the
    first chunk) and ends with the tokens of the drain without
    preemption."""
    _, _, tm, tp = _pair(arch)
    spec = _scenario("preempt")
    got = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                 device="cpu")
    twin = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                  device="cpu", preemption=False)
    assert got.counters["preemptions"] >= 1
    assert twin.counters["preemptions"] == 0
    for rid in twin.results:
        np.testing.assert_array_equal(got.results[rid].tokens,
                                      twin.results[rid].tokens)


def test_engine_refuses_prefix_cache_and_misaligned_chunks():
    """Mirrors the reference's ``test_prefix_cache_gating_ssm_and_dense``
    and its ``chunk_len`` guard."""
    hyb = tget("hymba_1p5b", smoke=True)
    with pytest.raises(ValueError, match="SSM/hybrid"):
        ContinuousBatchingEngine(hyb, prefix_cache=True, device="cpu")
    assert ContinuousBatchingEngine(hyb, device="cpu").prefix_cache is False
    assert ContinuousBatchingEngine(
        tget("llama3_1b", smoke=True), device="cpu").prefix_cache is True
    mam = tget("mamba2_370m", smoke=True)          # ssm.chunk 32
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ContinuousBatchingEngine(mam, chunk_len=8, device="cpu")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ContinuousBatchingEngine(hyb, chunk_len=100, paged=False,
                                 device="cpu")
    ContinuousBatchingEngine(mam, chunk_len=64, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousBatchingEngine(mam, paged=False, prefix_cache=True,
                                 device="cpu")


def test_ssm_state_is_slot_major_in_both_pools():
    """The dense and paged pools keep one SSM state row per slot, beside
    (Hymba) the attention cache of the same layer."""
    tm = tget("hymba_1p5b", smoke=True)
    specs = tm.paged_cache_specs(3, 9, 4)
    assert specs["layers/0@mamba/state"].shape == (3, 8, 32, 16)
    assert specs["layers/0@attn/k"].shape == (9, 4, 1, 16)
    assert tm.cache_specs(3, 40)["layers/0@mamba/conv"].shape == (3, 3, 288)
    pc = tm.init_paged_cache(3, 9, 4, "cpu")
    assert set(pc["layers/1"]) == {"attn", "mamba"}
    assert dataclasses.is_dataclass(tm.cfg.ssm)


def test_launcher_serves_the_ssm_configs(capsys):
    from repro_torch.launch.serve import main
    common = ["--smoke", "--device", "cpu", "--requests", "3", "--n-slots",
              "2", "--prompt-len", "10", "--new-tokens", "3"]
    for arch in SSM_ARCHS:
        main(["--arch", arch, "--continuous"] + common)
        assert "continuous: 3 reqs via 2 slots" in capsys.readouterr().out
        main(["--arch", arch, "--continuous", "--dense-slots"] + common)
        assert "3 reqs" in capsys.readouterr().out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_guardrail_shadow_leaves_the_ssm_state_alone(arch):
    """The guardrail's unquantized shadow step runs over the same caches
    before the active step; the caches are written in place, so the shadow
    must not advance the SSM state: a drain checked at every step gives
    the tokens of the unchecked drain."""
    from repro_torch.serve.adaptive import NumericalGuardrail
    _, _, tm, tp = _pair(arch)
    plan = {"layers/1/mamba/in_proj": "fp8_e4m3", "lm_head": "fp8_e4m3"}
    prompts = _prompts((12, 9, 5), seed=3)
    _, want = _serve(tm, tp, prompts, 5, n_slots=2, max_len=32, mp=plan,
                     block_size=4)
    _, got = _serve(tm, tp, prompts, 5, n_slots=2, max_len=32, mp=plan,
                    block_size=4,
                    guardrail=NumericalGuardrail(every=1, budget=1e9))
    assert got.counters["guardrail"]["checks"] > 0
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got.tokens_for(i), want.tokens_for(i))
