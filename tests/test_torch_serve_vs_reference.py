"""The port's continuous engine against the reference's, drain for drain,
on the same bridged weights: equal schedule counters and decode steps for
the prefix-cache, preemption and chunked-prefill scenarios, and greedy
tokens held to the port's one-shot engine. Split from
``test_torch_serve.py`` (the scenarios and pairs are in
``torch_serve_common.py``) so that ``--dist loadfile`` runs it on a worker
of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, Request  # noqa: E402
from torch_serve_common import (  # noqa: E402
    SCHEDULE_COUNTERS, _drain, _oneshot, _pair, _scenario, assert_agree)


@pytest.mark.parametrize("scenario", ["share", "preempt", "chunked"])
@pytest.mark.parametrize("arch", ["attn", "mla"])
def test_continuous_engine_matches_reference_engine(arch, scenario):
    """The port's drain and the reference's lockstep drain of the same
    requests on the same weights: equal schedule counters (prefix hits,
    forks, preemptions, chunks, stalls) and decode steps; greedy tokens
    agree with the port's one-shot engine (bit for bit in the port, up to
    a near-tie in the reference)."""
    from repro.serve import ContinuousBatchingEngine as JEngine
    jm, jp, tm, tp = _pair(arch)
    spec = _scenario(scenario)
    want = _drain(JEngine, JRequest, jm, jp, spec)
    got = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                 device="cpu")
    for key in SCHEDULE_COUNTERS:
        assert got.counters[key] == want.counters[key], key
    assert got.n_steps == want.n_steps
    c = got.counters
    if scenario == "share":
        assert c["prefix_hit_requests"] == 3 and c["cow_forks"] == 1
    elif scenario == "preempt":
        assert c["preemptions"] >= 1
        assert got.results[2].finished_step < got.results[0].finished_step
    else:
        assert c["prefill_chunks"] > len(spec[1])
        assert c["max_decode_stall_run"] == 1 and c["decode_stall_steps"] > 0
    ref = _oneshot(tm, tp, [p for _, p, *_ in spec[1]], spec[1][0][2])
    for (rid, *_), (tok, gaps) in zip(spec[1], ref):
        assert got.results[rid].status == "ok"
        np.testing.assert_array_equal(got.results[rid].tokens, tok)
        assert_agree(np.asarray(want.results[rid].tokens), tok, gaps)
