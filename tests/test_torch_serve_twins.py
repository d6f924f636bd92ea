"""The port's drains held bit for bit to their twins inside the port, on the
CPU, plain and under an MP plan: sharing on against sharing off, a preempted
request against its uninterrupted run, chunked prefill against one-chunk
prefill. Split from ``test_torch_serve.py`` (the scenarios and pairs are in
``torch_serve_common.py``) so that ``--dist loadfile`` runs it on a worker
of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.serve import ContinuousBatchingEngine, Request  # noqa: E402
from torch_serve_common import (MLA_MP, MP_ASSIGNMENT, _TWIN,  # noqa: E402
                                _drain, _pair, _scenario)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("scenario", ["share", "preempt", "chunked"])
@pytest.mark.parametrize("arch", ["attn", "mla"])
def test_port_drain_bit_equal_to_its_twin(arch, scenario, mp):
    """On the CPU, within the port, plain and under an MP plan: sharing on
    gives the tokens of sharing off, a preempted request those of its
    uninterrupted run, chunked prefill those of one-chunk prefill — bit
    for bit (K/V under the serving policy is a function of the tokens at
    or before each position, and every CPU product here is an f32 sum over
    the same operands)."""
    _, _, tm, tp = _pair(arch)
    plan = (MLA_MP if arch == "mla" else MP_ASSIGNMENT) if mp else None
    spec = _scenario(scenario)
    got = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                 device="cpu", mp=plan)
    twin = _drain(ContinuousBatchingEngine, Request, tm, tp, spec,
                  device="cpu", mp=plan, **_TWIN[scenario])
    c, t = got.counters, twin.counters
    if scenario == "share":
        assert c["prefix_hit_tokens"] > 0 and c["cow_forks"] == 1
        assert c["prefill_tokens"] == t["prefill_tokens"] - \
            c["prefix_hit_tokens"]
    elif scenario == "preempt":
        assert c["preemptions"] >= 1 and t["preemptions"] == 0
    else:
        assert c["prefill_chunks"] > t["prefill_chunks"]
    assert got.results.keys() == twin.results.keys()
    for rid in twin.results:
        np.testing.assert_array_equal(got.results[rid].tokens,
                                      twin.results[rid].tokens)
