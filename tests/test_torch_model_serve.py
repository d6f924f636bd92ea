"""Greedy tokens of each dense smoke model end to end: the reference
``ServeEngine`` against the port's one-shot engine and the port's
continuous engine on bf16 weights bridged from the reference. Split from
``test_torch_model.py`` (whose helpers it uses) so that ``--dist
loadfile`` runs it on a worker of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from test_torch_model import (DENSE,  # noqa: E402
                              _reference_ties_where_port_differs)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_reference_and_continuous_matches_oneshot(arch):
    """End to end on each dense model's smoke config, bf16 weights bridged
    from the reference: the reference ``ServeEngine``'s greedy tokens equal
    the port's one-shot engine's (where the engine's compiled steps tie
    exactly, the port gives the reference model's op-by-op tokens:
    ``_reference_ties_where_port_differs``), and the port's continuous
    engine (paged pool, staggered arrivals through two slots, fused decode
    attention's plain version) gives the one-shot tokens."""
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import (ContinuousBatchingEngine, Request,
                                   ServeEngine)
    jm = jget(arch, smoke=True)
    jp = jm.init(jax.random.key(0))
    tm = tget(arch, smoke=True)
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           flatten_paths(jp).items()}, tm.cfg, "cpu")
    rng = np.random.default_rng(7)
    batch = rng.integers(0, tm.cfg.vocab_size, (4, 12)).astype(np.int32)
    want = np.asarray(JServeEngine(jm, donate=False).generate(
        jp, {"tokens": jnp.asarray(batch)}, max_new_tokens=6).tokens)
    got = ServeEngine(tm, device="cpu").generate(
        tp, {"tokens": batch}, max_new_tokens=6).tokens
    if not np.array_equal(got, want):
        _reference_ties_where_port_differs(jm, jp, batch, got, want)
    eng = ContinuousBatchingEngine(tm, n_slots=2, max_len=32, block_size=4,
                                   device="cpu")
    out = eng.serve(tp, [Request(rid=i, tokens=p, max_new_tokens=6,
                                 arrival=2 * i) for i, p in enumerate(batch)])
    for i in range(len(batch)):
        np.testing.assert_array_equal(out.results[i].tokens, got[i])
