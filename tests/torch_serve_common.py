"""Shared pieces of the port's serving tests (``test_torch_serve*.py``,
``test_torch_serve_dense.py``, ``test_torch_serve_drain.py``): the token
agreement rule, the port's one-shot reference run, the bridged model pairs
and the prefix-cache / preemption / chunked-prefill scenarios. Not a test
file: the heavy parametrized tests live in files of their own so that
``--dist loadfile`` spreads them over workers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import flatten_paths  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

MARGIN_BOUND = 0.125        # as chip_smoke.py: 8 bf16 ulps at |logit| ~ 2-4
MARGIN_BOUND_MP = 0.25      # as chip_smoke.py under an fp8 MP plan
MP_ASSIGNMENT = {"layers/0/attn/q_proj": "fp8_e4m3",
                 "layers/1/mlp/down_proj": "fp8_e4m3",
                 "layers/1/attn/qk_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}


def assert_agree(got, ref, ref_margins, bound=MARGIN_BOUND):
    """Equal up to the first divergence; a divergence only at a near-tie."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    diff = np.nonzero(got != ref)[0]
    if diff.size:
        i = int(diff[0])
        assert ref_margins[i] < bound, (i, ref_margins[i], got, ref)


def _record_gaps(eng) -> list:
    """Wrap a one-shot engine's step closures (instance attributes; the
    shared memoized steps stay as they are) so that every call appends the
    (B,) gap between the two largest last-position logits."""
    gaps = []

    def wrap(step):
        def recorded(*args):
            out = step(*args)
            top = torch.topk(out[0][:, -1].float(), 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).numpy())
            return out
        return recorded

    for name in ("prefill_step", "bucketed_prefill_step", "decode_step"):
        setattr(eng, name, wrap(getattr(eng, name)))
    return gaps


def _oneshot(model, params, prompts, max_new, mp=None):
    """(tokens, top-two gaps), each (max_new,), per prompt from the port's
    one-shot engine, one prompt at a time."""
    eng = ServeEngine(model, mp=mp, device="cpu")
    gaps = _record_gaps(eng)
    out = []
    for p in prompts:
        gaps.clear()
        r = eng.generate(params, {"tokens": p[None]}, max_new_tokens=max_new)
        out.append((r.tokens[0], np.concatenate(gaps)))
    return out


DS = "deepseek_v3_671b"
DENSE_MLA = dict(moe_layers=(), mtp_depth=0, mla_absorb_decode=True)
MLA_MP = {"layers/0/attn/q_b_proj": "fp8_e4m3",
          "layers/1/attn/kv_b_proj": "fp8_e4m3",
          "layers/1/mlp/down_proj": "fp8_e4m3",
          "layers/2/attn/qk_matmul": "fp8_e4m3",
          "layers/2/attn/av_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}
# what the reference engine counts and the port must count alike
SCHEDULE_COUNTERS = ("prefix_hit_requests", "prefix_hit_tokens", "cow_forks",
                     "preemptions", "prefill_chunks", "decode_stall_steps",
                     "max_decode_stall_run", "blocked_admissions",
                     "reclaimed_cached_blocks")
_PAIRS: dict = {}


def _pair(arch: str):
    """(reference model, its params, port model, the same params bridged)
    for the smoke llama3_1b ("attn") or DeepSeek-V3's smoke dense MLA
    prefix with absorbed decode ("mla")."""
    if arch not in _PAIRS:
        name, kw = ("llama3_1b", {}) if arch == "attn" else (DS, DENSE_MLA)
        jm = jget(name, smoke=True, **kw)
        jp = jm.init(jax.random.key(0))
        tm = get_model(name, smoke=True, **kw)
        tp = params_from_flat({k: np.asarray(v) for k, v in
                               flatten_paths(jp).items()}, tm.cfg, "cpu")
        _PAIRS[arch] = (jm, jp, tm, tp)
    return _PAIRS[arch]


def _scenario(name: str):
    """(engine kwargs, [(rid, prompt, max_new, arrival, priority)]).

    * share: three prompts on one 16-token base (4 blocks of 4) plus 4 own
      tokens, then the first prompt again (a full-prompt hit: its tail
      chunk forks the last shared block);
    * preempt: each request's worst case takes all 5 allocatable blocks,
      and a priority-1 request arrives while a priority-0 one decodes;
    * chunked: prompts of 5 to 29 tokens in chunks of 8, one chunk step
      between decode steps, arriving while others decode."""
    rng = np.random.default_rng({"share": 31, "preempt": 29,
                                 "chunked": 19}[name])
    if name == "share":
        base = rng.integers(0, 200, size=16).astype(np.int32)
        ps = [np.concatenate([base, rng.integers(0, 200, size=4)
                              .astype(np.int32)]) for _ in range(3)]
        reqs = [(i, p, 4, i, 0) for i, p in enumerate(ps + ps[:1])]
        return dict(n_slots=2, max_len=40, block_size=4), reqs
    if name == "preempt":
        ps = [rng.integers(0, 200, size=12).astype(np.int32)
              for _ in range(3)]
        reqs = [(0, ps[0], 8, 0, 0), (1, ps[1], 8, 1, 0), (2, ps[2], 8, 2, 1)]
        return dict(n_slots=2, max_len=32, block_size=4, n_blocks=6), reqs
    lens = (13, 29, 5, 21)
    reqs = [(i, rng.integers(0, 200, size=n).astype(np.int32), 4, 2 * i, 0)
            for i, n in enumerate(lens)]
    return dict(n_slots=3, max_len=40, block_size=4, chunk_len=8,
                chunk_budget=1), reqs


def _drain(cls, req_cls, model, params, spec, **kw):
    """The lockstep drain of ``spec`` on engine class ``cls``."""
    ekw, reqs = spec
    eng = cls(model, **dict(ekw, **kw))
    rs = [req_cls(rid=rid, tokens=p, max_new_tokens=m, arrival=a,
                  priority=pr) for rid, p, m, a, pr in reqs]
    return eng.serve(params, rs, sync=True)


# the twin each scenario is held to, bit for bit, inside the port
_TWIN = {"share": dict(prefix_cache=False), "preempt": dict(preemption=False),
         "chunked": dict(chunk_len=None)}
