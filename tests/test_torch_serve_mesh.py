"""Mesh serving on CPU ranks: the port's ``ContinuousBatchingEngine(mesh=)``
against its own single-rank engine (the reference's mesh tests fail on this
JAX; its rules and pool geometry are held in ``test_torch_sharding.py``).

Four gloo ranks are spawned once for the file (one intra-op thread each; a
free port; a hard timeout on the group's start and on the join, so a hang
fails these tests and not the suite). Ranks 0-1 and 2-3 form two pairs,
each serving half of the two-rank cases on its own (2,1) or (1,2) mesh;
then all four serve the (2,2) cases and the launcher's ``--mesh``. Every
rank also runs each case's single-rank engine (the reference), so the
ranks' weight caches stay alike. The cases:

* the reference's matrix: {llama3_1b; deepseek_v3_671b with
  ``moe_layers=()``, ``mtp_depth=0``, absorbed decode; hymba_1p5b} smoke x
  {paged, dense} x {(2,1), (1,2)};
* prefix sharing on equal to off and to the single-rank engine at (2,1)
  and (1,2), a prefix on another data shard a miss;
* llama3_1b under an fp8 plan with fp8 KV at (1,2) (the scale hazards:
  per-tensor weight scales and per-token scales over sharded features),
  with the guardrail's shadow step reading the gathered logits;
* llama3_1b at (2,2), paged, prefix cache on;
* ``python -m repro_torch.launch.serve --continuous --mesh data=2,model=2``
  (its ``main``), rank 0 printing.

The near-tie rule (``PERF.md`` section 2): tokens equal up to a first
divergence, which may sit only at a near-tie of the single-rank one-shot
engine's logits (top-two gap below 0.125; 0.25 under a plan), and every
live row's step logits within 0.125 (0.25) of the single-rank engine's up
to it. Each case also says whether it held bit for bit."""
import contextlib
import datetime
import io
import json
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
JOIN_TIMEOUT_S = 150
GROUP_TIMEOUT_S = 60
TOL, TOL_MP = 0.125, 0.25
DS_KW = dict(moe_layers=(), mtp_depth=0, mla_absorb_decode=True)
ARCHS = {"attn": ("llama3_1b", {}), "mla": ("deepseek_v3_671b", DS_KW),
         "hybrid": ("hymba_1p5b", {})}
FP8_PLAN = {"layers/0/attn/q_proj": "fp8_e4m3",
            "layers/0/attn/o_proj": "fp8_e4m3",
            "layers/1/mlp/down_proj": "fp8_e4m3",
            "layers/1/mlp/up_proj": "fp8_e4m3",
            "layers/1/attn/qk_matmul": "fp8_e4m3",
            "layers/1/attn/av_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}

MATRIX = [f"matrix-{a}-{'paged' if p else 'dense'}-{d}x{m}"
          for a in ARCHS for p in (True, False) for d, m in ((2, 1), (1, 2))]
PAIR_CASES = MATRIX + ["prefix-2x1", "prefix-1x2", "fp8-1x2"]
QUAD_CASES = ["quad-2x2", "launcher-2x2"]


# ---------------------------------------------------------------------------
# what runs inside the ranks
# ---------------------------------------------------------------------------


def _recorder(eng, log: list) -> None:
    """Wrap the engine's step closures: every call appends (kind, live-row
    mask, last-position logits), on the CPU, in call order."""
    def wrap(kind, step):
        def recorded(params, caches, *inputs):
            out = step(params, caches, *inputs)
            if kind == "prefill":
                live = inputs[2] > 0
            elif len(inputs) == 3:                 # paged decode
                live = inputs[2][:, 0] >= 0
            else:
                live = torch.ones(inputs[0].shape[0], dtype=torch.bool)
            log.append((kind, live.clone(), out[0][:, -1].float().clone()))
            return out
        return recorded
    eng.prefill_chunk_step = wrap("prefill", eng.prefill_chunk_step)
    eng.decode_step = wrap("decode", eng.decode_step)


def _serve(model, params, reqs, mesh=None, mp=None, **kw):
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, mesh=mesh, mp=mp, device="cpu",
                                   **kw)
    log = []
    _recorder(eng, log)
    out = eng.serve(params, reqs(), sync=True)
    return out, log


def _margins(model, params, prompts, max_new, mp):
    """Per prompt, the top-two gap of each greedy step of the single-rank
    one-shot engine."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, mp=mp, device="cpu")
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
    out = []
    for p in prompts:
        gaps.clear()
        eng.generate(params, {"tokens": p[None]}, max_new_tokens=max_new)
        out.append(np.concatenate(gaps))
    return out


def _near_tie_rule(ref, got, ref_log, got_log, margins, tol) -> dict:
    """The rule, checked; returns what held."""
    first_step = None
    bitwise = True
    for rid in ref.results:
        a, b = ref.tokens_for(rid), got.tokens_for(rid)
        assert a.shape == b.shape, (rid, a, b)
        diff = np.nonzero(a != b)[0]
        if diff.size:
            bitwise = False
            i = int(diff[0])
            assert margins[rid][i] < tol, (rid, i, margins[rid][i], a, b)
    assert len(ref_log) == len(got_log)
    worst = 0.0
    for k, ((kind, live, lr), (kind2, live2, lg)) in enumerate(
            zip(ref_log, got_log)):
        assert kind == kind2 and torch.equal(live, live2)
        if not live.any():
            continue
        if (lr[live].argmax(-1) != lg[live].argmax(-1)).any():
            first_step = k
            break                           # a divergence: stop here
        d = float((lr[live] - lg[live]).abs().max())
        worst = max(worst, d)
        bitwise = bitwise and torch.equal(lr[live], lg[live])
    assert worst <= tol, worst
    return {"bitwise": bool(bitwise), "max_logit_diff": worst,
            "first_divergent_step": first_step}


def _requests(vocab, lens, max_new, seed, arrival_every=0, base=0):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    common = rng.integers(1, min(vocab, 200), size=base).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(
        1, min(vocab, 200), size=n).astype(np.int32)]) for n in lens]
    return prompts, (lambda: [
        Request(rid=i, tokens=p, max_new_tokens=max_new,
                arrival=i * arrival_every) for i, p in enumerate(prompts)])


def _model(arch, kw):
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import default_generator
    model = get_model(arch, smoke=True, **kw)
    return model, model.init(default_generator(0, "cpu"), "cpu")


def _matrix_case(name, mesh):
    _, a, layout, _ = name.split("-")
    arch, kw = ARCHS[a]
    model, params = _model(arch, kw)
    prompts, reqs = _requests(model.cfg.vocab_size, (12, 9), 4, 7)
    ekw = dict(n_slots=2, max_len=32, paged=layout == "paged")
    if ekw["paged"]:
        ekw["block_size"] = 8
    ref, ref_log = _serve(model, params, reqs, **ekw)
    got, got_log = _serve(model, params, reqs, mesh=mesh, **ekw)
    res = _near_tie_rule(ref, got, ref_log, got_log,
                         _margins(model, params, prompts, 4, None), TOL)
    res["mesh_counters"] = got.counters["mesh"]
    return res


def _prefix_case(name, mesh):
    model, params = _model("llama3_1b", {})
    prompts, reqs = _requests(model.cfg.vocab_size, (4, 4, 4), 4, 3,
                              arrival_every=1, base=16)
    ekw = dict(n_slots=4, max_len=32, block_size=8)
    ref, ref_log = _serve(model, params, reqs, **ekw)
    on, on_log = _serve(model, params, reqs, mesh=mesh, **ekw)
    off, _ = _serve(model, params, reqs, mesh=mesh, prefix_cache=False, **ekw)
    for rid in on.results:
        assert np.array_equal(on.tokens_for(rid), off.tokens_for(rid)), rid
    res = _near_tie_rule(ref, on, ref_log, on_log,
                         _margins(model, params, prompts, 4, None), TOL)
    assert off.counters["prefix_hit_blocks"] == 0
    res["hits"] = on.counters["prefix_hit_requests"]
    res["hits_single_rank"] = ref.counters["prefix_hit_requests"]
    return res


def _fp8_case(name, mesh):
    """Also the guardrail's shadow step every 2 decode steps (a budget no
    MSE reaches): its MSE over the mesh's gathered logits is the
    single-rank engine's."""
    from repro_torch.serve import NumericalGuardrail
    model, params = _model("llama3_1b", dict(kv_cache_dtype="fp8_e4m3"))
    prompts, reqs = _requests(model.cfg.vocab_size, (12, 9, 5), 4, 11)
    ekw = dict(n_slots=2, max_len=32, block_size=8)
    ref, ref_log = _serve(model, params, reqs, mp=FP8_PLAN,
                          guardrail=NumericalGuardrail(every=2, budget=1e9),
                          **ekw)
    got, got_log = _serve(model, params, reqs, mesh=mesh, mp=FP8_PLAN,
                          guardrail=NumericalGuardrail(every=2, budget=1e9),
                          **ekw)
    res = _near_tie_rule(ref, got, ref_log, got_log,
                         _margins(model, params, prompts, 4, FP8_PLAN),
                         TOL_MP)
    g_ref, g_got = ref.counters["guardrail"], got.counters["guardrail"]
    assert g_got["checks"] == g_ref["checks"] > 0 and not g_got["breaches"]
    assert abs(g_got["last_mse"] - g_ref["last_mse"]) <= \
        1e-3 * g_ref["last_mse"] + 1e-9, (g_got, g_ref)
    res["guardrail_mse"] = [g_ref["last_mse"], g_got["last_mse"]]
    return res


def _quad_case(name, mesh):
    model, params = _model("llama3_1b", {})
    prompts, reqs = _requests(model.cfg.vocab_size, (12, 9, 5, 3, 10), 5, 5,
                              arrival_every=1, base=8)
    ekw = dict(n_slots=4, max_len=40, block_size=8)
    ref, ref_log = _serve(model, params, reqs, **ekw)
    got, got_log = _serve(model, params, reqs, mesh=mesh, **ekw)
    res = _near_tie_rule(ref, got, ref_log, got_log,
                         _margins(model, params, prompts, 5, None), TOL)
    res["mesh_counters"] = got.counters["mesh"]
    res["hits"] = got.counters["prefix_hit_requests"]
    return res


def _launcher_case(name, mesh):
    """The launcher's main on the four ranks (it destroys the group)."""
    import torch.distributed as dist
    from repro_torch.launch import serve as launcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--smoke", "--device", "cpu", "--continuous",
                       "--mesh", "data=2,model=2", "--n-slots", "4",
                       "--requests", "4", "--prompt-len", "8",
                       "--new-tokens", "3", "--block-size", "4"])
    assert not dist.is_initialized()
    return {"stdout": buf.getvalue()}


_RUNNERS = {"matrix": _matrix_case, "prefix": _prefix_case,
            "fp8": _fp8_case, "quad": _quad_case,
            "launcher": _launcher_case}


def _run(name, mesh) -> dict:
    t0 = time.perf_counter()
    try:
        res = _RUNNERS[name.split("-")[0]](name, mesh)
        res["ok"] = True
    except Exception:                                # noqa: BLE001
        res = {"ok": False, "error": traceback.format_exc()[-3000:]}
    res["seconds"] = time.perf_counter() - t0
    return res


def _worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    names = ("data", "model")
    quad = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
    # every rank builds every pair mesh (their groups need all ranks)
    pair = {(2, 1): [DeviceMesh("cpu", [[0], [1]], mesh_dim_names=names),
                     DeviceMesh("cpu", [[2], [3]], mesh_dim_names=names)],
            (1, 2): [DeviceMesh("cpu", [[0, 1]], mesh_dim_names=names),
                     DeviceMesh("cpu", [[2, 3]], mesh_dim_names=names)]}
    results = {}
    mine = rank // 2
    for i, name in enumerate(PAIR_CASES):
        if i % 2 != mine:
            continue
        shape = tuple(int(v) for v in name.rsplit("-", 1)[1].split("x"))
        results[name] = _run(name, pair[shape][mine])
    dist.barrier()
    for name in QUAD_CASES:
        results[name] = _run(name, quad)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    """Spawn the four ranks once; their results by rank and case."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as out_dir:
        ctx = mp.start_processes(_worker, args=(_free_port(), out_dir),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"mesh ranks did not finish within "
                                       f"{JOIN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = {}
        for r in range(WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                out[r] = json.load(f)
    out["seconds"] = time.perf_counter() - t0
    return out


def _result(ranks, name) -> dict:
    got = [ranks[r][name] for r in range(WORLD) if name in ranks[r]]
    assert got, name
    for res in got:
        assert res["ok"], res.get("error")
    return got[0]


@pytest.mark.parametrize("name", MATRIX)
def test_mesh_greedy_parity_matrix(ranks, name):
    res = _result(ranks, name)
    d, m = (int(v) for v in name.rsplit("-", 1)[1].split("x"))
    assert res["mesh_counters"]["data"] == d
    assert res["mesh_counters"]["model"] == m


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_mesh_prefix_sharing_parity(ranks, shape):
    res = _result(ranks, f"prefix-{shape}")
    assert res["hits_single_rank"] == 2
    # 2 slots a data shard: the second request lands on the first's shard
    # and hits, the third on the other shard, where the prefix is a miss
    assert res["hits"] == (1 if shape == "2x1" else 2)


def test_mesh_fp8_plan_and_kv(ranks):
    _result(ranks, "fp8-1x2")


def test_mesh_four_ranks(ranks):
    res = _result(ranks, "quad-2x2")
    assert res["mesh_counters"] == {"data": 2, "model": 2,
                                    "shard_pages": True}
    assert res["hits"] >= 1


def test_launcher_serves_over_a_mesh(ranks):
    out = [ranks[r]["launcher-2x2"] for r in range(WORLD)]
    for res in out:
        assert res["ok"], res.get("error")
    assert "[serve] mesh: data 2 x model 2 (pages sharded)" in \
        out[0]["stdout"]
    assert all(not res["stdout"] for res in out[1:])    # rank 0 prints


def test_ranks_report_alike(ranks):
    """Both ranks of a pair, and all four, saw the same outcome."""
    for name in PAIR_CASES + QUAD_CASES[:1]:
        got = [ranks[r][name] for r in range(WORLD) if name in ranks[r]]
        keys = [{k: v for k, v in g.items() if k != "seconds"} for g in got]
        assert all(k == keys[0] for k in keys), name
    assert ranks["seconds"] < JOIN_TIMEOUT_S
