"""Training over a (data, model) mesh on CPU ranks: the port's
``Trainer(mesh=)`` against its own single-rank trainer, which
``test_torch_train.py`` holds to the reference's train step (the reference's
trainer fails on this JAX even at a 1x1 mesh). Where the reference still
runs it is held directly: ``zero_partition_spec``'s blocks and
``compressed_psum`` (under ``jax.vmap`` with a named axis).

Four gloo ranks are spawned once for the file (one intra-op thread each; a
free port; a hard timeout on the group's start and on the join, so a hang
fails these tests and not the suite). Ranks 0-1 and 2-3 form two pairs,
each running half of the two-rank cases on its own (2,1) or (1,2) mesh; each
rank runs a 1x1 mesh of its own; then all four run the (2,2) and (4,1)
cases and, last (it destroys the group), the launcher. Every rank also runs
each case's single-rank trainer. The cases:

* step parity: llama3_1b, DeepSeek-V3 dense (``moe_layers=()``,
  ``mtp_depth=0``: MLA) and hymba_1p5b (5 KV heads: the gather fallback at
  ``model`` 2) at smoke size in float32, three AdamW steps at (2,1) and
  (1,2), llama3_1b also at (2,2) and bf16 at (1,2); each step's loss and
  grad norm, and the gathered params and first moments, against the
  single-rank trainer. A 1x1 mesh gives the same bits.
* an fp8 plan at (2,2) with the batch's largest activation on data shard
  1: the mesh's loss is the single-rank one, and an amax left rank-local
  over ``data`` moves it.
* two microbatches at (2,1) against the single-rank trainer's two;
* ZeRO-1: every rank's AdamW moment shapes are its block under the
  reference's ``zero_partition_spec`` of the same mesh axes;
* elastic (``tests/test_elastic.py``'s counterpart): saved at (2,2),
  restored onto (4,1) and onto no mesh bit for bit; the arrays' bytes those
  of a single-rank save of the same values; resumed on (4,1) within the
  step tolerance of a straight single-rank run;
* a straggler on one rank: every rank checkpoints at the same step and,
  with ``abort_on_straggler``, exits 17;
* ``compressed_psum`` over ``data`` of a (4,1) mesh against the
  reference's under ``jax.vmap``, e4m3 and e5m2;
* ``python -m repro_torch.launch.train --mesh-data 2 --mesh-model 2``'s
  ``main``, rank 0 alone printing.

Tolerances (float32 smoke models; the mesh sums partial products and
gradients in another order than one device): every first-moment leaf
after the first step (the first gradient, from the same params) within
1e-5 of its norm; after that the params part by up to lr a step (AdamW's
first update is about lr x the sign of the gradient: a near-zero
gradient's sign may flip), so the losses of later steps hold within 1e-4
relative, grad norms 1e-3, first moments 0.05 of their norms and params
2 x lr a step. bf16: 5e-2 for the first moments after step 1, 1e-3
losses, 1e-2 grad norms, 0.25 the last moments."""
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
from torch_threads import one_intra_op_thread  # noqa: E402,F401

WORLD = 4
JOIN_TIMEOUT_S = 150
GROUP_TIMEOUT_S = 60
STEPS = 3
LR = 1e-3
TOL = dict(loss=1e-4, gnorm=1e-3, mu1=1e-5, mu=0.05)
TOL_BF16 = dict(loss=1e-3, gnorm=1e-2, mu1=5e-2, mu=0.25)
DS_KW = dict(moe_layers=(), mtp_depth=0)
ARCHS = {"llama": ("llama3_1b", {}), "mla": ("deepseek_v3_671b", DS_KW),
         "hybrid": ("hymba_1p5b", {})}
PAIR_CASES = ([f"step-{a}-{s}" for a in ARCHS for s in ("2x1", "1x2")]
              + ["step-llamabf16-1x2", "micro-2x1"])
QUAD_CASES = ["step-llama-2x2", "fp8-2x2", "elastic-2x2", "psum-4x1",
              "straggler-2x2", "launcher-2x2"]
FP8_PLAN = {"layers/0/attn/q_proj": "fp8_e4m3",
            "layers/0/attn/o_proj": "fp8_e4m3",
            "layers/1/mlp/down_proj": "fp8_e4m3",
            "layers/1/mlp/up_proj": "fp8_e4m3",
            "layers/1/attn/qk_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}
PSUM_FORMATS = ("fp8_e4m3", "fp8_e5m2")


# ---------------------------------------------------------------------------
# what runs inside the ranks
# ---------------------------------------------------------------------------


def _model(arch, kw, dtype="float32"):
    """A smoke model; in float32 its weights too (the configs keep their
    matmul weights in bf16, whose gradients round each rank's partial sum
    to bf16 before the sum over ``data``)."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    model = get_model(arch, smoke=True, dtype=dtype, **kw)
    if dtype == "float32":
        init = model.init
        model.init = lambda gen, device: tree_from_flat({
            k: v.float() for k, v in flatten_paths(init(gen, device)).items()})
    return model


def _data(model, batch=4, seq=16):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    return SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                       batch=batch, seq_len=seq), "cpu")


def _trainer(model, mesh, d, steps=STEPS, **kw):
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    kw.setdefault("ckpt_every", 1000)
    kw.setdefault("log_every", 1000)
    mp = kw.pop("mp", None)
    return Trainer(model, OptConfig(lr=LR, warmup_steps=1, total_steps=10),
                   mesh, TrainerConfig(total_steps=steps, ckpt_dir=d, **kw),
                   mp=mp, device="cpu")


def _steps(tr, data, steps=STEPS, batches=None):
    """``steps`` train steps from a fresh init; (params, state, losses,
    grad norms, the whole first moments after the first step)."""
    _, p, o = tr.init_or_resume(0)
    losses, norms, mu1 = [], [], None
    for s in range(steps):
        b = data.batch_at(s) if batches is None else batches[s]
        p, o, m = tr.train_step(p, o, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if mu1 is None:
            mu1 = {k: v.clone() for k, v in _whole(tr, o, True).items()
                   if k.startswith("mu/")}
    return p, o, losses, norms, mu1


def _whole(tr, tree, state=False) -> dict:
    """The whole leaves of a mesh trainer's (or a plain) tree."""
    from repro_torch.distributed import sharding
    from repro_torch.nn.spec import flatten_paths
    flat = flatten_paths(tree)
    if tr.layout is None:
        return flat
    specs = tr.shards.state if state else tr.shards.params
    return {k: sharding.gather_leaf(v, specs[k], tr.layout)
            for k, v in flat.items()}


def _parity(ref, got, tol, lr=LR, steps=STEPS) -> dict:
    """Hold a mesh run ``got`` to the single-rank run ``ref`` (each
    ``(params, state, losses, norms, first moments after step 1)`` with
    whole leaves)."""
    rp, rs, rl, rn, rm = ref
    gp, gs, gl, gn, gm = got
    for a, b in zip(rl, gl):
        assert abs(a - b) <= tol["loss"] * abs(a), (rl, gl)
    for a, b in zip(rn, gn):
        assert abs(a - b) <= tol["gnorm"] * abs(a), (rn, gn)
    worst_p = 0.0
    for k, v in rp.items():
        d = float((gp[k].float() - v.float()).abs().max())
        assert d <= 2 * lr * steps, (k, d)
        worst_p = max(worst_p, d)
    worst_mu = {}
    for name, want, have, rtol in (("step1", rm, gm, tol["mu1"]),
                                   ("last", rs, gs, tol["mu"])):
        worst = 0.0
        for k, v in (want or {}).items():
            if k.startswith("mu/"):
                n = float(v.float().norm())
                d = float((have[k].float() - v.float()).norm())
                assert d <= rtol * n + 1e-12, (name, k, d / max(n, 1e-30))
                worst = max(worst, d / max(n, 1e-30))
        worst_mu[name] = worst
    bitwise = all(torch.equal(gp[k], v) for k, v in rp.items()) and rl == gl
    return {"losses": [rl, gl], "grad_norms": [rn, gn],
            "max_param_diff": worst_p, "max_mu_rel": worst_mu,
            "bitwise": bitwise}


def _single_and_mesh(model, mesh, tmp, data=None, batches=None, **kw):
    data = data or _data(model)
    ref_tr = _trainer(model, None, os.path.join(tmp, "single"), **kw)
    rp, ro, rl, rn, rm = _steps(ref_tr, data, batches=batches)
    tr = _trainer(model, mesh, os.path.join(tmp, "mesh"), **kw)
    gp, go, gl, gn, gm = _steps(tr, data, batches=batches)
    ref = (_whole(ref_tr, rp), _whole(ref_tr, ro, True), rl, rn, rm)
    got = (_whole(tr, gp), _whole(tr, go, True), gl, gn, gm)
    return ref, got, tr, go


def _moment_shapes(tr, state) -> dict:
    from repro_torch.nn.spec import flatten_paths
    return {k: list(v.shape) for k, v in flatten_paths(state).items()
            if k.startswith("mu/")}


def _step_case(name, mesh, tmp):
    _, a, shape = name.split("-")
    bf16 = a.endswith("bf16")
    arch, kw = ARCHS[a[:-4] if bf16 else a]
    model = _model(arch, kw, "bfloat16" if bf16 else "float32")
    ref, got, tr, go = _single_and_mesh(model, mesh, tmp)
    res = _parity(ref, got, TOL_BF16 if bf16 else TOL)
    res["moments"] = _moment_shapes(tr, go)
    res["coords"] = tr.layout.coords
    return res


def _one_rank_case(mesh, tmp):
    """A 1x1 mesh of one rank: the single-rank trainer's bits, for each of
    the three block kinds."""
    out = {}
    for a, (arch, kw) in ARCHS.items():
        ref, got, _, _ = _single_and_mesh(_model(arch, kw), mesh,
                                          os.path.join(tmp, a))
        out[a] = _parity(ref, got, TOL)["bitwise"]
    return out


def _micro_case(name, mesh, tmp):
    model = _model("llama3_1b", {})
    data = _data(model, batch=8)
    ref, got, _, _ = _single_and_mesh(model, mesh, tmp, data=data,
                                      n_microbatches=2)
    return _parity(ref, got, TOL)


def _spiky_batches(model, steps=STEPS):
    """Batches whose rows 2-3 (data shard 1 of 2) alone hold token 7, whose
    embedding row the case makes the largest activation of the batch."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(steps):
        tok = rng.integers(8, model.cfg.vocab_size, size=(4, 17))
        tok[2:, 5] = 7
        t = torch.from_numpy(tok.astype(np.int32))
        out.append({"tokens": t[:, :-1].contiguous(),
                    "labels": t[:, 1:].contiguous()})
    return out


def _fp8_case(name, mesh, tmp):
    from repro_torch.quant import qtensor
    model = _model("llama3_1b", {})
    batches = _spiky_batches(model)
    # token 7's embedding: one large feature, so that after the norm its
    # row holds the largest value of q_proj's input by far
    model_init = model.init

    def init(gen, device):
        p = model_init(gen, device)
        w = p["embed"]["w"]
        with torch.no_grad():
            w[7].zero_()
            w[7, 3] = 50.0
        return p
    model.init = init
    ref, got, _, _ = _single_and_mesh(model, mesh, tmp, batches=batches,
                                      mp=FP8_PLAN)
    res = _parity(ref, got, TOL)
    # the same mesh run with the activations' amax left rank-local over
    # ``data``: the scales of shard 0 differ, and so does the loss
    amax_over = qtensor.amax_over
    qtensor.amax_over = (lambda x, dims=None, over_data=False:
                         amax_over(x, dims, False))
    try:
        tr = _trainer(model, mesh, os.path.join(tmp, "local"), mp=FP8_PLAN)
        _, _, local, _, _ = _steps(tr, _data(model), batches=batches)
    finally:
        qtensor.amax_over = amax_over
    res["local_amax_losses"] = local
    return res


def _elastic_case(name, mesh, tmp, quad41):
    """Saved at (2,2) after 4 steps (checkpoints at 2 and 4); restored onto
    (4,1) and onto no mesh; the bytes against a single-rank save of the
    same values; resumed on (4,1) to 6 against a straight single-rank 6."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    model = _model("llama3_1b", {})
    data = _data(model)
    d = os.path.join(tmp, "elastic")           # shared by the four ranks
    tr = _trainer(model, mesh, d, steps=4, ckpt_every=2)
    p, o, _ = tr.fit(data)
    saved = {**{f"params/{k}": v for k, v in _whole(tr, p).items()},
             **{f"opt/{k}": v for k, v in _whole(tr, o, True).items()}}
    res = {"steps": CheckpointManager(d).all_steps()}
    # onto (4,1)
    tr41 = _trainer(model, quad41, d, steps=6, ckpt_every=1000)
    step, p41, o41 = tr41.init_or_resume(0)
    got = {**{f"params/{k}": v for k, v in _whole(tr41, p41).items()},
           **{f"opt/{k}": v for k, v in _whole(tr41, o41, True).items()}}
    res["step_41"] = step
    res["bitwise_41"] = all(torch.equal(got[k], v) for k, v in saved.items())
    # onto no mesh
    _, tree, _ = CheckpointManager(d).restore(4, device="cpu")
    flat = flatten_paths(tree)
    res["bitwise_none"] = flat.keys() == saved.keys() and all(
        torch.equal(flat[k], v) for k, v in saved.items())
    # a single-rank save of the same values: the same bytes
    if dist.get_rank() == 0:
        one = os.path.join(tmp, "one_rank")
        CheckpointManager(one).save(4, tree_from_flat(saved),
                                    extra={"loss": 0.0})
        with open(os.path.join(d, "step_0000000004", "arrays.npz"),
                  "rb") as f:
            a = f.read()
        with open(os.path.join(one, "step_0000000004", "arrays.npz"),
                  "rb") as f:
            b = f.read()
        res["bytes_equal"] = a == b
        res["bytes"] = len(a)
    # resumed on (4,1) to step 6, against a straight single-rank 6
    p41, o41, _ = tr41.run(data, step, p41, o41)
    ref_tr = _trainer(model, None, os.path.join(tmp, "straight"), steps=6)
    rp, ro, _, _, _ = _steps(ref_tr, data, steps=6)
    res["resumed"] = _parity(
        (_whole(ref_tr, rp), flatten_paths(ro), [], [], None),
        (_whole(tr41, p41), _whole(tr41, o41, True), [], [], None), TOL,
        steps=6)
    dist.barrier()
    return res


def _psum_case(name, mesh, tmp):
    """``compressed_psum`` over ``data`` of the (4,1) mesh, rank r holding
    input r of ``_psum_inputs``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.distributed.grad_compress import compressed_psum
    x = torch.from_numpy(_psum_inputs()[dist.get_rank()])
    out = {}
    with sharding.serving_layout_scope(sharding.training_layout(mesh)):
        for fmt in PSUM_FORMATS:
            out[fmt] = compressed_psum(x, "data", fmt).numpy().tolist()
    return out


def _psum_inputs() -> np.ndarray:
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (WORLD, 6, 40)).astype(np.float32)
    x[2, 1, 3] = 7.5            # the amax on rank 2
    return x


def _straggler_case(name, mesh, tmp):
    """Rank 3's 8th step takes 10 s on its clock, every other step of every
    rank 1 s: each rank sees the slowest step and checkpoints at 8."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    model = _model("llama3_1b", {})
    d = os.path.join(tmp, "straggler")
    tr = _trainer(model, mesh, d, steps=20, ckpt_every=100,
                  abort_on_straggler=True,
                  metrics_path=os.path.join(d, "metrics.jsonl"))
    slow = 10.0 if dist.get_rank() == 3 else 1.0
    ticks = iter(np.cumsum([0.0] + [1.0] * 14 + [slow] + [1.0] * 40))
    tr.clock = lambda: float(next(ticks))
    code = None
    try:
        tr.fit(_data(model))
    except SystemExit as e:
        code = e.code
    dist.barrier()
    recs = []
    if dist.get_rank() == 0:
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    return {"exit": code, "steps": CheckpointManager(d).all_steps(),
            "stragglers": [r for r in recs if r.get("event")]}


def _launcher_case(name, mesh, tmp):
    """The launcher's main on the four ranks (it destroys the group)."""
    import torch.distributed as dist
    from repro_torch.launch import train as launcher
    buf = io.StringIO()
    d = os.path.join(tmp, "launcher")
    with contextlib.redirect_stdout(buf):
        launcher.main(["--smoke", "--device", "cpu", "--mesh-data", "2",
                       "--mesh-model", "2", "--steps", "3", "--batch", "4",
                       "--seq", "16", "--ckpt-dir", d])
    assert not dist.is_initialized()
    return {"stdout": buf.getvalue(), "steps": sorted(os.listdir(d))}


_RUNNERS = {"step": _step_case, "micro": _micro_case, "fp8": _fp8_case,
            "psum": _psum_case, "straggler": _straggler_case,
            "launcher": _launcher_case}


def _run(name, fn, *args) -> dict:
    t0 = time.perf_counter()
    try:
        res = fn(*args)
        res = res if isinstance(res, dict) else {"value": res}
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
    quad41 = DeviceMesh("cpu", [[0], [1], [2], [3]], mesh_dim_names=names)
    # every rank builds every smaller mesh (their groups need all ranks)
    pair = {(2, 1): [DeviceMesh("cpu", [[0], [1]], mesh_dim_names=names),
                     DeviceMesh("cpu", [[2], [3]], mesh_dim_names=names)],
            (1, 2): [DeviceMesh("cpu", [[0, 1]], mesh_dim_names=names),
                     DeviceMesh("cpu", [[2, 3]], mesh_dim_names=names)]}
    one = [DeviceMesh("cpu", [[r]], mesh_dim_names=names)
           for r in range(WORLD)]
    results = {}
    shared = os.path.join(out_dir, "shared")
    with tempfile.TemporaryDirectory(prefix=f"rank{rank}_") as tmp:
        mine = rank // 2
        for i, name in enumerate(PAIR_CASES):
            if i % 2 != mine:
                continue
            shape = tuple(int(v) for v in name.rsplit("-", 1)[1].split("x"))
            results[name] = _run(name, _RUNNERS[name.split("-")[0]], name,
                                 pair[shape][mine],
                                 os.path.join(tmp, name))
        results["one-1x1"] = _run("one-1x1", _one_rank_case, one[rank],
                                  os.path.join(tmp, "one"))
        dist.barrier()
        for name in QUAD_CASES:
            kind = name.split("-")[0]
            where = os.path.join(shared, name) if kind in (
                "elastic", "straggler", "launcher") else os.path.join(tmp,
                                                                      name)
            if kind == "elastic":
                results[name] = _run(name, _elastic_case, name, quad, where,
                                     quad41)
            elif kind == "psum":
                results[name] = _run(name, _psum_case, name, quad41, where)
            else:
                results[name] = _run(name, _RUNNERS[kind], name, quad, where)
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
    with tempfile.TemporaryDirectory(prefix="train_mesh_ranks_") as out_dir:
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


def _results(ranks, name) -> list:
    got = [ranks[r][name] for r in range(WORLD) if name in ranks[r]]
    assert got, name
    for res in got:
        assert res["ok"], res.get("error")
    return got


@pytest.mark.parametrize("name", [c for c in PAIR_CASES + QUAD_CASES
                                  if c.startswith("step-")])
def test_step_parity(ranks, name):
    for res in _results(ranks, name):
        assert len(res["losses"][1]) == STEPS


def test_one_rank_mesh_is_bitwise(ranks):
    for res in _results(ranks, "one-1x1"):
        assert res == {"llama": True, "mla": True, "hybrid": True,
                       "ok": True, "seconds": res["seconds"]}


def test_fp8_plan_scales_span_the_data_shards(ranks):
    for res in _results(ranks, "fp8-2x2"):
        ref = res["losses"][0]
        # a rank-local amax over data gives other losses
        assert any(abs(a - b) > 10 * TOL["loss"] * abs(a)
                   for a, b in zip(ref, res["local_amax_losses"])), res


def test_microbatches_over_data(ranks):
    _results(ranks, "micro-2x1")


@pytest.mark.parametrize("name", [c for c in PAIR_CASES + QUAD_CASES
                                  if c.startswith("step-")])
def test_zero_moment_blocks(ranks, name):
    """Every rank's AdamW moments are its block under the reference's
    ``zero_partition_spec`` on a fake mesh of the same axes."""
    from repro.distributed import sharding as jshd
    from repro.models.registry import get_model as jget
    from repro.train import optim as jo
    _, a, shape = name.split("-")
    arch, kw = ARCHS[a[:-4] if a.endswith("bf16") else a]
    d, m = (int(v) for v in shape.split("x"))

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": d, "model": m}

    jmodel = jget(arch, smoke=True, **kw)
    jspecs = jo.state_specs(jmodel.param_specs(), jo.OptConfig())
    sizes = {"data": d, "model": m}
    for res in _results(ranks, name):
        for path, got in res["moments"].items():
            spec = jshd.zero_partition_spec(jspecs[path], FakeMesh())
            want = list(jspecs[path].shape)
            for dim, p in enumerate(spec):
                for ax in (p if isinstance(p, tuple) else (p,)):
                    if ax is not None:
                        want[dim] //= sizes[ax]
            assert got == want, (path, got, want, spec)
        # a 2-D leaf of every model is split over data
        assert any(s != list(jspecs[p].shape) for p, s in
                   res["moments"].items()), name


def test_elastic_restore_bitwise(ranks):
    for res in _results(ranks, "elastic-2x2"):
        assert res["steps"] == [2, 4]
        assert res["step_41"] == 4
        assert res["bitwise_41"] and res["bitwise_none"]


def test_mesh_checkpoint_bytes_equal_a_single_rank_save(ranks):
    res = ranks[0]["elastic-2x2"]
    assert res["ok"], res.get("error")
    assert res["bytes_equal"] and res["bytes"] > 0


def test_resume_on_another_mesh(ranks):
    for res in _results(ranks, "elastic-2x2"):
        assert res["resumed"]["max_param_diff"] <= 2 * LR * 6


def test_straggler_exits_17_on_every_rank(ranks):
    for res in _results(ranks, "straggler-2x2"):
        assert res["exit"] == 17 and res["steps"] == [8]
    recs = ranks[0]["straggler-2x2"]["stragglers"]
    assert recs == [{"event": "straggler", "step": 8, "dt": 10.0,
                     "median": 1.0}]


@pytest.mark.parametrize("fmt", PSUM_FORMATS)
def test_compressed_psum_matches_reference(ranks, fmt):
    """The port's four gloo ranks against the reference's function under
    ``jax.vmap(..., axis_name="data")`` on the same four inputs: every
    rank's sum within one f32 ulp of the reference's (measured: equal)."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import grad_compress as jgc
    x = _psum_inputs()
    want = np.asarray(jax.vmap(lambda v: jgc.compressed_psum(v, "data", fmt),
                               axis_name="data")(jnp.asarray(x)))
    for r in range(WORLD):
        res = ranks[r]["psum-4x1"]
        assert res["ok"], res.get("error")
        got = np.asarray(res[fmt], np.float32)
        np.testing.assert_array_max_ulp(got, want[r], maxulp=1)
    assert not np.array_equal(want[0], x.sum(0))      # the fp8 rounding


def test_launcher_trains_over_a_mesh(ranks):
    out = [ranks[r]["launcher-2x2"] for r in range(WORLD)]
    for res in out:
        assert res["ok"], res.get("error")
        assert res["steps"] == ["metrics.jsonl", "step_0000000003"]
    assert "[train] arch=llama3_1b" in out[0]["stdout"]
    assert "mesh=(2,2)" in out[0]["stdout"]
    assert "[train] done: final loss" in out[0]["stdout"]
    assert all(not res["stdout"] for res in out[1:])    # rank 0 prints


def test_ranks_report_alike(ranks):
    """Both ranks of a pair, and all four, saw the same outcome; the ranks
    finished within the file's limit."""
    skip = ("seconds", "moments", "coords", "stdout", "bytes_equal", "bytes")
    for name in PAIR_CASES + QUAD_CASES[:-1]:
        got = [ranks[r][name] for r in range(WORLD) if name in ranks[r]]
        keys = [{k: v for k, v in g.items() if k not in skip and
                 not (name.startswith("psum") and k in PSUM_FORMATS)}
                for g in got]
        if name.startswith("straggler"):
            keys = [{k: v for k, v in k_.items() if k != "stragglers"}
                    for k_ in keys]
        assert all(k == keys[0] for k in keys), name
    assert ranks["seconds"] < JOIN_TIMEOUT_S
