"""FSDP (ZeRO-3) over a (data, model) mesh on CPU ranks: ``FSDP_RULES`` split
every weight's ``embed`` dim over ``data`` as well, the model gathers a
split leaf where it uses it and a train step reduce-scatters its gradient.
Each case is held to the same step under the default rules on the same
mesh, which ``test_torch_train_mesh.py`` and ``test_torch_serve_mesh.py``
hold to one rank (and through them to the reference); every rank's blocks
are held to the reference's ``FSDP_RULES`` placement.

Four gloo ranks are spawned once for the file (one intra-op thread each; a
free port; a hard timeout on the group's start and on the join). Ranks 0-1
and 2-3 form two pairs, each running half of the (2,1) cases on its own
mesh; then all four run the (2,2) and (4,1) cases. The cases:

* training, three AdamW steps of llama3_1b's smoke config in float32:
  plain, under an fp8 plan (quantized weights' cotangents summed over
  ``data`` before the cast's backward, then reduce-scattered), and as 4
  stacked layers with two-level remat (``scan_layers``, ``remat_group=2``:
  the dry run's options). Against the default rules: the first step's loss
  bit-equal (the gathered weights are exact) and every leaf's first-step
  gradient block equal to the same block of the default rules' gradient,
  bit for bit at data 2 (a sum of two addends) and within 1e-6 of the
  leaf's largest gradient at data 4 (the reduce-scatter and the all-reduce
  add four addends in their own orders); the params after three steps
  equal at data 2. The first step's loss and grad norm within
  ``STEP1_TOL`` of one rank's. AdamW's moments are the params' blocks.
* training the same model in bf16 at (2,1): the reduce-scatter sums a
  split leaf's gradient in f32 and rounds it once to bf16, where the
  default rules' sum stays f32. So each split leaf's first-step gradient
  block is the default rules' block rounded to the leaf's dtype, bit for
  bit (bf16 weights rounded, f32 norm scales and every other leaf equal), the grad norm within ``2**-8`` (bf16's unit
  roundoff) of theirs, the first step's loss bit-equal, and the params
  after three steps within 2 x lr a step.
* serving at (2,2): a prefill and two decode steps through
  ``steps.mesh_step``, plain and under an fp8 plan: logits and tokens bit
  for bit those of the default rules; under the plan each planned weight
  quantized once (on the block, ``weight_cache.quantize_count``) over the
  three steps, and its gathered codes those of the whole weight.

Beside the ranks, on the dry run's fake group: a 12-layer smoke train
cell's traced peak under ``FSDP_RULES`` lies below the default rules' by
at least the split leaves' params and f32 gradients a rank would no longer
hold, less one layer's gathered weights (a step that gathered the whole
tree up front would not: measured at 12 layers, 2.43 MB against the 2.62
MB bound, where the gather at use gives 4.68 MB)."""
import datetime
import json
import math
import os
import socket
import tempfile
import time
import traceback

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

WORLD = 4
JOIN_TIMEOUT_S = 150
GROUP_TIMEOUT_S = 60
STEPS = 3
LR = 1e-3
# a mesh's first step against one rank's, relative (mesh_probe.py's)
STEP1_TOL = {"loss": 1e-3, "grad_norm": 1e-2}
GRAD_TOL_DATA4 = 1e-6
FP8_PLAN = {"layers/0/attn/q_proj": "fp8_e4m3",
            "layers/0/attn/o_proj": "fp8_e4m3",
            "layers/1/mlp/down_proj": "fp8_e4m3",
            "layers/1/mlp/up_proj": "fp8_e4m3",
            "layers/1/attn/qk_matmul": "fp8_e4m3", "lm_head": "fp8_e4m3"}
KINDS = ("llama", "fp8", "scan")
PAIR_CASES = [f"train-{k}-2x1" for k in KINDS + ("bf16",)]
QUAD_CASES = ([f"train-{k}-{s}" for s in ("2x2", "4x1") for k in KINDS]
              + ["serve-plain-2x2", "serve-fp8-2x2"])
TRAIN_CASES = [c for c in PAIR_CASES + QUAD_CASES if c.startswith("train")]
SERVE_ROWS, SERVE_PROMPT, SERVE_DECODE = 4, 12, 2


# ---------------------------------------------------------------------------
# what runs inside the ranks
# ---------------------------------------------------------------------------


def _model(kind, dtype="float32"):
    """llama3_1b's smoke config; ``scan``: 4 stacked layers, remat in groups
    of 2. In float32 its weights too."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    kw = (dict(scan_layers=True, remat=True, remat_group=2, n_layers=4)
          if kind == "scan" else {})
    model = get_model("llama3_1b", smoke=True, dtype=dtype, **kw)
    if dtype == "float32":
        init = model.init
        model.init = lambda gen, device: tree_from_flat({
            k: v.float() for k, v in flatten_paths(init(gen, device)).items()})
    return model


def _whole_params(model) -> dict:
    from repro_torch.nn.spec import default_generator, flatten_paths
    return flatten_paths(model.init(default_generator(0, "cpu"), "cpu"))


def _run_train(model, mesh, rules, mp, batches) -> dict:
    """``len(batches)`` steps from seed 0's params: losses, grad norms, the
    first step's gradients and the last params (whole leaves), the moment
    blocks' shapes and the params' blocks' shapes."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    from repro_torch.train import optim
    cfg = optim.OptConfig(lr=LR, warmup_steps=1, total_steps=10)
    step = steps.make_train_step(model, cfg, mp=mp, mesh=mesh, rules=rules)
    sh = step.shards
    p = _whole_params(model)
    o = flatten_paths(optim.init_state(model.param_specs(), cfg, "cpu"))
    if sh is not None:
        p, o = sh.local(sh.params, p), sh.local(sh.state, o)
    p, o = tree_from_flat(p), tree_from_flat(o)

    def whole(flat: dict, specs: dict) -> dict:
        if sh is None:
            return flat
        return {k: sharding.gather_leaf(v, specs[k], sh.layout)
                for k, v in flat.items()}

    grads = []
    real = optim.apply_updates

    def spy(params, g, *a):
        if not grads:
            grads.append(whole({k: v.clone() for k, v in
                                flatten_paths(g).items()}, sh.params
                               if sh is not None else None))
        return real(params, g, *a)

    losses, norms = [], []
    optim.apply_updates = spy
    try:
        for b in batches:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        optim.apply_updates = real
    return {"losses": losses, "norms": norms, "grads": grads[0],
            "params": whole(flatten_paths(p),
                            sh.params if sh is not None else None),
            "moments": {k: list(v.shape) for k, v in flatten_paths(o).items()
                        if k.startswith("mu/")},
            "blocks": {k: list(v.shape) for k, v in
                       flatten_paths(p).items()}}


def _train_case(name, mesh, tmp):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.distributed.sharding import FSDP_RULES
    _, kind, shape = name.split("-")
    data = int(shape.split("x")[0])
    bf16 = kind == "bf16"
    model = (_model("llama", dtype="bfloat16") if bf16 else _model(kind))
    mp = FP8_PLAN if kind == "fp8" else None
    src = SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                      batch=4, seq_len=16), "cpu")
    batches = [src.batch_at(s) for s in range(STEPS)]
    default = _run_train(model, mesh, None, mp, batches)
    fsdp = _run_train(model, mesh, FSDP_RULES, mp, batches)
    one = _run_train(model, None, None, mp, batches[:1])
    worst = 0.0
    grads_bitwise = True
    for k, g in default["grads"].items():
        f = fsdp["grads"][k]
        if fsdp["blocks"][k] != default["blocks"][k]:   # a split leaf's:
            g = g.to(fsdp["params"][k].dtype).float()   # in its dtype
        grads_bitwise = grads_bitwise and torch.equal(f, g)
        scale = max(float(g.abs().max()), 1e-30)
        worst = max(worst, float((f - g).abs().max()) / scale)
    params_bitwise = all(torch.equal(fsdp["params"][k], v)
                         for k, v in default["params"].items())
    params_diff = max(float((fsdp["params"][k] - v).abs().max())
                      for k, v in default["params"].items())
    return {"data": data, "bf16": bf16,
            "losses": [default["losses"], fsdp["losses"]],
            "norms": [default["norms"], fsdp["norms"]],
            "one_rank": [one["losses"][0], one["norms"][0]],
            "grads_bitwise": grads_bitwise, "grad_rel": worst,
            "params_bitwise": params_bitwise, "params_diff": params_diff,
            "moments": fsdp["moments"], "blocks": fsdp["blocks"],
            "default_moments": default["moments"]}


def _serve_params(model, mesh, rules) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.nn.spec import tree_from_flat
    sizes = sharding.axis_sizes(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    specs = model.param_specs()
    return tree_from_flat({
        k: sharding.local_shard(v, sharding.partition_spec(specs[k], mesh,
                                                           rules),
                                sizes, coords)
        for k, v in _whole_params(model).items()})


def _serve_run(model, mesh, rules, mp, params):
    """A prefill of ``SERVE_PROMPT`` tokens and ``SERVE_DECODE`` greedy
    decode steps of ``SERVE_ROWS`` rows: (logits, tokens) of each step."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, steps
    from repro_torch.serve.parallel import CACHE_RULES
    layout = sharding.ServingMeshLayout(mesh=mesh, data=2, model=2,
                                        n_slots=SERVE_ROWS, rules=rules)
    prefill = steps.mesh_step(steps.make_prefill_step(model, mp=mp), layout)
    decode = steps.mesh_step(steps.make_decode_step(model, mp=mp), layout)
    S = SERVE_PROMPT + SERVE_DECODE
    caches = model.assemble_cache_tree(dryrun._local_tree(
        model.cache_specs(SERVE_ROWS, S), mesh, CACHE_RULES, "cpu"))
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, model.cfg.vocab_size,
                           (SERVE_ROWS, SERVE_PROMPT), generator=g,
                           dtype=torch.int32)
    out = []
    with torch.no_grad():
        logits, caches, nxt = prefill(params, caches, tokens)
        out.append((logits.clone(), nxt.clone()))
        for i in range(SERVE_DECODE):
            pos = torch.tensor(SERVE_PROMPT + i, dtype=torch.int32)
            logits, caches, nxt = decode(params, caches, nxt[:, None], pos)
            out.append((logits.clone(), nxt.clone()))
    return out


def _serve_case(name, mesh, tmp):
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import FSDP_RULES
    from repro_torch.nn.spec import flatten_paths
    from repro_torch.quant import qops, qtensor, weight_cache
    from repro_torch.quant.qops import QuantContext
    kind = name.split("-")[1]
    model = _model("llama", dtype="bfloat16")
    mp = FP8_PLAN if kind == "fp8" else None
    runs = {}
    params = {}
    for label, rules in (("default", None), ("fsdp", FSDP_RULES)):
        params[label] = _serve_params(model, mesh, rules)
        runs[label] = _serve_run(model, mesh, rules, mp, params[label])
    res = {"logits_bitwise": all(
        torch.equal(a[0], b[0]) for a, b in zip(runs["default"],
                                                 runs["fsdp"])),
        "tokens_bitwise": all(torch.equal(a[1], b[1]) for a, b in
                              zip(runs["default"], runs["fsdp"])),
        "tokens": [t.tolist() for _, t in runs["fsdp"]]}
    if mp is None:
        return res
    # each planned weight: quantized once on its block over the three steps;
    # its gathered codes those of the default rules' (whole over data)
    flat = flatten_paths(params["fsdp"])
    whole = flatten_paths(params["default"])
    layout = sharding.ServingMeshLayout(mesh=mesh, data=2, model=2,
                                        n_slots=SERVE_ROWS, rules=FSDP_RULES)
    plain = sharding.ServingMeshLayout(mesh=mesh, data=2, model=2,
                                       n_slots=SERVE_ROWS)
    dims = sharding.data_split_dims(model.param_specs(), layout)
    ctx = QuantContext(mode="mp", mp=mp, act_scale_token=True)
    counts, codes_equal = {}, {}
    for op in mp:
        path = "embed/w" if op == "lm_head" else f"{op}/w"
        if path not in flat:
            continue                            # a BGEMM
        blk = flat[path]
        counts[op] = weight_cache.quantize_count(blk, ("fsdp", "fp8_e4m3"))
        with torch.no_grad(), sharding.serving_layout_scope(layout):
            got, gctx = qops.gathered_weight(ctx, op, blk, dims[path])
        with torch.no_grad(), sharding.serving_layout_scope(plain):
            want = qops._weight_operand(whole[path], "fp8_e4m3", None)
            q = qtensor.quantize(whole[path], "fp8_e4m3")
        with torch.no_grad(), sharding.serving_layout_scope(layout):
            qb, _ = weight_cache.cached(blk, ("fsdp", "fp8_e4m3"),
                                        lambda: None)
            codes = sharding.dp_gather_param(qb.data, dims[path])
        codes_equal[op] = bool(torch.equal(got, want) and torch.equal(
            codes.view(torch.uint8), q.data.view(torch.uint8))
            and gctx.gathered == {op} and not ctx.gathered)
        counts[op] = max(counts[op], weight_cache.quantize_count(
            blk, ("fsdp", "fp8_e4m3")))
    res["quantize_counts"] = counts
    res["codes_equal"] = codes_equal
    return res


def _run(fn, *args) -> dict:
    t0 = time.perf_counter()
    try:
        res = fn(*args)
        res["ok"] = True
    except Exception:                                # noqa: BLE001
        res = {"ok": False, "error": traceback.format_exc()[-3000:]}
    res["seconds"] = time.perf_counter() - t0
    return res


def _jsonable(res: dict) -> dict:
    return {k: v for k, v in res.items() if not isinstance(v, torch.Tensor)}


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
    pairs = [DeviceMesh("cpu", [[0], [1]], mesh_dim_names=names),
             DeviceMesh("cpu", [[2], [3]], mesh_dim_names=names)]
    runners = {"train": _train_case, "serve": _serve_case}
    results = {}
    with tempfile.TemporaryDirectory(prefix=f"fsdp_rank{rank}_") as tmp:
        mine = rank // 2
        for i, name in enumerate(PAIR_CASES):
            if i % 2 == mine:
                results[name] = _run(runners[name.split("-")[0]], name,
                                     pairs[mine], tmp)
        dist.barrier()
        for name in QUAD_CASES:
            mesh = quad41 if name.endswith("4x1") else quad
            results[name] = _run(runners[name.split("-")[0]], name, mesh,
                                 tmp)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({k: _jsonable(v) for k, v in results.items()}, f)
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
    with tempfile.TemporaryDirectory(prefix="fsdp_ranks_") as out_dir:
        ctx = mp.start_processes(_worker, args=(_free_port(), out_dir),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"FSDP ranks did not finish within "
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


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_train_step_matches_default_rules(ranks, name):
    for res in _results(ranks, name):
        (dl, fl), (dn, fn) = res["losses"], res["norms"]
        assert fl[0] == dl[0], res["losses"]
        if res["data"] == 2:
            assert res["grads_bitwise"], res["grad_rel"]
        else:
            assert res["grad_rel"] <= GRAD_TOL_DATA4, res["grad_rel"]
        if res["data"] == 2 and not res["bf16"]:
            assert res["params_bitwise"], res["params_diff"]
        else:
            assert res["params_diff"] <= 2 * LR * STEPS, res["params_diff"]
        norm_tol = 2 ** -8 if res["bf16"] else 1e-6
        assert abs(fn[0] - dn[0]) <= norm_tol * dn[0], res["norms"]
        ol, on = res["one_rank"]
        assert abs(fl[0] - ol) <= STEP1_TOL["loss"] * abs(ol), (fl, ol)
        assert abs(fn[0] - on) <= STEP1_TOL["grad_norm"] * on, (fn, on)
        assert all(math.isfinite(x) for x in fl + fn)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_moments_are_the_params_blocks(ranks, name):
    """ZeRO-3: every leaf's AdamW moment is the shape of its param's block
    (each split over data already), and smaller than under the default
    rules' ZeRO-1 nowhere."""
    for res in _results(ranks, name):
        for path, shape in res["moments"].items():
            assert shape == res["blocks"][path[3:]], path
            assert math.prod(shape) <= math.prod(
                res["default_moments"][path]), path


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_blocks_are_the_reference_fsdp_blocks(ranks, name):
    """Every rank's param blocks are its blocks under the reference's
    ``partition_spec`` with its ``FSDP_RULES``, and its AdamW moments under
    its ``zero_partition_spec``, on a fake mesh of the same axes."""
    from repro.distributed import sharding as jshd
    from repro.models.registry import get_model as jget
    from repro.train import optim as jo
    _, kind, shape = name.split("-")
    d, m = (int(v) for v in shape.split("x"))

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": d, "model": m}

    kw = (dict(scan_layers=True, remat=True, remat_group=2, n_layers=4)
          if kind == "scan" else {})
    specs = jget("llama3_1b", smoke=True, **kw).param_specs()
    state = jo.state_specs(specs, jo.OptConfig())
    sizes = {"data": d, "model": m}

    def block(spec, pspec) -> list:
        out = list(spec.shape)
        for dim, p in enumerate(pspec):
            for ax in (p if isinstance(p, tuple) else (p,)):
                if ax is not None:
                    out[dim] //= sizes[ax]
        return out

    for res in _results(ranks, name):
        assert res["blocks"] == {
            k: block(s, jshd.partition_spec(s, FakeMesh(), jshd.FSDP_RULES))
            for k, s in specs.items()}
        assert res["moments"] == {
            k: block(s, jshd.zero_partition_spec(s, FakeMesh(),
                                                 jshd.FSDP_RULES))
            for k, s in state.items() if k.startswith("mu/")}


@pytest.mark.parametrize("kind", ["plain", "fp8"])
def test_serving_steps_match_default_rules(ranks, kind):
    got = _results(ranks, f"serve-{kind}-2x2")
    for res in got:
        assert res["logits_bitwise"] and res["tokens_bitwise"], res
        assert res["tokens"] == got[0]["tokens"]


def test_planned_weights_quantized_once_on_their_blocks(ranks):
    for res in _results(ranks, "serve-fp8-2x2"):
        assert res["quantize_counts"] == {
            "layers/0/attn/q_proj": 1, "layers/0/attn/o_proj": 1,
            "layers/1/mlp/down_proj": 1, "layers/1/mlp/up_proj": 1,
            "lm_head": 1}, res["quantize_counts"]
        assert all(res["codes_equal"].values()), res["codes_equal"]


def test_ranks_finish_in_time(ranks):
    assert ranks["seconds"] < JOIN_TIMEOUT_S


def test_rules_without_a_mesh_raise():
    """FSDP never falls back in silence: rules with no mesh to place the
    params over are refused."""
    from repro_torch.distributed.sharding import FSDP_RULES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optim import OptConfig
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(_model("llama"), OptConfig(), rules=FSDP_RULES)


# ---------------------------------------------------------------------------
# the peak on the dry run's fake group
# ---------------------------------------------------------------------------


def test_fsdp_peak_gathers_one_layer_at_a_time():
    """The traced peak of a 12-layer smoke train cell (scan segments,
    remat; 4 microbatches of 2 rows over a fake (2, 2) mesh) under
    ``FSDP_RULES`` is below the default rules' by at least the bytes a
    rank no longer holds: half of each split leaf's block (its param and
    its f32 gradient accumulator), less one layer's gathered weights."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    assert not dist.is_initialized()
    mesh_axes = {"data": 2, "model": 2}
    cell = ShapeCell("train_4k", "train", 16, 8)
    peaks = {}
    for name, rules in (("default", shd.DEFAULT_RULES),
                        ("fsdp", shd.FSDP_RULES)):
        rec = dryrun.run_cell("llama3_1b", "train_4k", False,
                              overrides={"rules": rules, "n_layers": 12},
                              smoke=True, cell=cell, mesh_axes=mesh_axes)
        assert rec["status"] == "ok"
        assert rec.get("fsdp", False) is (name == "fsdp")
        peaks[name] = rec["memory_analysis"]["peak_estimate_bytes"]
    assert not dist.is_initialized()
    plan = dryrun.plan_cell("llama3_1b", "train_4k", False,
                            overrides={"n_layers": 12}, smoke=True,
                            cell=cell, mesh_axes=mesh_axes)
    mesh = dryrun.MeshShape(mesh_axes)
    saved = layer = 0
    for path, s in plan["model"].param_specs().items():
        block = shd.local_shape(s.shape, shd.partition_spec(s, mesh),
                                mesh_axes)
        if block == shd.local_shape(
                s.shape, shd.partition_spec(s, mesh, shd.FSDP_RULES),
                mesh_axes):
            continue
        n = math.prod(block)
        saved += n // 2 * (s.dtype.itemsize + 4)
        if path.startswith("segments/"):
            layer += n // s.shape[0] * s.dtype.itemsize
    assert layer > 0
    assert peaks["default"] - peaks["fsdp"] >= saved - layer, (peaks, saved,
                                                               layer)


def test_mla_absorbed_weight_is_never_split_over_data():
    """The absorbed MLA decode reads ``kv_b_proj``'s weight as it is
    (``nn/layers._absorb_weights``): it has no ``embed`` dim, so no rules
    split it over ``data`` and FSDP leaves it whole, while MLA's other
    projections are gathered."""
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import get_model
    specs = get_model("deepseek_v3_671b", smoke=True).param_specs()
    layout = sharding.training_layout({"data": 2, "model": 2},
                                      sharding.FSDP_RULES)
    dims = sharding.data_split_dims(specs, layout)
    kvb = [p for p in dims if p.endswith("kv_b_proj/w")]
    assert kvb and all(dims[p] is None for p in kvb)
    assert all(dims[p] is not None for p in dims
               if p.endswith(("kv_a_proj/w", "o_proj/w")))
