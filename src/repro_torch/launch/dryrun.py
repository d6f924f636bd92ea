"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): one rank's step
of every (arch x shape x mesh) cell under the production sharding, with its
memory, cost and roofline evidence.

The reference lowers and compiles each cell's jitted step over 512 host
devices and reads XLA's memory and cost analyses and HLO. The port has no
compiler to ask. It starts a fake process group of 256 ranks (``pod16x16``)
or 512 (``pod2x16x16``) in this process, as rank 0
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once and moves nothing), builds the production mesh on it
(``launch.mesh.make_production_mesh``; the ``pod`` axis joins ``data``, as
the rules name both for the batch and ZeRO) and runs this rank's step once
through the port's own mesh path: ``make_train_step(mesh=,
n_microbatches=)`` for a train cell, the prefill or decode step under the
serving layout for the others (``steps.mesh_step`` of the bare step, not
``steps.get_serving_step``, which memoizes steps on the model and refuses
the one-shot prefill over a mesh: no step bound to a fake group outlives
its cell). Params, optimizer state, caches and inputs
are ``meta`` tensors of this rank's shapes (``sharding.local_shape``):
nothing is allocated and every op computes shapes only. The group is
destroyed when the cell ends, so nothing later in the process sees it; a
cell refuses to start while another group is up.

A record holds the reference's fields, with these counterparts:

* ``trace_s`` for ``lower_s`` / ``compile_s``;
* ``memory_analysis``: this rank's argument bytes and a peak estimate, the
  most bytes of live storage at any point of the trace (:class:`LiveBytes`);
* ``cost_analysis``: the trace's FLOPs (``torch.utils.flop_counter``) and
  the bytes its matmuls read and write (the matmul-centric accounting of
  ``analysis.analytic``);
* the collectives by kind, counted where the port issues them
  (``sharding.counting_collectives``), inside and outside the layer stack;
  the trace runs every layer and microbatch, so they are totals
  (``collectives_are_totals``) that ``analysis.report.refine`` does not
  rescale;
* ``roofline`` against ``H100_SXM`` and ``backend: "fake"``.

The decisions are the reference's, with its thresholds: FSDP when the
default rules leave more than ``FSDP_THRESHOLD_BYTES`` of params on a rank,
an fp8 KV cache for a decode cell whose bf16 cache exceeds
``KV_FP8_THRESHOLD_BYTES``, ``optim.select_optimizer``, ``DRYRUN_MICRO``
microbatches and ``cell_supported``'s skips. A cell the port does not run
over a mesh raises its refusal, which names its ROADMAP item: expert (MoE)
layers and encoder-decoders (C10), Adafactor (A9d). An FSDP cell places
params and moments by ``FSDP_RULES`` and runs its step under them: the
layers gather their ``data``-split weights at use, and a train step
reduce-scatters their gradients (``sharding.dp_gather_param``).

``run_cell(..., device="cuda")`` runs the same rank's shard for real on one
card over a fake CUDA group (no collective moves anything, so no value
means anything) and times it.

CLI (the reference's): ``python -m repro_torch.launch.dryrun [--arch A]
[--shape S] [--mesh single|multi|both] [--out DIR] [--all]``; one JSON
record per cell in ``DIR`` (``experiments/dryrun``), cells with an ok or
skip record kept; the exit code is nonzero when a cell failed.
``--rules default`` traces every cell under the default rules instead of
the reference's choice (FSDP's counterfactual; records named
``...__default_rules.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import model_stats, roofline
from repro_torch.configs.shapes import SHAPES, cell_supported, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.hw.profiles import H100_SXM
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.encdec import EncDec
from repro_torch.models.registry import (ARCH_IDS, build_model, get_config,
                                         get_smoke_config)
from repro_torch.nn.spec import flatten_paths, tree_from_flat
from repro_torch.serve.parallel import CACHE_RULES
from repro_torch.train import optim

__all__ = ["ASSIGNED", "DRYRUN_OVERRIDES", "DRYRUN_MICRO",
           "FSDP_THRESHOLD_BYTES", "KV_FP8_THRESHOLD_BYTES", "MESHES",
           "MeshShape", "estimate_shard_bytes", "plan_cell", "fake_group",
           "LiveBytes", "run_cell", "main"]

ASSIGNED = [a for a in ARCH_IDS if a not in ("llama3_1b", "llama3_8b")]

# dry-run model options (scan segments; remat bounds train activation
# memory), as in the reference
DRYRUN_OVERRIDES = dict(scan_layers=True, remat=True)

# per-arch gradient-accumulation depth for train_4k (the reference's)
DRYRUN_MICRO = {"starcoder2_15b": 8, "deepseek_v3_671b": 8}

# per-rank parameter-shard budget above which the reference takes FSDP
FSDP_THRESHOLD_BYTES = 3e9
# decode cells whose bf16 KV cache would crowd a rank take an fp8 cache
KV_FP8_THRESHOLD_BYTES = 4e9

# timed steps after the warm-up of a cell run on the card: the warm-up holds
# the peak, and a shard's eager step is a sample of seconds (chip_smoke.py
# phase 28 runs four in its budget)
TIMED_STEPS = 1

# multi_pod -> (mesh name, {axis: size})
MESHES = {False: ("pod16x16", {"data": 16, "model": 16}),
          True: ("pod2x16x16", {"pod": 2, "data": 16, "model": 16})}


class MeshShape:
    """A mesh's axis names and sizes, as the sharding rules read them (no
    process group)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _build(arch: str, kind: str, overrides: dict, smoke: bool = False):
    ov = dict(overrides)
    if arch == "whisper_base":
        ov = {k: v for k, v in ov.items() if k in ("flash_min_seq",)}
    elif kind != "train":
        ov["remat"] = False
    return build_model((get_smoke_config if smoke else get_config)(arch,
                                                                   **ov))


def estimate_shard_bytes(specs: dict, mesh, rules=None) -> float:
    """Bytes of one rank's blocks of ``specs`` under ``rules``."""
    sizes = shd.axis_sizes(mesh)
    total = 0.0
    for s in specs.values():
        n = math.prod(s.shape) * s.dtype.itemsize
        denom = 1
        for part in shd.partition_spec(s, mesh, rules):
            for a in (part if isinstance(part, tuple) else (part,)):
                if a:
                    denom *= sizes[a]
        total += n / denom
    return total


def plan_cell(arch: str, shape_name: str, multi_pod: bool,
              overrides=None, *, smoke: bool = False, cell=None,
              mesh_axes=None) -> dict:
    """The reference's decisions for a cell, made without tracing:
    ``status``/``reason`` (a skip), and for a supported cell the ``model``,
    ``rules`` (``overrides["rules"]``, else FSDP's when the default rules
    leave more than ``FSDP_THRESHOLD_BYTES`` of params on a rank),
    ``param_bytes`` (per rank, under those rules), ``fsdp`` (the rules are
    ``FSDP_RULES``), ``kv_cache_dtype``, ``optimizer`` (an ``OptConfig``) and
    ``n_microbatches`` (the last two of a train cell only). ``smoke``,
    ``cell`` (a ``ShapeCell``) and ``mesh_axes`` (``{axis: size}``) stand
    in for the arch's config, the shape's cell and the mesh, to plan small
    cells."""
    cell = cell or SHAPES[shape_name]
    ok, reason = cell_supported(arch, shape_name)
    if not ok:
        return {"status": "skip", "reason": reason}
    mesh = MeshShape(mesh_axes or MESHES[multi_pod][1])
    overrides = dict(overrides or {})
    n_micro = overrides.pop("n_microbatches", DRYRUN_MICRO.get(arch, 4))
    rules_override = overrides.pop("rules", None)
    model = _build(arch, cell.kind, dict(DRYRUN_OVERRIDES, **overrides),
                   smoke)
    specs = model.param_specs()
    rules = rules_override or shd.DEFAULT_RULES
    param_bytes = estimate_shard_bytes(specs, mesh, rules)
    fsdp = rules == shd.FSDP_RULES
    if rules_override is None and param_bytes > FSDP_THRESHOLD_BYTES:
        rules = shd.FSDP_RULES
        param_bytes = estimate_shard_bytes(specs, mesh, rules)
        fsdp = True
    kv = None
    if cell.kind == "decode" and hasattr(model.cfg, "kv_cache_dtype") \
            and "kv_cache_dtype" not in overrides:
        c_specs = model.cache_specs(cell.global_batch, cell.seq_len)
        if estimate_shard_bytes(c_specs, mesh, rules) > \
                KV_FP8_THRESHOLD_BYTES:
            model = _build(arch, cell.kind,
                           dict(DRYRUN_OVERRIDES, **overrides,
                                kv_cache_dtype="fp8_e4m3"), smoke)
            kv = "fp8_e4m3"
    out = {"status": "ok", "reason": "", "model": model, "rules": rules,
           "param_bytes": param_bytes, "fsdp": fsdp, "kv_cache_dtype": kv}
    if cell.kind == "train":
        out["optimizer"] = optim.select_optimizer(
            model_stats.param_stats(model)["total"])
        out["n_microbatches"] = n_micro
    return out


def _refuse(model, kind: str) -> None:
    """The port's refusals of a cell over a mesh, by the item that lifts
    each (the train step's own, expert layers and encoder-decoders, comes
    from ``steps.refuse_mesh``; Adafactor's from ``optim.MeshShards``)."""
    if kind == "train":
        steps.refuse_mesh(model)
    elif isinstance(model, EncDec):
        raise NotImplementedError(
            "an encoder-decoder over a serving mesh: its cross-attention's "
            "collectives are not written (ROADMAP C10)")
    elif getattr(model.cfg, "moe_layers", ()):
        raise NotImplementedError(
            "expert (MoE) layers over a serving mesh: a data shard's rows "
            "change the capacity drops and expert parallelism is not "
            "written (ROADMAP C10)")


@contextlib.contextmanager
def fake_group(multi_pod: bool, device: str = "meta", mesh_axes=None):
    """A fake process group of the production mesh's ranks in this process
    (this process is rank 0), destroyed on exit. Yields (production mesh,
    the (data, model) mesh a step runs on: the production one, or for
    ``pod2x16x16`` its (pod x data, model) view). ``mesh_axes`` (``{"data":
    d, "model": m}``) makes a small mesh instead. Raises if a process group
    is already up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already up: the dry run starts a fake group "
            "of its own and would replace it")
    sizes = mesh_axes or MESHES[multi_pod][1]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes.values()))
    try:
        dev_type = "cuda" if device == "cuda" else "cpu"
        if mesh_axes is None:
            prod = make_production_mesh(multi_pod=multi_pod, device=dev_type)
        else:
            prod = init_device_mesh(dev_type, tuple(sizes.values()),
                                    mesh_dim_names=tuple(sizes))
        run = prod
        if "pod" in sizes:
            run = init_device_mesh(
                dev_type, (sizes["pod"] * sizes["data"], sizes["model"]),
                mesh_dim_names=("data", "model"))
        yield prod, run
    finally:
        dist.destroy_process_group()


class LiveBytes(TorchDispatchMode):
    """Bytes of live tensor storage while it is on: each storage counted
    once, from the op that made it (or :meth:`track` for tensors made
    before) until it is freed; ``peak`` is the most at any point, the
    counterpart of ``torch.cuda.max_memory_allocated`` over the same work.
    ``matmul_bytes`` sums the operands and results of the matmuls."""

    _MATMULS = ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm")

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.matmul_bytes = 0.0
        self._keys: set = set()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        n = st.nbytes()
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        if key in self._keys:
            self._keys.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if func.__name__.split(".")[0] in self._MATMULS:
            self.matmul_bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, outs))
                if isinstance(t, torch.Tensor))
        return out


def _alloc(shape, dtype, device: str, fill=0) -> torch.Tensor:
    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.full(shape, fill, dtype=dtype, device=device)


def _local_tree(specs: dict, mesh, rules, device: str, zero=False) -> dict:
    """``{path: tensor}`` of this rank's blocks of ``specs`` (``pos``
    rings at -1, everything else 0 on a card)."""
    sizes = shd.axis_sizes(mesh)
    fn = shd.zero_partition_spec if zero else shd.partition_spec
    return {k: _alloc(shd.local_shape(s.shape, fn(s, mesh, rules), sizes),
                      s.dtype, device, -1 if k.endswith("/pos") else 0)
            for k, s in specs.items()}


def _rank_bytes(t: torch.Tensor, rows: int, data: int) -> int:
    """Bytes of this rank's block of an input of the cell's batch."""
    n = t.numel() * t.element_size()
    return n // data if t.dim() and t.shape[0] == rows \
        and rows % data == 0 else n


def _prepare(model, cell, plan: dict, mesh, device: str, mp_assignment):
    """(step, args, argument bytes) of this rank's step of ``cell``."""
    sizes = shd.axis_sizes(mesh)
    data = sizes["data"]
    rules = plan["rules"]
    specs = model.param_specs()
    params = tree_from_flat(_local_tree(specs, mesh, rules, device))
    ins = input_specs(model, cell)
    if device != "meta":
        ins = {k: torch.full(v.shape, cell.seq_len - 1 if k == "pos" else 0,
                             dtype=v.dtype, device=device)
               for k, v in ins.items()}
    rows = cell.global_batch
    arg_bytes = _nbytes(params)
    arg_bytes += sum(_rank_bytes(t, rows, data) for t in ins.values())
    if cell.kind == "train":
        opt_cfg = plan["optimizer"]
        step = steps.make_train_step(model, opt_cfg,
                                     n_microbatches=plan["n_microbatches"],
                                     mp=mp_assignment, mesh=mesh, rules=rules)
        opt_state = tree_from_flat(_local_tree(
            optim.state_specs(specs, opt_cfg), mesh, rules, device,
            zero=True))
        arg_bytes += _nbytes(opt_state)
        return (lambda: step(params, opt_state, ins)), \
            (params, opt_state, ins), arg_bytes
    caches = model.assemble_cache_tree(_local_tree(
        model.cache_specs(rows, cell.seq_len), mesh, CACHE_RULES, device))
    arg_bytes += _nbytes(caches)
    layout = shd.ServingMeshLayout(mesh=mesh, data=data,
                                   model=sizes["model"], n_slots=rows,
                                   rules=rules)
    if cell.kind == "prefill":
        fn = steps.mesh_step(steps.make_prefill_step(model, mp=mp_assignment),
                             layout)
        extra = (ins["tokens"],) + ((ins["prefix_embeds"],)
                                    if "prefix_embeds" in ins else ())
    else:
        fn = steps.mesh_step(steps.make_decode_step(model, mp=mp_assignment),
                             layout)
        extra = (ins["token"], ins["pos"])
    return (lambda: fn(params, caches, *extra)), (params, caches, ins), \
        arg_bytes


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten_paths(tree).values())


def _trace(run, args) -> tuple:
    """Run ``run()`` once under the trackers: (seconds, FLOPs, matmul
    bytes, peak live bytes, collective summary)."""
    from torch.utils.flop_counter import FlopCounterMode
    live = LiveBytes()
    flops = FlopCounterMode(display=False)
    t0 = time.time()
    with shd.counting_collectives() as log, flops, live:
        for tree in args:
            for t in flatten_paths(tree).values():
                live.track(t)
        out = run()
        del out
    return (time.time() - t0, float(flops.get_total_flops()),
            live.matmul_bytes, live.peak, log.summary())


def _time_on_card(run, baseline: int) -> dict:
    """One warm-up of ``run()``, then the median of ``TIMED_STEPS`` timed
    with CUDA events, and the allocator's peak over the warm-up, whole and
    above ``baseline`` (the bytes allocated before the cell's arguments:
    what the trace's peak estimate stands for)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run()
    del out
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = []
    for _ in range(TIMED_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run()
        b.record()
        torch.cuda.synchronize()
        del out
        ms.append(a.elapsed_time(b))
    return {"max_memory_allocated": int(peak),
            "baseline_allocated": int(baseline),
            "peak_above_baseline": int(peak - baseline),
            "args_allocated": int(base - baseline), "step_ms": ms,
            "median_ms": statistics.median(ms)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides=None,
             mp_assignment=None, *, device: str = "meta",
             smoke: bool = False, cell=None,
             mesh_axes=None) -> dict:
    """One cell's record (module docstring). ``device="meta"`` traces
    this rank's step; ``"cuda"`` runs it on the card instead (a fake CUDA
    group) and records its times and the allocator's peak under
    ``"card"``. ``smoke``, ``cell`` and ``mesh_axes`` as for
    :func:`plan_cell`."""
    cell = cell or SHAPES[shape_name]
    mesh_name = (MESHES[multi_pod][0] if mesh_axes is None else
                 "x".join(str(v) for v in mesh_axes.values()))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok", "reason": "", "backend": "fake"}
    plan = plan_cell(arch, shape_name, multi_pod, overrides, smoke=smoke,
                     cell=cell, mesh_axes=mesh_axes)
    if plan["status"] == "skip":
        rec.update(status="skip", reason=plan["reason"])
        return rec
    t0 = time.time()
    model = plan["model"]
    if plan["fsdp"]:
        rec["fsdp"] = True
    if plan["kv_cache_dtype"]:
        rec["kv_cache_dtype"] = plan["kv_cache_dtype"]
    if cell.kind == "train":
        rec["n_microbatches"] = plan["n_microbatches"]
        rec["optimizer"] = plan["optimizer"].name
    rec["param_bytes_per_rank"] = plan["param_bytes"]
    _refuse(model, cell.kind)
    with fake_group(multi_pod, device, mesh_axes) as (prod, mesh):
        chips = prod.size()
        baseline = (torch.cuda.memory_allocated() if device == "cuda"
                    else 0)
        run, args, arg_bytes = _prepare(model, cell, plan, mesh, device,
                                        mp_assignment)
        if device != "meta":
            rec["card"] = _time_on_card(run, baseline)
            rec["memory_analysis"] = {"argument_size_in_bytes": arg_bytes}
            rec["total_s"] = round(time.time() - t0, 2)
            return rec
        secs, flops, mm_bytes, peak, coll = _trace(run, args)
    rec["trace_s"] = round(secs, 2)
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "peak_estimate_bytes": int(peak)}
    rec["memory_analysis"] = mem
    cost = {"flops": flops, "bytes accessed": mm_bytes}
    rec["cost_analysis"] = cost
    rep = roofline.analyze(arch=arch, shape=shape_name, mesh_name=mesh_name,
                           chips=chips, cost=cost,
                           model_flops=model_stats.model_flops(model, cell),
                           memory_stats=mem, hw=H100_SXM, collectives=coll)
    rec["roofline"] = rep.to_dict()
    rec["collective_split"] = {"toplevel": coll["toplevel"],
                               "inloop": coll["inloop"]}
    rec["collectives_are_totals"] = True
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="auto", choices=("auto", "default"),
                    help="auto: the reference's choice (FSDP above "
                         "FSDP_THRESHOLD_BYTES); default: DEFAULT_RULES")
    args = ap.parse_args(argv)
    overrides = {"rules": shd.DEFAULT_RULES} if args.rules == "default" \
        else None
    suffix = "__default_rules" if overrides else ""

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = MESHES[mp][0]
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}{suffix}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skip"):
                            print(f"[cached] {path}")
                            continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape, mp, overrides)
                except Exception as e:  # record, keep sweeping
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error",
                           "reason": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" t=({r['t_compute']:.3e},{r['t_memory']:.3e},"
                             f"{r['t_collective']:.3e})s"
                             f" mem/dev={rec['memory_analysis'].get('peak_estimate_bytes', 0) / 1e9:.2f}GB"
                             f" trace={rec.get('trace_s')}s")
                elif status == "error":
                    extra = f" {rec['reason'][:160]}"
                print(f"  -> {status}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
