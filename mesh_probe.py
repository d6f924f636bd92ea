#!/usr/bin/env python3
"""``chip_smoke.py``'s serving cell over (data, model) meshes of several
ranks, one process and one card a rank, against the single-rank engine.

    torchrun --nproc-per-node 4 mesh_probe.py [--meshes 2x2,1x4,4x1] \\
        [--arch llama3_1b] [--plans plain,mp] [--smoke --device cpu] \\
        [--out probe.json]

Every rank builds the model at full width and depth (seed 0) on its card,
then, for each of ``--plans`` (``plain``; ``mp``: phase 5's plan), serves
phase 4's cell (8 requests, 128-token prompts, 32 new, 4 slots, block 16)
with the engine without a mesh (every rank the same drain, so the ranks'
weight caches stay alike) and then with ``ContinuousBatchingEngine(mesh=)``
over each mesh of ``--meshes`` (each ``data * model`` = the ranks), every
drain through
``chip_smoke.run_continuous``: graphed, fused paged attention, its captures
and kernel 5's launches checked. Rank 0 holds each mesh drain to the
single-rank one by the near-tie rule (``chip_smoke.compare``) and prints,
for each, the launches on a rank, the tokens/s beside the single-rank
drain's, and the weights' bytes on a rank; then one JSON line and the
card's name and power limit. ``--smoke --device cpu`` runs the same over
gloo on the host. Exits non-zero when a check fails.

``--train`` runs training instead (no kernel is on its path, none is
built): llama3_1b at full width, phase 25's AdamW and batches of (8, 256),
``--steps`` steps on one rank (every rank the same run) and then through
``Trainer(mesh=)`` over each mesh of ``--meshes``; rank 0 prints each
mesh's losses and grad norms against the single rank's (the first step's
held to ``STEP1_TOL``), its step's wall median and tokens/s. Then the elastic restore: the (2,2) run's state saved (whole
leaves, written by the mesh's origin rank under ``$TMPDIR``) and restored
onto (4,1), every leaf held equal bit for bit. Every rank's group starts
with a short timeout, and the results are printed before the teardown.

    timeout 210 torchrun --nproc-per-node 4 mesh_probe.py --train \
        [--steps 10] [--out mesh_train.json]

``--train --fsdp`` runs FSDP (ZeRO-3) instead, through
``make_train_step(mesh=, rules=)`` (the trainer takes no rules, as the
reference's does not): llama3_1b at full width, ``--steps`` steps on one
rank, then over each mesh of ``--meshes`` (default ``4x1,2x2``) under the
default rules and under ``FSDP_RULES``. Rank 0 prints, for each mesh, the
first step's loss and grad norm under FSDP against the default rules'
and against one rank's (held to ``STEP1_TOL``), each run's step wall
median, and every rank's ``max_memory_allocated`` over the steps (the
params, moments and inputs included).

    timeout 300 torchrun --nproc-per-node 4 mesh_probe.py --train --fsdp \
        [--steps 10] [--out mesh_fsdp.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="2x2,1x4,4x1")
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--plans", default="plain",
                    help="plain and/or mp (chip_smoke's fixed plan)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--train", action="store_true",
                    help="training over the meshes instead of serving")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fsdp", action="store_true",
                    help="with --train: FSDP_RULES against the default "
                         "rules on each mesh (default meshes 4x1,2x2)")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.launch.serve import make_model_and_params, make_requests
    from repro_torch.launch.steps import release_mesh_steps
    from repro_torch.nn.spec import flatten_paths
    from repro_torch.serve.parallel import shard_serving_params
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(args.device)
    init_ranks(dev, timeout_s=120.0)
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank != 0:                            # rank 0 prints
        sys.stdout = open(os.devnull, "w")
    cs.DEVICE = dev.type
    if args.train and args.fsdp:
        return fsdp_main(args, torch, cs, dev)
    if args.train:
        return train_main(args, torch, cs, dev)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        if rank == 0:                        # one nvcc per source, once
            _build.build()
        dist.barrier()
        _build.build()
    else:
        torch.set_num_threads(1)
        for name in ("synchronize", "reset_peak_memory_stats"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    if args.smoke:
        cs.SERVE = dict(cs.SERVE, requests=4, prompt_len=12, new_tokens=6,
                        block_size=4)
    model, params = make_model_and_params(args.arch, args.smoke, dev, seed=0)
    reqs = make_requests(model.cfg.vocab_size, cs.SERVE["requests"],
                         cs.SERVE["prompt_len"], cs.SERVE["new_tokens"],
                         cs.SERVE["arrival_every"])
    route = "gqa_mma" if dev.type == "cuda" else None
    out = {"arch": model.cfg.name, "world": world, "plans": {}}
    failures = []
    meshes = {}
    for name in args.plans.split(","):
        plan = cs.fixed_plan(model) if name == "mp" else None
        tol, bound = ((cs.LOGIT_TOL_MP, cs.MARGIN_BOUND_MP) if plan
                      else (cs.LOGIT_TOL, cs.MARGIN_BOUND))
        ref, n_ref, ref_tl = cs.run_continuous(
            torch, model, params, reqs, mp=plan, paged_attn="fused",
            route=route, name="single rank")
        rec = out["plans"][name] = {
            "single_rank": {"kernel_launches": n_ref,
                            "tokens_per_s": ref.tokens_per_s}}
        for spec in args.meshes.split(","):
            d, m = (int(v) for v in spec.split("x"))
            if d * m != world:
                raise SystemExit(f"mesh {spec} needs {d * m} ranks, have "
                                 f"{world}")
            if spec not in meshes:
                meshes[spec] = init_device_mesh(
                    dev.type, (d, m), mesh_dim_names=("data", "model"))
            mesh = meshes[spec]
            t0 = time.perf_counter()
            res, n, tl = cs.run_continuous(
                torch, model, params, reqs, mp=plan, paged_attn="fused",
                route=route, name=f"mesh {spec}", mesh=mesh)
            seconds = time.perf_counter() - t0
            agree = cs.compare(f"{name} mesh {spec} vs single rank", tl,
                               ref_tl, tol=tol, bound=bound,
                               failures=failures)
            local = shard_serving_params(model, params, mesh)
            rank_bytes = sum(t.numel() * t.element_size()
                             for t in flatten_paths(local).values())
            c = res.counters
            if c["mesh_kernel_launches"] != n:
                failures.append(f"{name} mesh {spec}: {n} launches, "
                                f"{c['mesh_kernel_launches']} on the shard")
            rec[spec] = {
                "layout": c["mesh"], "kernel_launches_a_rank": n,
                "tokens_per_s": res.tokens_per_s,
                "wall_tokens_per_s": c["wall_tokens_per_s"],
                "weights_bytes_a_rank": rank_bytes, "seconds": seconds,
                "agreement": agree}
            cs.log(f"{name} mesh {spec}: {n} kernel launches on rank 0, "
                   f"{res.tokens_per_s:.1f} tokens/s against "
                   f"{ref.tokens_per_s:.1f} on one rank; weights "
                   f"{rank_bytes / 1e9:.3f} GB a rank; {seconds:.1f} s")
    # the results first: a four-card run of this script hung after its last
    # drain, in the barrier or the group's destruction below
    if rank == 0:
        out["failures"] = failures
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=2))
        print(json.dumps(out), flush=True)
        if dev.type == "cuda":
            print(cs.card_line(), flush=True)
    if failures:
        print("; ".join(failures), file=sys.stderr, flush=True)
    release_mesh_steps(model)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if failures else 0


# a mesh's first training step against one rank's, relative (bf16 at full
# width: measured 3.5e-5 and 2.5e-4 at most on four H100s)
STEP1_TOL = {"loss": 1e-3, "grad_norm": 1e-2}


def _timed_steps(torch, tr, data, steps: int) -> tuple:
    """``steps`` train steps of ``tr`` from its init: (params, state,
    [(loss, grad norm)], [step seconds])."""
    _, p, o = tr.init_or_resume(0)
    rows, walls = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, data.batch_at(s))
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(time.perf_counter() - t0)
    return p, o, rows, walls


def train_main(args, torch, cs, dev) -> int:
    import shutil
    import statistics
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import flatten_paths
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type != "cuda":
        torch.set_num_threads(1)
    model = get_model(args.arch, smoke=args.smoke)
    data = cs.train_data(model.cfg)
    tokens = cs.TRAIN_LOSS["batch"] * cs.TRAIN_LOSS["seq_len"]
    root = Path(os.environ.get("TMPDIR", "/tmp")) / (
        f"mesh_probe_train_{os.environ.get('MASTER_PORT', 'local')}")
    out = {"arch": model.cfg.name, "world": world, "steps": args.steps,
           "meshes": {}}
    failures = []
    t0 = time.perf_counter()
    _, _, ref, walls = _timed_steps(
        torch, cs.train_trainer(model, root / f"single{rank}", args.steps,
                                10 ** 6), data, args.steps)
    ref_ms = statistics.median(walls[1:]) * 1e3
    out["single_rank"] = {"steps": ref, "step_ms": ref_ms,
                          "tokens_per_s": tokens / ref_ms * 1e3}
    cs.log(f"one rank: {args.steps} steps, losses {ref[0][0]:.4f} .. "
           f"{ref[-1][0]:.4f}, step {ref_ms:.2f} ms "
           f"({tokens / ref_ms * 1e3:.0f} tokens/s)")
    kept = {}
    for spec in args.meshes.split(","):
        d, m = (int(v) for v in spec.split("x"))
        if d * m != world:
            raise SystemExit(f"mesh {spec} needs {d * m} ranks, have {world}")
        mesh = make_local_mesh(d, m, dev)
        tr = cs.train_trainer(model, root / f"mesh_{spec}", args.steps,
                              10 ** 6, mesh=mesh)
        p, o, rows, walls = _timed_steps(torch, tr, data, args.steps)
        ms = statistics.median(walls[1:]) * 1e3
        rel = [abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(ref, rows)]
        gn = [abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(ref, rows)]
        out["meshes"][spec] = {"steps": rows, "step_ms": ms,
                               "tokens_per_s": tokens / ms * 1e3,
                               "loss_rel": rel, "grad_norm_rel": gn,
                               "bitwise": rows == ref}
        cs.log(f"mesh {spec}: losses {rows[0][0]:.4f} .. {rows[-1][0]:.4f}; "
               f"from one rank's, step 1 {rel[0]:.3g} (loss) and "
               f"{gn[0]:.3g} (grad norm), at most {max(rel):.3g} and "
               f"{max(gn):.3g} over the steps; step {ms:.2f} ms "
               f"({tokens / ms * 1e3:.0f} tokens/s, "
               f"{ref_ms / ms:.2f}x one rank's)")
        # the first step starts from the same params: only the sum order
        # differs. Later steps part further (bf16 params, AdamW's sign-like
        # first updates, clipping at grad norms of 5-37): they are printed
        if rel[0] > STEP1_TOL["loss"] or gn[0] > STEP1_TOL["grad_norm"]:
            failures.append(f"mesh {spec}: step 1 {rel[0]:.3g} (loss), "
                            f"{gn[0]:.3g} (grad norm) from one rank's")
        if spec == "2x2":
            t1 = time.perf_counter()
            CheckpointManager(str(root / "elastic")).save(
                args.steps, {"params": p, "opt": o}, mesh=mesh,
                pspecs=tr._pspecs())
            out["save_s"] = time.perf_counter() - t1
            kept = {"tr": tr, "p": p, "o": o}
        else:
            del p, o
        del tr
    if kept:
        # the (2,2) state restored onto (4,1): every leaf equal
        t1 = time.perf_counter()
        mesh41 = make_local_mesh(4, 1, dev)
        tr41 = cs.train_trainer(model, root / "elastic", args.steps,
                                10 ** 6, mesh=mesh41)
        step, p41, o41 = tr41.init_or_resume(0)
        out["restore_s"] = time.perf_counter() - t1
        same = step == args.steps
        src = kept["tr"]
        for name, a, b, specs_a, specs_b in (
                ("params", kept["p"], p41, src.shards.params,
                 tr41.shards.params),
                ("opt", kept["o"], o41, src.shards.state, tr41.shards.state)):
            fb = flatten_paths(b)
            for k, v in flatten_paths(a).items():
                wa = sharding.gather_leaf(v, specs_a[k], src.layout)
                wb = sharding.gather_leaf(fb[k], specs_b[k], tr41.layout)
                same = same and torch.equal(wa, wb)
                del wa, wb
        out["elastic_2x2_to_4x1_bitwise"] = bool(same)
        cs.log(f"elastic: the (2,2) state after step {args.steps} saved in "
               f"{out['save_s']:.1f} s, restored onto (4,1) in "
               f"{out['restore_s']:.1f} s: "
               f"{'every leaf equal' if same else 'LEAVES DIFFER'}")
        if not same:
            failures.append("elastic restore (2,2) -> (4,1) not bitwise")
    out["seconds"] = time.perf_counter() - t0
    out["failures"] = failures
    # the results first: a four-card serving run of this script hung in its
    # teardown
    if rank == 0:
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=2))
        print(json.dumps(out), flush=True)
        if dev.type == "cuda":
            print(cs.card_line(), flush=True)
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        print("; ".join(failures), file=sys.stderr, flush=True)
    dist.barrier()
    dist.destroy_process_group()
    cs.log("teardown done")
    return 1 if failures else 0


def _direct_steps(torch, model, opt, mesh, rules, data, steps: int,
                  dev) -> dict:
    """``steps`` steps of ``make_train_step(mesh=, rules=)`` from seed 0's
    params: each (loss, grad norm), each step's wall seconds, and this
    rank's ``max_memory_allocated`` over the steps (what it held before
    them included) and its params' bytes."""
    import gc
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.spec import (default_generator, flatten_paths,
                                     tree_from_flat)
    from repro_torch.train import optim
    step = make_train_step(model, opt, mesh=mesh, rules=rules)
    sh = step.shards
    p = flatten_paths(model.init(default_generator(0, dev), dev))
    specs = optim.state_specs(model.param_specs(), opt)
    if sh is None:
        o = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
             for k, s in specs.items()}
    else:
        p = sh.local(sh.params, p)
        o = {k: torch.zeros(sharding.local_shape(s.shape, sh.state[k],
                                                 sh.layout.sizes),
                            dtype=s.dtype, device=dev)
             for k, s in specs.items()}
    p, o = tree_from_flat(p), tree_from_flat(o)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rows, walls = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        p, o, m = step(p, o, data.batch_at(s))
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    nbytes = sum(t.numel() * t.element_size()
                 for t in flatten_paths(p).values())
    return {"steps": rows, "walls": walls, "peak": peak,
            "param_bytes": nbytes}


def fsdp_main(args, torch, cs, dev) -> int:
    """``--train --fsdp`` (module docstring)."""
    import statistics
    import torch.distributed as dist
    from repro_torch.distributed.sharding import FSDP_RULES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train.optim import OptConfig, select_optimizer
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type != "cuda":
        torch.set_num_threads(1)
    model = get_model(args.arch, smoke=args.smoke)
    data = cs.train_data(model.cfg)
    opt = select_optimizer(model.n_params(), OptConfig(
        lr=cs.TRAIN_LOSS["lr"], warmup_steps=cs.TRAIN_LOSS["warmup"],
        total_steps=cs.TRAIN_LOSS["steps"]))
    meshes = "4x1,2x2" if args.meshes == "2x2,1x4,4x1" else args.meshes
    out = {"arch": model.cfg.name, "world": world, "steps": args.steps,
           "meshes": {}}
    failures = []
    t0 = time.perf_counter()

    def median_ms(run):
        return statistics.median(run["walls"][1:] or run["walls"]) * 1e3

    def peaks(run) -> list:
        got = [None] * world
        dist.all_gather_object(got, run["peak"])
        return got

    one = _direct_steps(torch, model, opt, None, None, data, args.steps, dev)
    out["single_rank"] = {"steps": one["steps"], "step_ms": median_ms(one),
                          "peak": one["peak"]}
    cs.log(f"one rank: step 1 loss {one['steps'][0][0]:.6f}, grad norm "
           f"{one['steps'][0][1]:.4f}; step {median_ms(one):.2f} ms; peak "
           f"{one['peak'] / 1e9:.3f} GB")
    del one
    for spec in meshes.split(","):
        d, m = (int(v) for v in spec.split("x"))
        if d * m != world:
            raise SystemExit(f"mesh {spec} needs {d * m} ranks, have {world}")
        mesh = make_local_mesh(d, m, dev)
        rec = {}
        for name, rules in (("default", None), ("fsdp", FSDP_RULES)):
            run = _direct_steps(torch, model, opt, mesh, rules, data,
                                args.steps, dev)
            rec[name] = {"steps": run["steps"], "step_ms": median_ms(run),
                         "peaks": peaks(run),
                         "param_bytes": run["param_bytes"]}
            del run
        ref = out["single_rank"]["steps"][0]
        f1, d1 = rec["fsdp"]["steps"][0], rec["default"]["steps"][0]
        rel = [abs(f1[i] - ref[i]) / abs(ref[i]) for i in (0, 1)]
        rel_default = [abs(f1[i] - d1[i]) / abs(d1[i]) for i in (0, 1)]
        rec["step1_rel_one_rank"] = rel
        rec["step1_rel_default"] = rel_default
        out["meshes"][spec] = rec
        gb = [max(rec[k]["peaks"]) / 1e9 for k in ("default", "fsdp")]
        cs.log(f"mesh {spec}: step 1 under FSDP loss {f1[0]:.6f}, grad norm "
               f"{f1[1]:.4f}: from the default rules' {rel_default[0]:.3g} "
               f"(loss), {rel_default[1]:.3g} (grad norm); from one rank's "
               f"{rel[0]:.3g}, {rel[1]:.3g}; step "
               f"{rec['fsdp']['step_ms']:.2f} ms against the default rules' "
               f"{rec['default']['step_ms']:.2f}; peak a rank "
               f"{gb[1]:.3f} GB against {gb[0]:.3f} ({gb[0] - gb[1]:.3f} GB "
               f"less); params a rank {rec['fsdp']['param_bytes'] / 1e9:.3f}"
               f" GB against {rec['default']['param_bytes'] / 1e9:.3f}")
        if rel[0] > STEP1_TOL["loss"] or rel[1] > STEP1_TOL["grad_norm"]:
            failures.append(f"mesh {spec} under FSDP: step 1 {rel[0]:.3g} "
                            f"(loss), {rel[1]:.3g} (grad norm) from one "
                            f"rank's")
    out["seconds"] = time.perf_counter() - t0
    out["failures"] = failures
    if rank == 0:
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=2))
        print(json.dumps(out), flush=True)
        if dev.type == "cuda":
            print(cs.card_line(), flush=True)
    if failures:
        print("; ".join(failures), file=sys.stderr, flush=True)
    dist.barrier()
    dist.destroy_process_group()
    cs.log("teardown done")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
