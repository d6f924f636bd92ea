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
    init_ranks(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank != 0:                            # rank 0 prints
        sys.stdout = open(os.devnull, "w")
    cs.DEVICE = dev.type
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


if __name__ == "__main__":
    sys.exit(main())
