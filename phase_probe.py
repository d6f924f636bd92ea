#!/usr/bin/env python3
"""Chosen llama3_1b phases of a checkout's ``chip_smoke.py``, in one
process, on one GPU: the quickest A/B of a phase between two checkouts.

    python3 phase_probe.py [--root DIR] [--phases tier,drains] [--reps 3]
        [--out probe.json]

``--root`` is a checkout (default: this one) whose ``chip_smoke.py`` and
``src/`` are used, its kernels built from its own sources. The model is
llama3_1b at full width with random weights (seed 0), as ``chip_smoke.py``
builds it. The phases run in the order given:

- ``tier``: phase 6's calibration, then phase 7's measured tier
  (``measured_phase``) as that checkout has it;
- ``drains``: phase 4's cell drained pipelined and then lockstep
  (``pipelined_vs_lockstep``), fused and then gather, ``--reps`` times:
  phase 17's first two rows. Before them it prints the device memory
  allocated and the objects the garbage collector tracks; after them, the
  collections each generation ran during the drains.

- ``ARCH@DEPTH``: ``llama3_8b`` (phase 13, ``llama8b_phase``), one of
  ``DENSE_CONFIGS``' archs (phase 18, ``dense_config_phase``), Moonlight
  (``moonshot_v1_16b_a3b``: phase 22's ``moe_config_phase``) or LLaVA
  (``llava_next_34b``: phase 24's ``llava_phase``) served at ``DEPTH``
  layers, the whole phase timed: two depths of one arch give
  the seconds a depth cut saves. llama3_1b is built only for ``tier``,
  ``drains``, ``mesh`` and ``ttft``;
- ``whisper``: phase 24's Whisper (``whisper_phase``: calibration, the
  measured tier, Fig. 3b, serving) as that checkout has it;
- ``scan_dryrun``: phase 28 (``scan_phase``, then ``dryrun_phase``: the
  scan leg and the dry run, its host trace started before the kernels'
  build here), held to phase 25's first steps run here through the
  single-rank trainer and to phase 4's plain fused drain, run here first;
- ``fsdp_dryrun``: phase 28's dry-run leg for its FSDP cells alone
  (qwen2p5_32b's decode_32k and train_4k cut, ``DRYRUN_CELLS``' ``fsdp_``
  entries): their host trace, started first, then each shard on the card
  held to its trace's peak; no kernel is built for it;
- ``dryrun_card``: the same for every cell phase 28 runs on the card
  (``DRYRUN_ON_CARD``), as that checkout has them: the dry-run leg's
  seconds without the host-only cells' trace;
- ``training``: phase 25 (``training_phase``), where the checkout has it;
- ``checkpoint_io``: where a checkpoint's seconds go, on one tree of
  ``--gb`` gigabytes on the card (bf16 and f32 leaves of 2^26 elements, as
  a model's params and moments), written under ``$TMPDIR``: the copy to
  the host, SHA-256 of every leaf in one thread and in a pool, zlib's
  CRC-32 (what the zip writer and reader compute), ``np.savez`` with and
  without its fsync, ``np.load`` of every member, then the checkout's
  ``CheckpointManager.save``, ``restore`` (every digest checked) and
  ``restore(only="params")``;
- ``ttft``: phase 20 (``ttft_phase``: phase 4's cell with the prefill
  step eager and graphed) as that checkout has it;
- ``train_mesh``: phase 25 (``training_phase``) and then phase 27
  (``train_mesh_phase``: training over a 1x1 NCCL mesh, held to phase
  25's steps bit for bit), where the checkout has it; each timed;
- ``mesh``: phase 26 (``mesh_phase``: llama3_1b at phase 4's cell over a
  1x1 NCCL mesh, plain and under phase 5's plan), after the two drains
  without a mesh it is held to (fused, plain and under the plan);
- ``train_step``: phase 25's eager training step alone (llama3_1b at full
  width and depth, AdamW, ``TRAIN_LOSS``' batch): ``--reps`` steps timed
  on the host clock, then the same number under ``torch.profiler``; the
  device's busy share is the device time of the profiled steps' kernels
  and copies over the unprofiled steps' wall time; the peak allocated
  over the timed steps (``torch.cuda.max_memory_allocated``). No kernel
  is built for it, nor for the two dry-run phases.

Prints ``chip_smoke.py``'s lines for each phase, one JSON line with every
drain's numbers, and last the card's name and power limit; ``--out`` gets
the JSON too. Compare two checkouts within one call, in the order parent,
change, change, parent: ``git archive`` the parent into a directory that
``.gitignore`` lists and pass it as ``--root``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
DRAIN_KEYS = ("tokens_per_s", "wall_tokens_per_s", "wall_ms_per_step",
              "host_blocked_ms_per_step")


def load_chip_smoke(root: Path):
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def drains(torch, cs, model, params, reps: int) -> list:
    failures: list = []
    reqs = cs.phase4_requests(model)
    gc_before = [s["collections"] for s in gc.get_stats()]
    cs.log(f"drains: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
           f"allocated, {len(gc.get_objects())} objects tracked by gc")
    out = []
    for rep in range(reps):
        for attn in ("fused", "gather"):
            rec, _ = cs.pipelined_vs_lockstep(
                torch, model, params, reqs, "", failures, paged_attn=attn,
                route="gqa_mma" if attn == "fused" else None)
            out.append({"rep": rep, "attn": attn} | {
                mode: {k: rec[mode][k] for k in DRAIN_KEYS}
                for mode in ("pipelined", "lockstep")})
    gc_runs = [s["collections"] - b
               for s, b in zip(gc.get_stats(), gc_before)]
    cs.log(f"drains: gc collections by generation during them {gc_runs}")
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def scan_dryrun(torch, cs, model, params) -> dict:
    """Phase 28 after what it is held to: phase 4's plain fused drain
    (``SERVED_TOKENS``) and phase 25's first steps through the single-rank
    trainer at phase 25's seed and batches (its peak memory then is the
    trainer's alone)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_model
    reqs = make_requests(model.cfg.vocab_size, cs.SERVE["requests"],
                         cs.SERVE["prompt_len"], cs.SERVE["new_tokens"],
                         cs.SERVE["arrival_every"])
    res, launches, tl = cs.run_continuous(torch, model, params, reqs,
                                          paged_attn="fused",
                                          route="gqa_mma")
    cs.SERVED_TOKENS[model.cfg.name] = {"plain": (
        {rid: t[0] for rid, t in tl.items()}, launches, res.tokens_per_s)}
    unrolled = get_model("llama3_1b")
    with tempfile.TemporaryDirectory(prefix="phase_probe_scan_") as tmp:
        tr = cs.train_trainer(unrolled, Path(tmp), cs.SCAN_STEPS, 10 ** 6)
        _, p, o = tr.init_or_resume(0)
        data = cs.train_data(unrolled.cfg)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for s in range(cs.SCAN_STEPS):
            p, o, m = tr.train_step(p, o, data.batch_at(s))
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        peak = torch.cuda.max_memory_allocated() / 1e9
        del tr, p, o
    gc.collect()
    torch.cuda.empty_cache()
    training = {"loss_leg": {"losses": [x[0] for x in steps],
                             "grad_norms": [x[1] for x in steps],
                             "peak_gb": peak}}
    scan = cs.scan_phase(torch, training)
    gc.collect()
    torch.cuda.empty_cache()
    return cs.phase28_record(scan, cs.dryrun_phase(torch))


def checkpoint_io(torch, cs, gb: float) -> dict:
    import concurrent.futures
    import hashlib
    import os
    import zlib

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _to_numpy
    leaf = 1 << 26
    n = max(1, int(gb * 1e9 / (leaf * 6)))
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"params": {f"w{i}": torch.randn(leaf, generator=g, device="cuda")
                       .to(torch.bfloat16) for i in range(n)},
            "opt": {f"m{i}": torch.randn(leaf, generator=g, device="cuda")
                    for i in range(n)}}
    flat = [t for sub in tree.values() for t in sub.values()]
    size = sum(t.numel() * t.element_size() for t in flat) / 1e9
    rows: dict = {"gb": size, "cpus": os.cpu_count()}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        sec = time.perf_counter() - t0
        rows[name] = {"seconds": sec, "gb_per_s": size / sec}
        cs.log(f"checkpoint_io {name}: {sec:.2f} s, {size / sec:.2f} GB/s "
               f"over {size:.2f} GB")
        return res

    arrays = timed("device to host", lambda: [_to_numpy(t)[0] for t in flat])
    timed("sha256, one thread", lambda: [
        hashlib.sha256(a.data).hexdigest() for a in arrays])
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as ex:
        timed("sha256, a pool", lambda: list(ex.map(
            lambda a: hashlib.sha256(a.data).hexdigest(), arrays)))
    timed("crc32", lambda: [zlib.crc32(a.data) for a in arrays])
    with tempfile.TemporaryDirectory(prefix="phase_probe_") as tmp:
        named = {f"a{i}": a for i, a in enumerate(arrays)}

        def savez(sync):
            path = os.path.join(tmp, f"x{int(sync)}.npz")
            with open(path, "wb") as f:
                np.savez(f, **named)
                f.flush()
                if sync:
                    os.fsync(f.fileno())
            return path

        timed("np.savez, no fsync", lambda: savez(False))
        path = timed("np.savez + fsync", lambda: savez(True))

        def load():
            with np.load(path) as z:
                return [z[k].nbytes for k in z.files]

        timed("np.load", load)
        del arrays, named
        cm = CheckpointManager(os.path.join(tmp, "ck"))
        timed("CheckpointManager.save", lambda: cm.save(1, tree))
        timed("CheckpointManager.restore", lambda: cm.restore(device="cuda"))
        timed("CheckpointManager.restore(only='params')",
              lambda: cm.restore(device="cuda", only="params"))
    return rows


def mesh(torch, cs, model, params) -> dict:
    """Phase 26 and the fused drains without a mesh (phases 4 and 5's
    first) whose tokens and launches it is held to."""
    from repro_torch.launch.serve import make_requests
    reqs = make_requests(model.cfg.vocab_size, cs.SERVE["requests"],
                         cs.SERVE["prompt_len"], cs.SERVE["new_tokens"],
                         cs.SERVE["arrival_every"])
    ref = {}
    for name, mp in (("plain", None), ("mp", cs.fixed_plan(model))):
        out, n, tl = cs.run_continuous(torch, model, params, reqs, mp=mp,
                                       paged_attn="fused", route="gqa_mma")
        ref[name] = ({rid: t[0] for rid, t in tl.items()}, n,
                     out.tokens_per_s)
    cs.SERVED_TOKENS[model.cfg.name] = ref
    return cs.mesh_phase(torch, model, params)


def train_step(torch, cs, reps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import default_generator
    from repro_torch.train import optim
    hp = cs.TRAIN_LOSS
    model = get_model("llama3_1b")
    params = model.init(default_generator(0, "cuda"), "cuda")
    cfg = optim.select_optimizer(model.n_params(), optim.OptConfig(
        lr=hp["lr"], warmup_steps=hp["warmup"], total_steps=hp["steps"]))
    state = optim.init_state(model.param_specs(), cfg, "cuda")
    data = cs.train_data(model.cfg)
    step = make_train_step(model, cfg)
    for i in range(2):                                   # warm-up
        step(params, state, data.batch_at(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(reps):
        t0 = time.perf_counter()
        step(params, state, data.batch_at(2 + i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            step(params, state, data.batch_at(2 + reps + i))
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) * 1e-6
    wall = sum(walls)
    rec = {"steps": reps, "step_wall_ms": [w * 1e3 for w in walls],
           "device_busy_ms_per_step": busy / reps * 1e3,
           "profiled_step_ms": profiled / reps * 1e3,
           "busy_share": busy / wall, "peak_allocated_bytes": peak}
    cs.log(f"train_step: {reps} eager steps, wall "
           f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; under the "
           f"profiler {rec['profiled_step_ms']:.2f} ms a step, device busy "
           f"{rec['device_busy_ms_per_step']:.2f} ms a step: "
           f"{100 * rec['busy_share']:.1f}% of the unprofiled wall; peak "
           f"{peak / 1e9:.3f} GB allocated over the timed steps")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--phases", default="drains")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gb", type=float, default=4.0,
                    help="checkpoint_io's tree size")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    cs = load_chip_smoke(root)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_model_and_params
    resolve_device("cuda")
    phases = args.phases.split(",")
    card_only = {"fsdp_dryrun", "dryrun_card"} & set(phases)
    if card_only:
        keep = tuple(k for k in cs.DRYRUN_ON_CARD
                     if "dryrun_card" in card_only or k.startswith("fsdp_"))
        cs.DRYRUN_CELLS = {k: cs.DRYRUN_CELLS[k] for k in keep}
        cs.DRYRUN_ON_CARD = keep
    if card_only or "scan_dryrun" in phases:
        cs.start_host_dryrun()            # beside the build
    if not set(phases) <= {"fsdp_dryrun", "dryrun_card", "train_step"}:
        t0 = time.perf_counter()
        _build.build()
        cs.log(f"{root}: kernels built in {time.perf_counter() - t0:.1f} s")
    if {"tier", "drains", "mesh", "ttft", "scan_dryrun"} & set(phases):
        model, params = make_model_and_params("llama3_1b", False, "cuda",
                                              seed=0)
    out: dict = {"root": str(root), "phases": {}, "drains": []}
    for name in phases:
        t0 = time.perf_counter()
        arch, _, depth = name.partition("@")
        if arch == cs.LLAMA8B and depth:
            cs.LLAMA8B_DEPTH = int(depth)
            cs.llama8b_phase(torch)
        elif arch in dict(cs.DENSE_CONFIGS) and depth:
            cs.dense_config_phase(torch, arch, int(depth))
        elif arch == cs.MOONLIGHT and depth:
            cs.moe_config_phase(torch, arch, int(depth), None, {}, "gqa_mma")
        elif arch == cs.LLAVA and depth:
            cs.LLAVA_DEPTH = int(depth)
            cs.llava_phase(torch)
        elif name == "tier":
            with tempfile.TemporaryDirectory(prefix="phase_probe_") as tmp:
                bundle, _, _ = cs.calibration_phase(torch, model, params,
                                                    Path(tmp))
                cs.measured_phase(torch, model, params, bundle)
            del bundle
        elif name == "drains":
            out["drains"] += drains(torch, cs, model, params, args.reps)
        elif name == "whisper":
            out["whisper"] = cs.whisper_phase(torch)["measured_tier"][
                "seconds"]
        elif name == "scan_dryrun":
            out["scan_dryrun"] = scan_dryrun(torch, cs, model, params)
        elif name in ("fsdp_dryrun", "dryrun_card"):
            out[name] = cs.dryrun_phase(torch)
        elif name == "training" and hasattr(cs, "training_phase"):
            rec = cs.training_phase(torch)
            out["training"] = {"step_wall_ms": rec["loss_leg"][
                "step_wall_ms"], "checkpoints": [
                c for leg in ("loss_leg", "checkpoint_leg")
                for c in rec[leg]["checkpoints"]]}
        elif name == "ttft":
            out["ttft"] = cs.ttft_phase(torch, model, params)
        elif name == "train_mesh" and hasattr(cs, "train_mesh_phase"):
            t1 = time.perf_counter()
            rec = cs.training_phase(torch)
            t2 = time.perf_counter()
            out["train_mesh"] = cs.train_mesh_phase(torch, rec)
            out["train_mesh"]["training_phase_s"] = t2 - t1
        elif name == "mesh" and hasattr(cs, "mesh_phase"):
            out["mesh"] = mesh(torch, cs, model, params)
        elif name == "checkpoint_io":
            out["checkpoint_io"] = checkpoint_io(torch, cs, args.gb)
        elif name == "train_step":
            out["train_step"] = train_step(torch, cs, args.reps)
        else:
            raise SystemExit(f"unknown phase {name!r}")
        torch.cuda.synchronize()
        out["phases"][name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        cs.log(f"phase {name}: {out['phases'][name]:.1f} s")
    card = cs.card_line()
    out["card"] = card
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
