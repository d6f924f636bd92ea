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

- ``ARCH@DEPTH``: ``llama3_8b`` (phase 13, ``llama8b_phase``) or one of
  ``DENSE_CONFIGS``' archs (phase 18, ``dense_config_phase``) served at
  ``DEPTH`` layers, the whole phase timed: two depths of one arch give
  the seconds a depth cut saves. llama3_1b is built only for ``tier`` and
  ``drains``.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--phases", default="drains")
    ap.add_argument("--reps", type=int, default=3)
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
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"{root}: kernels built in {time.perf_counter() - t0:.1f} s")
    phases = args.phases.split(",")
    if {"tier", "drains"} & set(phases):
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
        elif name == "tier":
            with tempfile.TemporaryDirectory(prefix="phase_probe_") as tmp:
                bundle, _, _ = cs.calibration_phase(torch, model, params,
                                                    Path(tmp))
                cs.measured_phase(torch, model, params, bundle)
            del bundle
        elif name == "drains":
            out["drains"] += drains(torch, cs, model, params, args.reps)
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
