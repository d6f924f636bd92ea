"""Dry-run and roofline tables from dry-run records (port of
``repro/analysis/report.py``).

Roofline terms are *refined* here rather than taken raw from a record:
the exact analytic FLOPs and bytes of the counting twin's op registry
(:mod:`repro_torch.analysis.analytic`) over the cell's chips, and the
record's collective bytes. XLA counts each while-loop body once, so the
reference's records under-report collectives inside the scanned layers and
the microbatch loop; they are rescaled by the measured undercount factor
(the analytic over the HLO FLOPs, capped by the loops' trip product). The
port's dry run runs every layer and every microbatch, so its collective
bytes are totals already: its records say so
(``"collectives_are_totals": true``) and are not rescaled.

Run ``python -m repro_torch.analysis.report [--dryrun-dir DIR]
[--analytic-dir DIR]`` to print both tables against ``H100_SXM``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.hw.profiles import H100_SXM

__all__ = ["load_records", "refine", "roofline_table", "dryrun_table",
           "LEVERS"]


def load_records(dryrun_dir: str = "experiments/dryrun") -> list:
    recs = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _analytic(arch: str, shape: str, analytic_dir: Optional[str]) -> dict:
    """The cell's analytic costs, kept as ``<arch>__<shape>.json`` in
    ``analytic_dir`` (computed every time without one)."""
    path = (None if analytic_dir is None
            else os.path.join(analytic_dir, f"{arch}__{shape}.json"))
    if path is not None and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    from repro_torch.analysis.analytic import analytic_costs
    c = analytic_costs(arch, shape)
    if path is not None:
        os.makedirs(analytic_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(c, f)
    return c


def _layers_of(arch: str) -> int:
    from repro_torch.models.registry import get_config
    return get_config(arch).n_layers


def refine(rec: dict, hw=H100_SXM, analytic_dir: Optional[str] = None
           ) -> dict:
    """Refined three-term roofline for one ok-record."""
    roof = rec["roofline"]
    chips = roof["chips"]
    ana = _analytic(rec["arch"], rec["shape"], analytic_dir)
    flops_hlo_total = max(roof["flops_per_device"] * chips, 1.0)
    M = max(ana["flops"] / flops_hlo_total, 1.0)
    # collectives live at per-layer (and per-microbatch) loop depth; the
    # flops multiplier additionally includes flash/loss-chunk inner loops,
    # so cap the collective multiplier by the structural trip product
    M_coll = min(M, _layers_of(rec["arch"]) * rec.get("n_microbatches", 1))
    t_c = (ana["flops"] / chips) / hw.flops("bf16")
    t_m = (ana["bytes"] / chips) / hw.hbm_bw
    split = rec.get("collective_split")
    if rec.get("collectives_are_totals"):
        M_coll = 1.0
        coll_bytes = roof["collective_bytes_per_device"]
    elif split is not None:
        coll_bytes = split["toplevel"] + split["inloop"] * M_coll
    else:  # old record: scale everything (over-estimates top-level comms)
        coll_bytes = roof["collective_bytes_per_device"] * M_coll
    t_x = coll_bytes / hw.ici_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bott = max(terms, key=terms.get)
    t_ideal = (roof["model_flops"] / chips) / hw.flops("bf16")
    t_dom = max(terms.values())
    return {
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
        "bottleneck": bott, "loop_multiplier": M, "coll_multiplier": M_coll,
        "model_flops": roof["model_flops"],
        "useful_ratio": roof["model_flops"] / ana["flops"],
        "peak_fraction": (t_ideal / t_dom) if t_dom > 0 else 0.0,
        "analytic_flops": ana["flops"], "analytic_bytes": ana["bytes"],
    }


def _fmt_t(x: float) -> str:
    return f"{x:.2e}"


LEVERS = {
    ("memory", "decode"): "fp8 KV cache + fp8 weights (IP-M)",
    ("memory", "prefill"): "fp8 MP execution (paper) halves GEMM bytes",
    ("memory", "train"): "fp8 matmul residency; tune remat_group",
    ("collective", "train"): "overlap reduce-scatter w/ bwd; fp8 grads",
    ("collective", "prefill"): "reshard qkv to cut all-gathers",
    ("collective", "decode"): "replicate small weights (skip gathers)",
    ("compute", "train"): "fp8 tensor-core execution (the paper's MP)",
    ("compute", "prefill"): "fp8 tensor-core execution (the paper's MP)",
    ("compute", "decode"): "fp8 tensor-core execution (the paper's MP)",
}


def roofline_table(recs: list, mesh: str = "pod16x16", hw=H100_SXM,
                   analytic_dir: Optional[str] = None) -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| MODEL_FLOPS | useful | peak frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | skip: "
                         f"{r['reason'][:44]} | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR |||||||||")
            continue
        roof = refine(r, hw, analytic_dir)
        kind = ("train" if "train" in r["shape"]
                else "decode" if ("decode" in r["shape"] or "500k" in r["shape"])
                else "prefill")
        lever = LEVERS.get((roof["bottleneck"], kind), "—")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(roof['t_compute'])} "
            f"| {_fmt_t(roof['t_memory'])} | {_fmt_t(roof['t_collective'])} "
            f"| {roof['bottleneck']} | {roof['model_flops']:.2e} "
            f"| {roof['useful_ratio']:.2f} | {roof['peak_fraction']:.3f} "
            f"| {lever} |")
    return "\n".join(lines)


def dryrun_table(recs: list, hw=H100_SXM) -> str:
    """One row per record; ``fits`` holds the peak estimate against the
    card's memory (``hw.hbm_bytes``). The time column is the record's
    ``trace_s`` (the reference's records: ``compile_s``)."""
    cap = hw.hbm_bytes / 1e9
    lines = [
        f"| arch | shape | mesh | status | mem/dev GB | fits {hw.name}-"
        f"{cap:g}G | fsdp | kv fp8 | opt | trace s | collectives GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | skip "
                         f"({r['reason'][:40]}) | — | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"ERROR | — | — | — | — | — | — | — |")
            continue
        mem = r["memory_analysis"].get("peak_estimate_bytes", 0) / 1e9
        coll = r["roofline"]["collective_bytes_per_device"] / 1e9
        secs = r.get("trace_s", r.get("compile_s", 0))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {mem:.2f} "
            f"| {'yes' if mem <= cap else 'NO'} | {r.get('fsdp', False)} "
            f"| {r.get('kv_cache_dtype', '—')} | {r.get('optimizer', '—')} "
            f"| {secs} | {coll:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--analytic-dir", default="experiments/analytic",
                    help="where each cell's analytic costs are kept")
    args = ap.parse_args(argv)
    recs = load_records(args.dryrun_dir)
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline (single pod, 256 cards, {H100_SXM.name})\n")
    print(roofline_table(recs, analytic_dir=args.analytic_dir))


if __name__ == "__main__":
    main()
