"""Roofline analysis of dry-run cells (port of ``repro/analysis/roofline.py``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs            / peak_FLOP/s     (per card)
    memory     = bytes            / HBM_bw
    collective = collective_bytes / link_bw

all per rank. The reference takes FLOPs and bytes from XLA's
``cost_analysis`` and the collective bytes from the compiled HLO text
(:func:`parse_collective_bytes`, kept here so that HLO text and the
reference's records still read). The port's dry run
(:mod:`repro_torch.launch.dryrun`) has no HLO: it passes the FLOPs and bytes
it counted over one rank's trace and the collectives the port counted at
its own call sites (``distributed.sharding.counting_collectives``) as
``collectives``, in the same keys. The default card is ``H100_SXM``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from repro_torch.hw.profiles import H100_SXM, HWProfile

__all__ = ["parse_collective_bytes", "RooflineReport", "analyze"]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 0.5, "u4": 0.5,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# shapes like  bf16[4096,1024]{1,0}  possibly inside tuples
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^=]*\)|[a-z0-9]+\[[^\]]*\][^\s]*)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")[\s(]", )


def _shape_bytes(type_str: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\([^)]*(?:\)|$)")
_CALL_RE = re.compile(r"(?:body|condition|calls|to_apply)=%?([\w.\-]+)")
_WHILE_BODY_RE = re.compile(r"\bwhile\(.*?body=%?([\w.\-]+)", re.S)


def parse_collective_bytes(hlo_text: str) -> dict:
    """Sum result-shape bytes per collective kind (per-partition).

    Also splits bytes into ``toplevel`` vs ``inloop``: XLA's cost/HLO views
    count while-loop bodies once, so collectives inside loop bodies must be
    scaled by the loop trip product (the caller knows it as the analytic /
    HLO FLOP ratio) while top-level ones must not.
    """
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}

    # split the module into computation blocks; headerless text (unit tests,
    # fragments) accumulates under a synthetic top-level computation
    comps: dict = {"__top__": {"lines": [], "entry": True}}
    current = "__top__"
    for line in hlo_text.splitlines():
        if not line.startswith(" ") and "{" in line and "(" in line:
            m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)", line.strip())
            current = m.group(1) if m else "__top__"
            comps.setdefault(current, {"lines": [], "entry": "ENTRY" in line})
        comps[current]["lines"].append(line)

    # call graph: computation -> called computations; find loop bodies
    called_by_while: set = set()
    calls: dict = {}
    for name, info in comps.items():
        body = "\n".join(info["lines"])
        calls[name] = set(_CALL_RE.findall(body))
        for m in re.finditer(r"\bwhile\([^)]*\)[^\n]*", body):
            for b in _CALL_RE.findall(m.group(0)):
                called_by_while.add(b)

    # computations transitively reachable from a while body are "in loop"
    in_loop: set = set()
    frontier = list(called_by_while)
    while frontier:
        n = frontier.pop()
        if n in in_loop:
            continue
        in_loop.add(n)
        frontier.extend(calls.get(n, ()))

    top = loop = 0.0
    for name, info in comps.items():
        scope_in_loop = name in in_loop
        for line in info["lines"]:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            type_str, kind = m.group(1), m.group(2)
            b = _shape_bytes(type_str)
            out[kind] += b
            counts[kind] += 1
            if scope_in_loop:
                loop += b
            else:
                top += b
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["toplevel"] = top
    out["inloop"] = loop
    out["counts"] = counts
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6*N*D train / 2*N*D inference (total)
    useful_ratio: float           # model_flops / (HLO flops x chips)
    peak_fraction: float          # t_bound(model) / t_dominant
    memory_per_device: dict
    meta: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, hlo_text: str = "", model_flops: float,
            memory_stats: Optional[dict] = None,
            hw: HWProfile = H100_SXM, compute_fmt: str = "bf16",
            meta: Optional[dict] = None,
            collectives: Optional[dict] = None) -> RooflineReport:
    """The three terms of one cell. ``collectives`` (the keys of
    :func:`parse_collective_bytes`) stands in for ``hlo_text`` when the
    caller counted them itself."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = (parse_collective_bytes(hlo_text) if collectives is None
            else collectives)

    t_c = flops / hw.flops(compute_fmt)
    t_m = byts / hw.hbm_bw
    t_x = coll["total"] / hw.ici_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)

    total_flops = flops * chips
    useful = model_flops / total_flops if total_flops else 0.0
    # fraction of the dominant-term time that ideal (model-flops) compute
    # would need: how close the cell is to its roofline
    t_ideal = (model_flops / chips) / hw.flops(compute_fmt)
    t_dom = max(terms.values())
    peak_fraction = t_ideal / t_dom if t_dom > 0 else 0.0

    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=coll["total"],
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, peak_fraction=peak_fraction,
        memory_per_device=memory_stats or {},
        meta={**(meta or {}), "collectives": coll},
    )
