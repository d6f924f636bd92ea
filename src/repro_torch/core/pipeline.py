"""Staged automatic-MP pipeline (paper Algorithm 1), artifact-centric (port
of ``repro/core/pipeline.py``).

The paper's pipeline has one expensive phase and one cheap one:

* **calibrate** — fwd+bwd sensitivity passes over the calibration set
  (Sec. 2.2), partition into sequential sub-graphs (Alg. 2), and per-group
  gain tables for all F^{L_j} combos under every registered gain model
  (Sec. 2.3). Requires the model, its params, and calibration data.
* **solve** — the IP (eq. 5) with budget tau^2 E[g^2]. Pure NumPy over the
  tabulated gains; re-runnable per (tau, objective) in milliseconds.

:func:`calibrate` runs the expensive phase once and returns a durable
:class:`CalibrationBundle` (JSON / npz save-load, like :class:`MPPlan`, in
the reference's layout: a bundle saved by either package loads in the
other); ``bundle.solve(tau=..., objective=...)`` replays the IP with no model
or params in scope, and ``bundle.pareto(taus)`` sweeps a tradeoff frontier
from the same artifact. :func:`tabulate_measured_gains` adds the measured
wall-clock tier. :func:`auto_mixed_precision` is the one-call wrapper
(calibrate + solve).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

import torch

from repro_torch.core import graphs as G
from repro_torch.core.ip_solver import MCKPGroup, solve_mckp
from repro_torch.core.mpconfig import MPPlan
from repro_torch.core.partition import partition_sequential
from repro_torch.core.sensitivity import (SensitivityResult,
                                          calibrate_sensitivity)
from repro_torch.core.timegain import (WallClockGainModel,
                                       default_gain_models, enumerate_combos)
from repro_torch.hw.profiles import H100_SXM, HWProfile
from repro_torch.quant.formats import get_format

__all__ = ["AMPOptions", "CalibrationBundle", "calibrate",
           "auto_mixed_precision", "predicted_loss_mse", "build_groups",
           "tabulate_measured_gains"]

BUNDLE_SCHEMA = 1


@dataclasses.dataclass
class AMPOptions:
    tau: float = 0.005                    # normalized-RMSE threshold
    formats: tuple = ("bf16", "fp8_e4m3")
    ref_format: str = "bf16"
    objective: str = "ET"                 # ET | TT | M
    max_group_size: int = 8               # cap F^{L_j} enumeration
    drop_residual: bool = True            # paper-faithful
    ip_method: str = "auto"
    ip_bins: int = 8192
    pareto_prune: bool = True             # lossless beyond-paper speedup
    hw: HWProfile = H100_SXM


def predicted_loss_mse(sens: SensitivityResult, assignment: dict,
                       ref: str = "bf16") -> float:
    """Eq. (6)/(23): additive per-layer loss MSE, d=0 at the reference fmt."""
    return sens.loss_mse(assignment, ref=ref)


def build_groups(model, opts: AMPOptions, quantizable: Optional[set] = None):
    """Partition and return (graph, ordered groups of quantizable op names)."""
    graph = G.build_graph(model)
    groups = partition_sequential(graph, drop_residual=opts.drop_residual,
                                  max_group_size=opts.max_group_size)
    if quantizable is not None:
        groups = [[n for n in g if n in quantizable] for g in groups]
        groups = [g for g in groups if g]
    return graph, groups


def _leaves(tree) -> list:
    """Tensors of a nested dict in sorted-key order (the reference's
    ``tree_leaves`` order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _params_fingerprint(params) -> str:
    """Cheap content fingerprint to invalidate cached bundles on new params:
    element count and sum of |w|, each leaf summed in float64 on its device
    (the reference sums in f32; float64 keeps the 7 printed digits
    independent of summation order)."""
    n = 0
    acc = 0.0
    for leaf in _leaves(params):
        n += int(leaf.numel())
        acc += float(leaf.detach().abs().sum(dtype=torch.float64))
    return f"{n}:{acc:.6e}"


@dataclasses.dataclass
class CalibrationBundle:
    """Everything the IP needs, detached from the model: the paper's
    expensive calibration phase as a durable artifact.

    ``objectives`` maps objective name -> ``{"groups": [[op name, ...], ...],
    "gains": [np.ndarray of len F^{L_j} per group]}``; gain rows are indexed
    by :func:`~repro_torch.core.timegain.enumerate_combos` order over ``formats``,
    so combos are regenerated deterministically at solve time instead of
    being stored.
    """

    sens: SensitivityResult
    formats: tuple                     # e.g. ("bf16", "fp8_e4m3")
    ref_format: str
    objectives: dict                   # objective -> {"groups": ..., "gains": ...}
    default_tau: float = 0.005
    default_objective: str = "ET"
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.formats = tuple(self.formats)
        for entry in self.objectives.values():
            entry["groups"] = [list(g) for g in entry["groups"]]
            entry["gains"] = [np.asarray(g, np.float64) for g in entry["gains"]]

    # ---- introspection ---------------------------------------------------
    @property
    def op_names(self) -> list:
        return [op.name for op in self.sens.ops]

    def unknown_ops(self, known_ops) -> set:
        """Calibrated op names that do not exist in ``known_ops``.

        The serving launcher checks this before solving from a bundle: a
        non-empty result means the bundle was calibrated on a different model
        (or op namespace) and its plans would silently not apply.
        """
        known = set(known_ops)
        return {n for n in self.op_names if n not in known}

    # ---- the cheap phase: IP solves over the tabulated gains -------------
    def solve(self, tau: Optional[float] = None,
              objective: Optional[str] = None, *,
              budget: Optional[float] = None, ip_method: str = "auto",
              ip_bins: int = 8192) -> MPPlan:
        """Solve the IP (eq. 5) for one (tau, objective). Pure NumPy: no
        model, params, or calibration data required."""
        tau = self.default_tau if tau is None else tau
        objective = objective or self.default_objective
        if objective not in self.objectives:
            raise KeyError(
                f"objective {objective!r} not calibrated; bundle has "
                f"{sorted(self.objectives)}")
        # measured tier: a tabulated "<obj>_wall" table (see
        # tabulate_measured_gains) prices plans with measured wall-clock
        # gains instead of the analytic tables for the same objective; the
        # plan meta records which tier actually priced it so a production
        # solve falling back to roofline gains is visible.
        table_key = objective
        if f"{objective}_wall" in self.objectives:
            table_key = f"{objective}_wall"
        if table_key.endswith("_wall"):
            gain_tier = "measured"
        elif objective == "ET":
            gain_tier = "roofline_fallback"
        else:
            gain_tier = "analytic"
        entry = self.objectives[table_key]
        groups, tables = entry["groups"], entry["gains"]

        mckp_groups = []
        for gi, (group, c) in enumerate(zip(groups, tables)):
            combos = enumerate_combos(len(group), self.formats)
            d = np.array([
                sum(0.0 if f == self.ref_format else
                    self.sens.sensitivity.get(name, 0.0) * get_format(f).alpha
                    for name, f in zip(group, combo))
                for combo in combos])
            mckp_groups.append(MCKPGroup(name=f"group_{gi}", labels=combos,
                                         c=c, d=d))

        if budget is None:
            budget = tau ** 2 * self.sens.loss_sq_mean
        res = solve_mckp(mckp_groups, budget, method=ip_method, bins=ip_bins)

        assignment = {}
        for group, combo in zip(groups, res.labels):
            for name, fmt in zip(group, combo):
                if fmt != self.ref_format:
                    assignment[name] = fmt

        return MPPlan(
            assignment=assignment,
            groups=[list(g) for g in groups],
            objective=objective,
            tau=float(tau),
            budget=float(budget),
            predicted_loss_mse=float(res.d_total),
            predicted_gain=float(res.c_total),
            ip_gap=float(res.gap),
            meta={"n_ops": len(self.sens.ops), "n_groups": len(groups),
                  "loss_sq_mean": self.sens.loss_sq_mean,
                  "ip_method": res.method,
                  "gain_tier": gain_tier, "gain_table": table_key},
        )

    def pareto(self, taus: Sequence[float], objective: Optional[str] = None,
               **solve_kw) -> list:
        """One plan per tau — the paper's Fig. 4 tradeoff frontier from a
        single calibration."""
        return [self.solve(tau=t, objective=objective, **solve_kw)
                for t in taus]

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": BUNDLE_SCHEMA,
            "sens": self.sens.to_dict(),
            "formats": list(self.formats),
            "ref_format": self.ref_format,
            "objectives": {
                obj: {"groups": [list(g) for g in entry["groups"]],
                      "gains": [np.asarray(t).tolist()
                                for t in entry["gains"]]}
                for obj, entry in self.objectives.items()},
            "default_tau": float(self.default_tau),
            "default_objective": self.default_objective,
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationBundle":
        schema = d.get("schema", BUNDLE_SCHEMA)
        if schema > BUNDLE_SCHEMA:
            raise ValueError(f"bundle schema {schema} is newer than "
                             f"supported {BUNDLE_SCHEMA}")
        return cls(sens=SensitivityResult.from_dict(d["sens"]),
                   formats=tuple(d["formats"]),
                   ref_format=d["ref_format"],
                   objectives={obj: {"groups": entry["groups"],
                                     "gains": entry["gains"]}
                               for obj, entry in d["objectives"].items()},
                   default_tau=float(d.get("default_tau", 0.005)),
                   default_objective=d.get("default_objective", "ET"),
                   meta=dict(d.get("meta", {})))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CalibrationBundle":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        """``.npz`` -> binary gain tables + JSON header; else plain JSON."""
        path = str(path)
        if path.endswith(".npz"):
            d = self.to_dict()
            arrays = {}
            for obj, entry in d["objectives"].items():
                for gi, table in enumerate(entry["gains"]):
                    arrays[f"gains::{obj}::{gi}"] = np.asarray(table,
                                                               np.float64)
                entry["gains"] = len(entry["gains"])  # count placeholder
            header = json.dumps(d, sort_keys=True).encode("utf-8")
            arrays["header"] = np.frombuffer(header, np.uint8)
            with open(path, "wb") as f:
                np.savez_compressed(f, **arrays)
        else:
            with open(path, "w") as f:
                f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "CalibrationBundle":
        path = str(path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                d = json.loads(bytes(z["header"].tobytes()).decode("utf-8"))
                for obj, entry in d["objectives"].items():
                    entry["gains"] = [z[f"gains::{obj}::{gi}"]
                                      for gi in range(int(entry["gains"]))]
                return cls.from_dict(d)
        with open(path) as f:
            return cls.from_json(f.read())


def _calib_hash(batches) -> Optional[str]:
    """Content hash of the calibration set (array bytes, order-sensitive).

    Keys registry lookups and cache validation: two bundles for the same
    checkpoint calibrated on different data are different artifacts."""
    if batches is None:
        return None
    import hashlib
    h = hashlib.sha256()
    for batch in batches:
        for key in sorted(batch):
            v = batch[key]
            v = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            h.update(key.encode("utf-8"))
            h.update(str(v.shape).encode("utf-8"))
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def tabulate_measured_gains(bundle: CalibrationBundle, run_factory: Callable,
                            *, objective: str = "ET", n_iters: int = 5,
                            n_warmup: int = 2) -> str:
    """Measure per-group wall-clock gains (paper Sec. 2.3.1) and tabulate
    them into ``bundle.objectives["<objective>_wall"]`` over the same groups
    as the analytic ``objective`` tables.

    Once tabulated (and persisted via ``bundle.save``), every
    ``bundle.solve(objective=...)`` for that objective automatically prices
    plans with the measured gains — the production tier — and stamps
    ``plan.meta["gain_tier"] = "measured"``; bundles without the table keep
    solving from the analytic gains with ``"roofline_fallback"`` flagged.

    ``run_factory(assignment)`` must return a zero-arg callable executing one
    end-to-end step (e.g. a serving prefill) under the given op->format
    assignment and ending in a device synchronize (see
    :class:`~repro_torch.core.timegain.WallClockGainModel`).
    Returns the objective key the table was stored under.
    """
    if objective.endswith("_wall"):
        raise ValueError(f"objective {objective!r} is already a measured tier")
    if objective not in bundle.objectives:
        raise KeyError(
            f"objective {objective!r} not calibrated; bundle has "
            f"{sorted(bundle.objectives)}")
    gm = WallClockGainModel(run_factory, n_iters=n_iters, n_warmup=n_warmup)
    op_index = {op.name: op for op in bundle.sens.ops}
    groups = bundle.objectives[objective]["groups"]
    tables = []
    for group in groups:
        ops = [op_index[n] for n in group]
        combos = enumerate_combos(len(ops), bundle.formats)
        tables.append(np.asarray(gm.gains(ops, combos), np.float64))
    key = f"{objective}_wall"
    bundle.objectives[key] = {"groups": [list(g) for g in groups],
                              "gains": tables}
    bundle.meta.setdefault("gain_models", {})[key] = type(gm).__name__
    return key


def _cache_hit(bundle: CalibrationBundle, opts: AMPOptions,
               fingerprint: str, gain_models: dict,
               calib_hash: Optional[str] = None) -> bool:
    """A cached bundle is reusable iff it was calibrated with the same
    formats, partition options, params content, calibration set, and its
    gain tables come from the same gain-model type per requested objective
    (a bundle of roofline tables must not satisfy a WallClockGainModel
    request)."""
    meta = bundle.meta
    recorded = meta.get("gain_models", {})
    cached_ch = meta.get("calib_hash")
    return (bundle.formats == tuple(opts.formats)
            and bundle.ref_format == opts.ref_format
            and meta.get("max_group_size") == opts.max_group_size
            and meta.get("drop_residual") == opts.drop_residual
            and meta.get("hw") == opts.hw.name  # gain tables are hw-specific
            and meta.get("params_fingerprint") == fingerprint
            # pre-calib_hash artifacts (or sens-injected runs) stay valid
            and (cached_ch is None or calib_hash is None
                 or cached_ch == calib_hash)
            and set(gain_models) <= set(bundle.objectives)
            and all(recorded.get(obj) == type(gm).__name__
                    for obj, gm in gain_models.items()))


def calibrate(model, params, calib_batches: Optional[Iterable],
              opts: Optional[AMPOptions] = None, *,
              gain_models: Optional[dict] = None,
              sens: Optional[SensitivityResult] = None,
              loss_fn: Optional[Callable] = None,
              cache: Optional[str] = None) -> CalibrationBundle:
    """The expensive phase of Algorithm 1, run once per (model, params).

    Stages: (1) sensitivity calibration over ``calib_batches`` — skipped when
    a precomputed ``sens`` is injected; (2) partition into sequential
    sub-graphs; (3) per-group gain tables for every model in ``gain_models``
    (default: the Sec. 2.3 registry — ET roofline, TT theoretical, M memory).

    ``cache``: path of a saved bundle. If it exists and matches (same
    formats, partition options, params fingerprint, and objectives), it is
    loaded and returned without touching the model — making repeated
    calibration calls resumable; otherwise calibration runs and the result
    is saved there.
    """
    opts = opts or AMPOptions()
    if gain_models is None:
        gain_models = default_gain_models(opts.hw, ref=opts.ref_format)

    fingerprint = _params_fingerprint(params)
    if calib_batches is not None:
        calib_batches = list(calib_batches)
    calib_hash = _calib_hash(calib_batches)
    if cache and os.path.exists(cache):
        try:
            cached = CalibrationBundle.load(cache)
        except Exception:
            cached = None
        if cached is not None and _cache_hit(cached, opts, fingerprint,
                                             gain_models, calib_hash):
            # solve defaults are caller convenience, not part of the artifact
            cached.default_tau = opts.tau
            cached.default_objective = opts.objective
            return cached

    loss_fn = loss_fn or (lambda p, b, ctx: model.loss(p, b, ctx))

    # ---- Alg.1 line 2: sensitivity calibration ----
    if sens is None:
        sens = calibrate_sensitivity(loss_fn, params, calib_batches)
    op_index = {op.name: op for op in sens.ops}

    # ---- Alg.1 line 1: partition (once; filtered per objective) ----
    graph = G.build_graph(model)
    base_groups = partition_sequential(graph, drop_residual=opts.drop_residual,
                                       max_group_size=opts.max_group_size)

    def groups_for(quantizable: set) -> list:
        groups = [[n for n in g if n in quantizable] for g in base_groups]
        return [g for g in groups if g]

    # ---- Alg.1 line 3: per-group gain tables for every registered model ----
    objectives = {}
    for objective, gain_model in gain_models.items():
        if objective == "M":
            # memory is additive per layer and quantizes linear layers only:
            # trivial per-layer groups (Sec. 2.3.3)
            quantizable = {n for n, op in op_index.items()
                           if op.kind == "linear"}
            groups = [[n] for g in groups_for(quantizable) for n in g]
        else:
            groups = groups_for(set(op_index))
        tables = []
        for group in groups:
            ops = [op_index[n] for n in group]
            combos = enumerate_combos(len(ops), opts.formats)
            tables.append(np.asarray(gain_model.gains(ops, combos),
                                     np.float64))
        objectives[objective] = {"groups": groups, "gains": tables}

    bundle = CalibrationBundle(
        sens=sens,
        formats=tuple(opts.formats),
        ref_format=opts.ref_format,
        objectives=objectives,
        default_tau=opts.tau,
        default_objective=opts.objective,
        meta={"max_group_size": opts.max_group_size,
              "drop_residual": opts.drop_residual,
              "hw": opts.hw.name,
              "params_fingerprint": fingerprint,
              "calib_hash": calib_hash,
              "n_calib_batches": sens.n_batches,
              "gain_models": {obj: type(gm).__name__
                              for obj, gm in gain_models.items()},
              "arch": getattr(getattr(model, "cfg", None), "name", None)},
    )
    if cache:
        bundle.save(cache)
    return bundle


def auto_mixed_precision(model, params, calib_batches: Iterable,
                         opts: AMPOptions, gain_model=None,
                         sens: Optional[SensitivityResult] = None,
                         loss_fn: Optional[Callable] = None) -> MPPlan:
    """Legacy one-call API: calibrate then solve. Prefer the staged API when
    sweeping (tau, objective) — calibration dominates the cost and a
    :class:`CalibrationBundle` amortizes it across solves."""
    if gain_model is None:
        gain_model = default_gain_models(opts.hw,
                                         ref=opts.ref_format)[opts.objective]
    bundle = calibrate(model, params, calib_batches, opts,
                       gain_models={opts.objective: gain_model},
                       sens=sens, loss_fn=loss_fn)
    return bundle.solve(tau=opts.tau, objective=opts.objective,
                        ip_method=opts.ip_method, ip_bins=opts.ip_bins)
