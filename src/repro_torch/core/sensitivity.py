"""Per-layer sensitivity calibration (paper Sec. 2.2, eqs. 17-22; port of
``repro/core/sensitivity.py``).

For every quantizable op ``l`` with extended input ``z_l`` (activations and
weights of a linear layer, or both operands of a BGEMM), the sensitivity is

    s_l = (1/R) sum_r || z_l^r (.) dg/dz_l^r ||^2                    (19, 21)

and the loss-MSE contribution of executing that op in format ``f`` is

    d_{l,f} = s_l * alpha_f,   alpha_f = 2^(-2 m_f)/12               (20, 22)

Implementation: every quantizable op perturbs its operands with zero-valued
f32 *probe* tensors ``(z + p)`` that require grad; ``torch.autograd.grad``
over the probe list returns the elementwise ``dg/dz`` at each use site, and
the forward capture keeps a reference to ``z`` (no copy). Parameters do not
require grad, so autograd keeps only what the probes' gradients need. ``s_l``
is summed in f32 on the device and accumulated over calibration batches on
the host. The calibration memory overhead is one operand-sized f32 probe
and its gradient per op (no optimizer state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.quant.formats import get_format
from repro_torch.quant.qops import OpInfo, QuantContext

__all__ = ["SensitivityResult", "collect_ops", "calibrate_sensitivity",
           "params_device", "batch_to"]


@dataclasses.dataclass
class SensitivityResult:
    """Calibrated statistics over R calibration samples."""

    sensitivity: dict          # op name -> s_l (float)
    loss_sq_mean: float        # E[g^2]
    loss_mean: float           # E[g]
    n_batches: int
    ops: list                  # list[OpInfo] (from registry tracing)

    def loss_mse(self, assignment: dict, ref: str = "bf16") -> float:
        """Predicted loss MSE of an MP assignment (eq. 23).

        Eq. (23) measures noise *added* relative to the reference run, so an
        op executed at the reference format contributes d = 0 — not
        ``s_l * alpha_ref``. Ops absent from ``assignment`` stay at the
        reference format. This is the single implementation behind
        ``pipeline.predicted_loss_mse`` and the IP's per-combo d vectors.
        """
        total = 0.0
        for name, fmt in assignment.items():
            if fmt == ref:
                continue
            total += self.sensitivity.get(name, 0.0) * get_format(fmt).alpha
        return total

    def d_layer(self, name: str, fmt_name: str) -> float:
        """d_{l,f} = s_l * alpha_f (eq. 22)."""
        return self.sensitivity[name] * get_format(fmt_name).alpha

    def to_dict(self) -> dict:
        return {
            "sensitivity": dict(self.sensitivity),
            "loss_sq_mean": float(self.loss_sq_mean),
            "loss_mean": float(self.loss_mean),
            "n_batches": int(self.n_batches),
            "ops": [dataclasses.asdict(op) for op in self.ops],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SensitivityResult":
        ops = [OpInfo(name=o["name"], kind=o["kind"], spec=o["spec"],
                      lhs_shape=tuple(o["lhs_shape"]),
                      rhs_shape=tuple(o["rhs_shape"]),
                      out_shape=tuple(o["out_shape"]),
                      macs=int(o["macs"]),
                      weight_elems=int(o["weight_elems"]))
               for o in d["ops"]]
        return cls(sensitivity=dict(d["sensitivity"]),
                   loss_sq_mean=float(d["loss_sq_mean"]),
                   loss_mean=float(d["loss_mean"]),
                   n_batches=int(d["n_batches"]), ops=ops)


def params_device(params) -> torch.device:
    """The device of the first tensor in a (nested dict) param tree."""
    node = params
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


def batch_to(batch: dict, device: torch.device) -> dict:
    """A batch of tensors or arrays (numpy, or anything ``np.asarray``
    takes) as tensors on ``device``."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                .to(device))
            for k, v in batch.items()}


def _trace_ops(loss_fn: Callable, params, batch: dict) -> list:
    """One forward with a registry; quantizable OpInfo per call site,
    deduplicated. The port has no abstract trace (``jax.eval_shape``), so
    this runs one real forward under ``torch.no_grad()``: it costs one
    forward's time and its activations, freed on return."""
    registry: list = []
    ctx = QuantContext(mode="plain", registry=registry)
    with torch.no_grad():
        loss_fn(params, batch, ctx)
    # deduplicate call sites hit multiple times (e.g. loss chunks)
    seen, out = set(), []
    for op in registry:
        if op.name not in seen:
            seen.add(op.name)
            out.append(op)
    return out


def collect_ops(loss_fn: Callable, params, batch) -> list:
    """Run the model once and return every quantizable OpInfo.

    ``loss_fn(params, batch, ctx)`` must route all quantizable matmuls
    through ``repro_torch.quant.qops``. See :func:`_trace_ops` for what the
    trace costs.
    """
    return _trace_ops(loss_fn, params, batch_to(batch, params_device(params)))


def _batch_signature(batch: dict) -> tuple:
    """Hashable key describing a batch's keys and leaf shapes/dtypes."""
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(batch.items()))


def _zero_probes(shapes: dict, ops: Iterable[OpInfo],
                 device: torch.device) -> dict:
    """Zero f32 probes shaped like each op's operands, requiring grad.

    ``shapes`` maps op name -> (lhs_shape, rhs_shape) from a cached trace.
    """
    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device,
                           requires_grad=True)
    return {op.name: (z(shapes[op.name][0]), z(shapes[op.name][1]))
            for op in ops if op.name in shapes}


def calibrate_sensitivity(loss_fn: Callable, params, batches: Iterable,
                          ops: Optional[list] = None,
                          op_chunk: Optional[int] = None) -> SensitivityResult:
    """Run forward+backward over calibration batches; returns s_l per op.

    ``op_chunk``: process ops in groups of this size (bounds probe-gradient
    memory for big models at the cost of repeated backward passes).
    """
    device = params_device(params)
    first = True
    sens: dict = {}
    loss_sum = 0.0
    loss_sq_sum = 0.0
    n = 0

    # Probe shapes only depend on the batch's shape signature, so one trace
    # per *distinct* signature serves every op-chunk of every batch. The
    # first trace doubles as op collection.
    shape_cache: dict = {}

    def shapes_for(batch) -> tuple:
        sig = _batch_signature(batch)
        if sig not in shape_cache:
            traced = _trace_ops(loss_fn, params, batch)
            shape_cache[sig] = (traced, {op.name: (op.lhs_shape, op.rhs_shape)
                                         for op in traced})
        return shape_cache[sig]

    for batch in batches:
        batch = batch_to(batch, device)
        traced, shapes = shapes_for(batch)
        if first:
            if ops is None:
                ops = traced
            first = False
        groups = [ops]
        if op_chunk is not None:
            groups = [ops[i:i + op_chunk] for i in range(0, len(ops), op_chunk)]
        loss_val = None
        for group in groups:
            probes = _zero_probes(shapes, group, device)
            ctx = QuantContext(mode="probe", probes=probes, captures={})
            loss = loss_fn(params, batch, ctx)
            names = list(probes)
            grads = torch.autograd.grad(
                loss, [p for name in names for p in probes[name]])
            loss_val = float(loss.detach())
            for i, name in enumerate(names):
                z_lhs, z_rhs = ctx.captures[name]
                g_lhs, g_rhs = grads[2 * i], grads[2 * i + 1]
                s = ((z_lhs.detach().float() * g_lhs.float()).square().sum()
                     + (z_rhs.detach().float() * g_rhs.float()).square().sum())
                sens[name] = sens.get(name, 0.0) + float(s)
            del loss, grads, probes, ctx
        loss_sum += loss_val
        loss_sq_sum += loss_val ** 2
        n += 1

    if n == 0:
        raise ValueError("no calibration batches")
    return SensitivityResult(
        sensitivity={k: v / n for k, v in sens.items()},
        loss_sq_mean=loss_sq_sum / n,
        loss_mean=loss_sum / n,
        n_batches=n,
        ops=list(ops),
    )
