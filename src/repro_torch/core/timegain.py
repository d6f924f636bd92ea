"""Performance metrics c (paper Sec. 2.3): empirical / theoretical / memory
(port of ``repro/core/timegain.py``).

All gain models share one interface::

    gains(group_ops, combos) -> np.ndarray  # gained quantity per combo

where ``group_ops`` is a list of OpInfo and ``combos`` a list of per-op
format tuples. Positive = improvement over the all-BF16 reference.

* TheoreticalGainModel — eq. (24): MACs x per-MAC time gain delta_T,f.
* MemoryGainModel      — eq. (25): weight elements x byte reduction delta_M,f
                         (linear layers only; BGEMM operands are transient).
* RooflineGainModel    — the ET tier without a measurement: per-op time =
  max(compute, HBM) roofline at the op's formats (+ activation-requant
  overhead), summed within the group.
* WallClockGainModel   — the paper's actual method: measure end-to-end time
  with group j set to combo p and everything else BF16, subtract from the
  all-BF16 time (Sec. 2.3.1). The run factory's step must end in a device
  synchronize (``torch.cuda.synchronize()``): CUDA launches return before
  the card finishes, and the host clock here times whatever the step waits
  for.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.hw.profiles import HWProfile
from repro_torch.quant.formats import get_format
from repro_torch.quant.qops import OpInfo

__all__ = [
    "enumerate_combos", "default_gain_models", "TheoreticalGainModel",
    "MemoryGainModel", "RooflineGainModel", "WallClockGainModel",
]


def enumerate_combos(n_ops: int, formats: Sequence[str]) -> list:
    """All F^L format tuples for a group of L ops."""
    return list(itertools.product(formats, repeat=n_ops))


def default_gain_models(hw: HWProfile, ref: str = "bf16") -> dict:
    """The registered objective -> gain-model map (paper Sec. 2.3).

    Calibration tabulates per-group gains for every model in this registry so
    a :class:`~repro_torch.core.pipeline.CalibrationBundle` can solve any
    objective later without the model in scope. WallClockGainModel is
    deliberately not registered: it needs a live run factory (pass it
    explicitly instead).
    """
    return {"ET": RooflineGainModel(hw, ref=ref),
            "TT": TheoreticalGainModel(hw, ref=ref),
            "M": MemoryGainModel(ref=ref)}


class TheoreticalGainModel:
    """c^TT (eq. 24): additive per layer by construction."""

    def __init__(self, hw: HWProfile, ref: str = "bf16"):
        self.hw = hw
        self.ref = ref

    def op_gain(self, op: OpInfo, fmt: str) -> float:
        return op.macs * self.hw.delta_T(fmt, self.ref)

    def gains(self, group_ops: Sequence[OpInfo], combos: Sequence) -> np.ndarray:
        return np.array([
            sum(self.op_gain(op, f) for op, f in zip(group_ops, combo))
            for combo in combos])


class MemoryGainModel:
    """c^M (eq. 25): bytes saved in persistent weights; BGEMM contributes 0."""

    def __init__(self, ref: str = "bf16"):
        self.ref_bytes = get_format(ref).bytes

    def op_gain(self, op: OpInfo, fmt: str) -> float:
        if op.kind != "linear":
            return 0.0
        return op.weight_elems * (self.ref_bytes - get_format(fmt).bytes)

    def gains(self, group_ops: Sequence[OpInfo], combos: Sequence) -> np.ndarray:
        return np.array([
            sum(self.op_gain(op, f) for op, f in zip(group_ops, combo))
            for combo in combos])


class RooflineGainModel:
    """Roofline-estimated execution-time gain on the target accelerator."""

    def __init__(self, hw: HWProfile, ref: str = "bf16",
                 requant_overhead: bool = True, out_bytes: float = 2.0):
        self.hw = hw
        self.ref = ref
        self.requant_overhead = requant_overhead
        self.out_bytes = out_bytes

    def _elems(self, shape) -> int:
        n = 1
        for s in shape:
            n *= int(s)
        return n

    def op_time(self, op: OpInfo, fmt: str) -> float:
        fb = get_format(fmt).bytes
        lhs, rhs = self._elems(op.lhs_shape), self._elems(op.rhs_shape)
        out = self._elems(op.out_shape)
        bytes_moved = lhs * fb + rhs * fb + out * self.out_bytes
        if self.requant_overhead and fmt != self.ref:
            # activations arrive in bf16 and must be cast (read ref + write f)
            act = lhs if op.kind == "linear" else lhs + rhs
            bytes_moved += act * (get_format(self.ref).bytes + fb)
        t_compute = 2.0 * op.macs / self.hw.flops(fmt)
        t_memory = bytes_moved / self.hbm_bw
        return max(t_compute, t_memory)

    @property
    def hbm_bw(self) -> float:
        return self.hw.hbm_bw

    def gains(self, group_ops: Sequence[OpInfo], combos: Sequence) -> np.ndarray:
        t_ref = sum(self.op_time(op, self.ref) for op in group_ops)
        return np.array([
            t_ref - sum(self.op_time(op, f) for op, f in zip(group_ops, combo))
            for combo in combos])


@dataclasses.dataclass
class WallClockGainModel:
    """The paper's empirical method. ``run_factory(assignment)`` must return
    a zero-arg callable executing one end-to-end step (e.g. a prefill) under
    the given op->format assignment and waiting for the device to finish;
    everything not in the assignment stays at the reference format.
    """

    run_factory: Callable            # assignment dict -> () -> None
    n_iters: int = 5                 # the paper averages 5 iterations
    n_warmup: int = 2

    _base_time: Optional[float] = None

    def _time(self, assignment: dict) -> float:
        fn = self.run_factory(assignment)
        for _ in range(self.n_warmup):
            fn()
        ts = []
        for _ in range(self.n_iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def base_time(self) -> float:
        if self._base_time is None:
            self._base_time = self._time({})
        return self._base_time

    def gains(self, group_ops: Sequence[OpInfo], combos: Sequence) -> np.ndarray:
        t0 = self.base_time()
        out = []
        for combo in combos:
            if all(f == "bf16" for f in combo):
                out.append(0.0)
                continue
            assignment = {op.name: f for op, f in zip(group_ops, combo)}
            out.append(t0 - self._time(assignment))
        return np.array(out)
