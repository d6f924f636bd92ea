"""Baseline MP strategies from the paper's evaluation (Sec. 3.1, Fig. 2;
port of ``repro/core/baselines.py``).

* Random — picks ops to quantize in a seeded random order while the
  predicted loss MSE stays under the budget (scattered patterns, Fig. 2
  bottom).
* Prefix — quantizes ops in topological order until the budget is reached
  (Fig. 2 middle).

Both respect the same tau^2 E[g^2] constraint as the IP strategies: an op's
cost is its sensitivity times its format's alpha (eq. 23), the reference
format costing nothing.
"""
from __future__ import annotations

import random as _random
from typing import Sequence

from repro_torch.core.sensitivity import SensitivityResult
from repro_torch.quant.formats import get_format

__all__ = ["random_strategy", "prefix_strategy"]


def _d(sens: SensitivityResult, name: str, fmt: str, ref: str) -> float:
    if fmt == ref:
        return 0.0
    return sens.sensitivity.get(name, 0.0) * get_format(fmt).alpha


def random_strategy(op_names: Sequence[str], sens: SensitivityResult,
                    budget: float, fmt: str = "fp8_e4m3", ref: str = "bf16",
                    seed: int = 0) -> dict:
    """Ops in a ``random.Random(seed)`` shuffle of ``op_names`` (the
    reference's order for the same seed), each quantized while the summed
    cost stays within ``budget``."""
    rng = _random.Random(seed)
    order = list(op_names)
    rng.shuffle(order)
    assignment = {}
    used = 0.0
    for name in order:
        d = _d(sens, name, fmt, ref)
        if used + d <= budget:
            assignment[name] = fmt
            used += d
    return assignment


def prefix_strategy(op_names: Sequence[str], sens: SensitivityResult,
                    budget: float, fmt: str = "fp8_e4m3",
                    ref: str = "bf16") -> dict:
    """Ops in the given (topological) order until the first one whose cost
    would exceed ``budget``."""
    assignment = {}
    used = 0.0
    for name in op_names:
        d = _d(sens, name, fmt, ref)
        if used + d > budget:
            break
        assignment[name] = fmt
        used += d
    return assignment
