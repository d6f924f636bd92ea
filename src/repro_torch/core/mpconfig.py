"""Mixed-precision plan: the pipeline's output artifact (port of
``repro/core/mpconfig.py``, NumPy-free, torch-free).

The JSON layout is the reference's, so a plan saved by either package loads
in the other unchanged. Engines accept ``mp`` as a raw ``op name -> format``
dict or an :class:`MPPlan` and normalize it with :func:`as_assignment`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Union

__all__ = ["MPPlan", "as_assignment"]


@dataclasses.dataclass
class MPPlan:
    assignment: dict                 # op name -> format name (bf16 omitted ok)
    groups: list                     # list[list[op name]]
    objective: str                   # ET | TT | M
    tau: float
    budget: float                    # tau^2 * E[g^2]
    predicted_loss_mse: float
    predicted_gain: float
    ip_gap: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # JSON turns tuple groups into lists; normalize so a plan compares
        # equal across a save/load round-trip
        self.groups = [list(g) for g in self.groups]

    def format_for(self, op_name: str) -> str:
        return self.assignment.get(op_name, "bf16")

    def unknown_ops(self, known_ops) -> set:
        """Assignment keys that name no op in ``known_ops`` (a plan solved
        for another model)."""
        known = set(known_ops)
        return {n for n in self.assignment if n not in known}

    @property
    def n_quantized(self) -> int:
        return sum(1 for f in self.assignment.values() if f != "bf16")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MPPlan":
        return cls(**json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "MPPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def as_assignment(mp: Union[None, dict, "MPPlan"]) -> Optional[dict]:
    """``None`` | assignment dict | :class:`MPPlan` -> assignment dict with
    the reference-format entries dropped (None when nothing is quantized)."""
    if mp is None:
        return None
    if isinstance(mp, MPPlan):
        mp = mp.assignment
    if not isinstance(mp, dict):
        raise TypeError(f"mp must be None, dict or MPPlan, got {type(mp)}")
    mp = {n: f for n, f in mp.items() if f != "bf16"}
    return mp or None
