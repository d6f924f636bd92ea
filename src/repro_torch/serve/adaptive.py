"""Load-adaptive mixed precision and the numerical guardrail (port of
``repro/serve/adaptive.py``). Both are host-only decision logic, the
reference's line for line.

An :class:`AdaptiveMPController` reads the continuous engine's counters
(queue depth, blocked admissions, block occupancy, decode-stall p99) every
``every`` ticks and walks a ladder of plans solved from one calibration
bundle: to a more aggressive plan (a larger ``tau``) when the queue grows,
back toward the base plan as it drains. Hysteresis bands (escalate at the
high watermarks, restore only below every low one), a minimum dwell
between swaps and one level per evaluation keep it from chattering.
``observe`` only decides; the engine applies a swap between steps through
the ``get_serving_step`` memo, whose key holds the MP assignment, so a
swap selects other (on the card: graphed) steps and never changes a step
in flight. With no controller, or one that never fires, tokens are those
of the fixed base plan.

A :class:`NumericalGuardrail` holds the running plan to the solver's
loss-MSE budget: every ``every`` decode steps the engine runs one shadow
step without quantization over the same inputs, measures one live row's
logit MSE against the active plan's, and restores the base plan once the
MSE exceeds ``margin`` times the budget ``max_breaches`` times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["AdaptiveMPController", "NumericalGuardrail"]


@dataclasses.dataclass
class AdaptiveMPController:
    """Walks a tau ladder over a calibration bundle under load.

    ``taus`` ascend: level 0 is the base (least aggressive) plan. ``observe``
    runs once per engine tick with cumulative counters; it evaluates every
    ``every`` ticks, never swaps within ``dwell`` ticks of the last swap and
    moves one level per evaluation.

    Escalate when ``queue_depth >= queue_high`` or ``occupancy >=
    occ_high`` or an admission was blocked since the last evaluation or
    ``stall_p99 >= stall_high_s``; restore when ``queue_depth <=
    queue_low`` and ``occupancy <= occ_low`` and nothing was blocked and
    ``stall_p99 < stall_high_s``. Between the bands the level holds."""

    bundle: object                       # CalibrationBundle
    taus: Sequence[float]
    objective: str = "ET"
    every: int = 4                       # evaluation cadence, engine ticks
    dwell: int = 16                      # min ticks between swaps
    queue_high: int = 4
    queue_low: int = 0
    occ_high: float = 0.90
    occ_low: float = 0.50
    stall_high_s: float = float("inf")

    def __post_init__(self):
        self.taus = tuple(float(t) for t in self.taus)
        if not self.taus:
            raise ValueError("need at least one tau level")
        if list(self.taus) != sorted(self.taus):
            raise ValueError(f"taus must ascend (base plan first): "
                             f"{self.taus}")
        if self.every < 1 or self.dwell < 0:
            raise ValueError((self.every, self.dwell))
        if not (self.queue_low <= self.queue_high
                and self.occ_low <= self.occ_high):
            raise ValueError("hysteresis bands must satisfy low <= high")
        self.level = 0
        self.downshifts = 0              # swaps toward more aggressive
        self.restores = 0                # swaps back toward the base plan
        self.guardrail_restores = 0      # forced restores (numerical breach)
        self.history: list = []          # (tick, level, tau) per swap
        self._plans: dict = {}
        self._last_eval: Optional[int] = None
        self._last_swap: Optional[int] = None
        self._blocked_seen = 0

    @classmethod
    def from_bundle(cls, bundle, base_tau: float, *, n_levels: int = 3,
                    factor: float = 2.0, **kw) -> "AdaptiveMPController":
        """Geometric ladder ``base_tau * factor**i`` for i < n_levels."""
        assert n_levels >= 1 and factor > 1.0, (n_levels, factor)
        taus = [base_tau * factor ** i for i in range(n_levels)]
        return cls(bundle=bundle, taus=taus, **kw)

    @property
    def tau(self) -> float:
        return self.taus[self.level]

    def plan_for(self, level: int):
        """The solved plan of a ladder level, solved once."""
        if level not in self._plans:
            self._plans[level] = self.bundle.solve(
                tau=self.taus[level], objective=self.objective)
        return self._plans[level]

    @property
    def plan(self):
        return self.plan_for(self.level)

    def observe(self, now: int, *, queue_depth: int, blocked: int,
                occupancy: float, stall_p99: float = 0.0):
        """One tick's counters in; the plan to swap to out (or None).

        ``now`` is the engine's step clock; ``blocked`` the scheduler's
        cumulative blocked admissions (diffed across evaluations, so
        skipped ticks lose nothing); ``occupancy`` the share of KV capacity
        in use. Observing one tick twice is a no-op."""
        if self._last_eval is not None and now < self._last_eval:
            # the clock restarted (a new drain): the cadence and dwell
            # anchors reset; the level carries over
            self._last_eval = None
            self._last_swap = None
            self._blocked_seen = 0
        if blocked < self._blocked_seen:    # a new Scheduler's counter
            self._blocked_seen = 0
        if self._last_eval is not None and now - self._last_eval < self.every:
            return None
        self._last_eval = now
        blocked_delta = blocked - self._blocked_seen
        self._blocked_seen = blocked
        if self._last_swap is not None and now - self._last_swap < self.dwell:
            return None
        hot = (queue_depth >= self.queue_high
               or occupancy >= self.occ_high
               or blocked_delta > 0
               or stall_p99 >= self.stall_high_s)
        cool = (queue_depth <= self.queue_low
                and occupancy <= self.occ_low
                and blocked_delta == 0
                and stall_p99 < self.stall_high_s)
        if hot and self.level < len(self.taus) - 1:
            self.level += 1
            self.downshifts += 1
        elif cool and self.level > 0:
            self.level -= 1
            self.restores += 1
        else:
            return None
        self._last_swap = now
        self.history.append((now, self.level, self.tau))
        return self.plan

    def force_restore(self, now: int):
        """The guardrail's override: straight back to level 0, past cadence,
        dwell and the one-level walk. Returns the base plan. Idempotent at
        level 0."""
        if self.level != 0:
            self.level = 0
            self.restores += 1
            self.history.append((now, self.level, self.tau))
        self.guardrail_restores += 1
        self._last_swap = now
        return self.plan


@dataclasses.dataclass
class NumericalGuardrail:
    """Runtime check of the solver's loss-MSE bound.

    The IP guarantees a predicted loss MSE within ``budget = tau^2 E[g^2]``
    on the calibration set. Every ``every`` decode steps the engine runs
    one shadow step without quantization over the same inputs, measures the
    f32 logit MSE of one sampled live row between the active plan and the
    shadow, and compares it with ``margin * budget``. After
    ``max_breaches`` breaches the engine restores the base plan (through
    :meth:`AdaptiveMPController.force_restore` when a controller is
    attached, else the unquantized plan). Cost: one extra decode step and
    one blocking scalar read-back per ``every`` steps; none once restored
    (the shadow would equal the active step)."""

    every: int = 16                  # shadow cadence, decode steps
    margin: float = 4.0              # budget multiplier before a breach
    max_breaches: int = 1            # breaches tolerated before restoring
    budget: Optional[float] = None   # explicit loss-MSE budget override

    def __post_init__(self):
        if self.every < 1 or self.margin <= 0 or self.max_breaches < 1:
            raise ValueError((self.every, self.margin, self.max_breaches))
        self.checks = 0
        self.breaches = 0
        self.last_mse: Optional[float] = None
        self.restored_at: Optional[int] = None
        self.history: list = []      # (tick, mse, budget) per breach

    def budget_for(self, plan) -> Optional[float]:
        """The budget to hold ``plan`` to: the explicit override, else the
        plan's solved ``budget``, else its ``predicted_loss_mse``; None (a
        bare assignment dict) records the MSE without breaching."""
        if self.budget is not None:
            return self.budget
        for attr in ("budget", "predicted_loss_mse"):
            v = getattr(plan, attr, None)
            if v is not None:
                return float(v)
        return None

    def observe_mse(self, now: int, mse: float,
                    budget: Optional[float]) -> bool:
        """Record one shadow measurement; True means restore now. A NaN MSE
        (a poisoned row, not a quantization error) never breaches."""
        self.checks += 1
        self.last_mse = float(mse)
        if budget is None or not (mse > self.margin * budget):
            return False
        self.breaches += 1
        self.history.append((int(now), float(mse), float(budget)))
        if self.breaches >= self.max_breaches and self.restored_at is None:
            self.restored_at = int(now)
            return True
        return False
