"""Deterministic fault injection for the continuous serving engine (port of
``repro/serve/faults.py``).

A seedable schedule of faults, each of a kind the engine's containment must
handle, so that every one is reproducible in tests. The schedule logic is
pure host code, line for line the reference's: the same spec string or
seed gives the same specs and the same ``fired`` tally.

Fault kinds (``FaultSpec.kind``):

``step_exception``
    The decode or prefill step (``phase``) raises before it dispatches. The
    caches are untouched; every affected request retries through the
    preemption/resume path.
``nan_page``
    The physical KV block behind ``(slot, page)`` of the live block table
    is filled with NaN before the decode step; attention over it makes the
    row's logits non-finite, which the engine's tripwire flags.
``nan_logits``
    One decode row's logits are set to NaN after the step (a saturating
    output projection); the same tripwire catches it.
``alloc_failure``
    ``ensure_block`` / ``ensure_range`` raises for the targeted slot.
``consumer_error`` / ``consumer_stall``
    The delivery path raises or sleeps (a client that went away or stopped
    reading its stream).
``hung_step``
    The injector sleeps ``hang_s`` before the step dispatches. It counts as
    a kernel fault; repeated kernel faults degrade fused paged attention to
    the gather path.

The hooks are host-side points the engine and pool already pass (tick
boundary, step dispatch, allocation, delivery): an idle injector adds no
device work, and the schedule is anchored to the engine's step clock —
``step=k`` fires at the first chance at or after tick ``k``, once.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import torch

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultInjector", "InjectedFault",
           "poison_logit_rows"]

FAULT_KINDS = ("step_exception", "nan_page", "nan_logits", "alloc_failure",
               "consumer_error", "consumer_stall", "hung_step")


class InjectedFault(RuntimeError):
    """Raised by injector hooks; carries the spec that fired."""

    def __init__(self, msg: str, spec: "FaultSpec" = None):
        super().__init__(msg)
        self.spec = spec


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. ``step`` is the engine clock tick at (or after)
    which it arms; each spec fires once. ``slot`` targets a decode row
    (``nan_page``, ``nan_logits``, ``alloc_failure``, ``consumer_error``);
    -1 matches any. ``page`` is the logical page ``nan_page`` poisons.
    ``phase`` scopes ``step_exception`` / ``hung_step`` to ``"decode"`` or
    ``"prefill"``."""
    kind: str
    step: int = 0
    slot: int = -1
    page: int = 0
    phase: str = "decode"
    hang_s: float = 0.01

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.phase not in ("decode", "prefill"):
            raise ValueError(f"phase must be decode|prefill: {self.phase!r}")
        if self.kind == "nan_page" and self.slot < 0:
            self.slot = 0            # a page poke needs a concrete target


class FaultInjector:
    """A deterministic schedule of :class:`FaultSpec` entries, consulted by
    the engine at its host-side hooks. ``fired`` tallies what triggered
    (kind -> count)."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._pending = list(self.specs)
        self.fired: dict = {}
        self.now = -1
        # delivery hooks run on the consumer thread, the others on the
        # producer: one lock guards the pending list
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec_str: str) -> "FaultInjector":
        """An injector from a spec string
        ``kind@step=3,slot=0,page=1;kind2@step=5,...``. Fields default as
        in :class:`FaultSpec`; a bare number is the step (``nan_page@3``);
        ``hang_s`` parses as float, ``phase`` as str, the rest as int."""
        specs = []
        for part in spec_str.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, rest = part.partition("@")
            kw = {}
            if rest:
                for field in rest.split(","):
                    k, eq, v = field.partition("=")
                    k = k.strip()
                    if not eq:
                        kw["step"] = int(k)
                    elif k == "phase":
                        kw[k] = v.strip()
                    elif k == "hang_s":
                        kw[k] = float(v)
                    else:
                        kw[k] = int(v)
            specs.append(FaultSpec(kind=kind.strip(), **kw))
        if not specs:
            raise ValueError(f"empty fault spec {spec_str!r}")
        return cls(specs)

    @classmethod
    def random(cls, seed: int, n_faults: int, *, max_step: int = 20,
               n_slots: int = 4, max_pages: int = 4,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultInjector":
        """``n_faults`` specs whose kinds, steps, slots, pages and phases
        come from a private ``random.Random(seed)``: the same seed gives
        the same schedule, in both packages."""
        import random as _random
        rng = _random.Random(seed)
        specs = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            specs.append(FaultSpec(
                kind=kind,
                step=rng.randrange(max_step),
                slot=rng.randrange(n_slots),
                page=rng.randrange(max_pages),
                phase=rng.choice(["decode", "prefill"]),
                hang_s=0.001))
        return cls(specs)

    # ---- engine hooks ----
    def tick(self, now: int) -> None:
        self.now = now

    def _take(self, kind: str, *, phase: Optional[str] = None,
              slot: Optional[int] = None) -> Optional[FaultSpec]:
        """Pop the first pending spec of ``kind`` armed at the current tick
        (``spec.step <= now``) that matches ``phase`` and ``slot``."""
        with self._lock:
            for sp in self._pending:
                if sp.kind != kind or sp.step > self.now:
                    continue
                if phase is not None and sp.phase != phase:
                    continue
                if slot is not None and sp.slot >= 0 and sp.slot != slot:
                    continue
                self._pending.remove(sp)
                self.fired[kind] = self.fired.get(kind, 0) + 1
                return sp
        return None

    def on_step(self, phase: str) -> Optional[str]:
        """Before a step dispatches: raises :class:`InjectedFault` for an
        armed ``step_exception``; sleeps and returns ``"hung"`` for an armed
        ``hung_step``; None otherwise."""
        sp = self._take("hung_step", phase=phase)
        if sp is not None:
            time.sleep(sp.hang_s)
            return "hung"
        sp = self._take("step_exception", phase=phase)
        if sp is not None:
            raise InjectedFault(
                f"injected {phase} step exception at tick {self.now}", sp)
        return None

    def on_alloc(self, slot: int) -> None:
        """Before ``ensure_block`` / ``ensure_range`` for ``slot``."""
        sp = self._take("alloc_failure", slot=slot)
        if sp is not None:
            raise InjectedFault(
                f"injected allocation failure for slot {slot} at tick "
                f"{self.now}", sp)

    def take_poisons(self) -> list:
        """Every armed ``nan_page`` / ``nan_logits`` spec, popped: the
        engine poisons pages before the decode step and logit rows after
        it."""
        out = []
        while True:
            sp = self._take("nan_page") or self._take("nan_logits")
            if sp is None:
                return out
            out.append(sp)

    def on_deliver(self, rid: int, slot: int) -> None:
        """In the delivery path, before the streaming callback: sleeps for
        an armed ``consumer_stall``, raises for a ``consumer_error``."""
        sp = self._take("consumer_stall", slot=slot)
        if sp is not None:
            time.sleep(sp.hang_s)
        sp = self._take("consumer_error", slot=slot)
        if sp is not None:
            raise InjectedFault(
                f"injected consumer error for rid {rid} at tick "
                f"{self.now}", sp)

    @property
    def exhausted(self) -> bool:
        return not self._pending


def poison_logit_rows(logits: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``logits`` (B, T, V) with the rows where ``mask`` (B,) is set made
    NaN: a new tensor, so the step's own output and every other row stay
    as they were."""
    return torch.where(mask[:, None, None],
                       torch.full((), float("nan"), dtype=logits.dtype,
                                  device=logits.device), logits)
