"""Integer program (eq. 5): Multiple-Choice Knapsack.

A copy of ``repro/core/ip_solver.py`` (NumPy only, no framework).

    max  sum_j c[j][p_j]      s.t.  sum_j d[j][p_j] <= budget,
    one configuration p_j per group j.

Solvers:
* ``brute``     — exact enumeration (small instances / tests).
* ``dp``        — pseudo-polynomial dynamic program over a discretized budget
                  grid. Costs are rounded *up*, so any returned selection is
                  feasible for the true budget (conservative).
* ``lp_greedy`` — dominance- and convex-hull-pruned greedy on incremental
                  efficiency; yields both a feasible solution and the LP
                  upper bound used to certify the dp gap.
* ``auto``      — brute when the product of choices is small, else dp and
                  lp_greedy, returning the better feasible solution plus the
                  LP bound / optimality gap.

Beyond-paper (lossless): per-group Pareto pruning of dominated configs.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import numpy as np

__all__ = ["MCKPGroup", "MCKPResult", "solve_mckp", "pareto_prune"]


@dataclasses.dataclass
class MCKPGroup:
    name: str
    labels: list            # payload per config (e.g. tuple of formats)
    c: np.ndarray           # gain per config (maximize)
    d: np.ndarray           # loss-MSE per config (constrained)

    def __post_init__(self):
        self.c = np.asarray(self.c, np.float64)
        self.d = np.asarray(self.d, np.float64)
        assert len(self.labels) == len(self.c) == len(self.d)
        assert np.all(self.d >= -1e-18), "loss MSE must be non-negative"


@dataclasses.dataclass
class MCKPResult:
    selection: list         # chosen config index per group (original indexing)
    labels: list            # chosen payloads
    c_total: float
    d_total: float
    upper_bound: float      # LP bound on the optimum
    method: str

    @property
    def gap(self) -> float:
        if self.upper_bound <= 0:
            return 0.0
        return max(0.0, (self.upper_bound - self.c_total) / abs(self.upper_bound))


def pareto_prune(group: MCKPGroup) -> tuple:
    """Remove configs dominated by another (d' <= d and c' >= c).

    Returns (kept original indices sorted by d, pruned group arrays).
    """
    order = np.lexsort((-group.c, group.d))
    kept = []
    best_c = -math.inf
    for i in order:
        if group.c[i] > best_c + 1e-18:
            kept.append(int(i))
            best_c = group.c[i]
    return kept, group.c[kept], group.d[kept]


def _solve_brute(groups: Sequence[MCKPGroup], budget: float):
    best = None
    for combo in itertools.product(*[range(len(g.c)) for g in groups]):
        d = sum(g.d[i] for g, i in zip(groups, combo))
        if d > budget + 1e-15:
            continue
        c = sum(g.c[i] for g, i in zip(groups, combo))
        if best is None or c > best[0]:
            best = (c, d, list(combo))
    if best is None:
        raise ValueError("infeasible: no combination satisfies the budget")
    return best


def _lp_greedy(pruned, budget: float):
    """Greedy on the per-group convex hull of (d, c); LP bound + feasible pick.

    pruned: list of (kept_idx, c, d) per group with d ascending, c ascending.
    """
    # start from each group's min-d config; must be feasible
    sel = [0] * len(pruned)
    base_d = sum(p[2][0] for p in pruned)
    base_c = sum(p[1][0] for p in pruned)
    if base_d > budget + 1e-15:
        raise ValueError("infeasible: even minimal-d selection exceeds budget")

    # convex-hull increments per group
    steps = []  # (ratio, group, from_idx, to_idx, dc, dd)
    for gi, (_, c, d) in enumerate(pruned):
        hull = [0]
        for j in range(1, len(c)):
            while len(hull) >= 2:
                a, b = hull[-2], hull[-1]
                r_ab = (c[b] - c[a]) / max(d[b] - d[a], 1e-300)
                r_bj = (c[j] - c[b]) / max(d[j] - d[b], 1e-300)
                if r_bj >= r_ab:
                    hull.pop()
                else:
                    break
            if c[j] > c[hull[-1]]:
                hull.append(j)
        for a, b in zip(hull, hull[1:]):
            dd = d[b] - d[a]
            dc = c[b] - c[a]
            steps.append((dc / max(dd, 1e-300), gi, a, b, dc, dd))
    steps.sort(key=lambda t: -t[0])

    rem = budget - base_d
    c_tot = base_c
    ub = base_c
    cur = {gi: 0 for gi in range(len(pruned))}
    for ratio, gi, a, b, dc, dd in steps:
        if cur[gi] != a:
            continue  # superseded (hull steps are sequential per group)
        if dd <= rem + 1e-15:
            rem -= dd
            c_tot += dc
            ub += dc
            cur[gi] = b
            sel[gi] = b
        else:
            ub += dc * (rem / max(dd, 1e-300))  # fractional LP completion
            break
    return sel, c_tot, budget - rem, ub


def _solve_dp(pruned, budget: float, bins: int):
    """DP over discretized budget. Costs rounded up -> always feasible."""
    J = len(pruned)
    if budget <= 0.0 or not np.isfinite(bins / budget):
        # zero or subnormal budget: only zero-cost configs are admissible
        sel, c_tot = [], 0.0
        for _, c, d in pruned:
            feas = [p for p in range(len(c)) if d[p] <= 0.0]
            if not feas:
                raise ValueError("infeasible at zero budget")
            p = max(feas, key=lambda i: c[i])
            sel.append(p)
            c_tot += c[p]
        return sel, c_tot
    scale = bins / budget
    NEG = -1e30
    dp = np.full(bins + 1, NEG)
    dp[0] = 0.0
    choice = np.zeros((J, bins + 1), np.int32)
    for gi, (_, c, d) in enumerate(pruned):
        # clip in float space BEFORE the int cast: ceil(d*scale) can exceed
        # int64 range at tiny budgets (overflow -> negative index)
        db = np.minimum(np.ceil(d * scale), bins + 1).astype(np.int64)
        new = np.full(bins + 1, NEG)
        pick = np.zeros(bins + 1, np.int32)
        for p in range(len(c)):
            if db[p] > bins:
                continue
            shifted = np.full(bins + 1, NEG)
            if db[p] == 0:
                shifted = dp + c[p]
            else:
                shifted[db[p]:] = dp[:bins + 1 - db[p]] + c[p]
            better = shifted > new
            new = np.where(better, shifted, new)
            pick = np.where(better, p, pick)
        dp = new
        choice[gi] = pick
    b_star = int(np.argmax(dp))
    if dp[b_star] <= NEG / 2:
        raise ValueError("infeasible under dp discretization")
    sel = [0] * J
    b = b_star
    for gi in range(J - 1, -1, -1):
        p = int(choice[gi, b])
        sel[gi] = p
        db = int(min(np.ceil(pruned[gi][2][p] * scale), bins))
        b -= db
    return sel, float(dp[b_star])


def solve_mckp(groups: Sequence[MCKPGroup], budget: float,
               method: str = "auto", bins: int = 8192,
               brute_limit: int = 200_000) -> MCKPResult:
    assert budget >= 0
    pruned = [pareto_prune(g) for g in groups]

    n_combos = 1
    for g in groups:
        n_combos *= len(g.c)
        if n_combos > brute_limit:
            break

    if method == "brute" or (method == "auto" and n_combos <= brute_limit):
        c, d, sel = _solve_brute(groups, budget)
        _, _, _, ub = _lp_greedy(pruned, budget)
        return MCKPResult(sel, [g.labels[i] for g, i in zip(groups, sel)],
                          float(c), float(d), float(max(ub, c)), "brute")

    sel_g, c_g, d_g, ub = _lp_greedy(pruned, budget)
    best = ("lp_greedy", sel_g, c_g)
    if method in ("auto", "dp"):
        sel_dp, c_dp = _solve_dp(pruned, budget, bins)
        if c_dp > c_g:
            best = ("dp", sel_dp, c_dp)
    method_used, sel_p, _ = best
    # map pruned indices back to original config indices
    sel = [pruned[gi][0][p] for gi, p in enumerate(sel_p)]
    c_tot = float(sum(g.c[i] for g, i in zip(groups, sel)))
    d_tot = float(sum(g.d[i] for g, i in zip(groups, sel)))
    assert d_tot <= budget * (1 + 1e-9) + 1e-12
    return MCKPResult(sel, [g.labels[i] for g, i in zip(groups, sel)],
                      c_tot, d_tot, float(max(ub, c_tot)), method_used)
