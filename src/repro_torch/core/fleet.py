"""Multi-agent fleet co-design: shared edge-server allocation
(``repro/core/fleet.py``, copied).

The paper's joint (b̂, f, f̃) design is derived for one agent–server
pair.  The fleet problem serves N heterogeneous agents — each with its
own weight statistic λ_i, hardware constants, and per-request budgets
(T0_i, E0_i) — from **one** edge server whose compute is a contended
resource.  The server is *frequency-partitioned*: agent i's slice
behaves like a private server with maximum frequency α_i·f̃_max, with
the shares summing to at most one,

    (P-fleet)   min_{b, α}  Σ_i w_i · [D^U_i(b_i − 1) − D^L_i(b_i − 1)]
                s.t.        T_i(b_i, f_i, α_i) ≤ T0_i      ∀i
                            E_i(b_i, f_i, α_i) ≤ E0_i      ∀i
                            Σ_i α_i ≤ 1,   α_i > 0
                            b_i ∈ {1..B_max,i},  0 ≤ f_i ≤ f_max,i.

Given a share vector α the problem separates into N independent
single-pair (P1)s — agent i solves the paper's problem against
``shared_params(sysp_i, α_i)``, its own ``SystemParams`` with
``f_server_max`` (and optionally ``link_bps``, for a TDMA uplink slice)
scaled by α_i.  Each per-agent objective is decreasing in b_i and each
agent's largest feasible bit-width is nondecreasing in α_i, so the
coupling collapses to *share thresholds*: ``min_share_for(agent, b)``
is the smallest α that makes bit-width b feasible (feasibility is
monotone in α, so plain bisection), and the fleet problem becomes a
multiple-choice knapsack over the per-agent bit curves.

:func:`solve_fleet` solves it water-filling-style: start every agent at
b_i = 1 with its minimal feasible share (if even that overflows the
server, the fleet is infeasible), then repeatedly spend leftover share
on the single-bit upgrade with the best marginal bound decrease per
unit share, Δobj/Δα.  D^U is convex decreasing in b and the threshold
curve is increasing in b, so marginal ratios shrink along each agent's
curve and the greedy fills the most valuable agents first — the
discrete analogue of water-filling over N distortion curves.  Leftover
share (agents pinned at B_max or by energy) is spread equally: extra
server frequency never hurts feasibility and buys delay/energy slack.
:func:`solve_equal_split` is the α_i = 1/N baseline the fleet benchmark
compares against.

Per-agent solves go through ``codesign.solve_sca`` — the *same* solver
the serving engines memoize through their shared ``CodesignCache``, so
the allocator's per-agent solutions are exactly what the engines
re-derive (a cache hit when the cache is shared).  Mixed-precision
fleets reuse these shares: the share split is decided on the uniform-b̂
surrogate, and each engine realizes a per-layer ``QuantPlan`` under its
assigned slice.

Host-side float64 numpy, like ``codesign.py``: this runs once per
fleet, not in the serving hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from . import codesign as cd
from .cost_model import SystemParams

__all__ = [
    "FleetAgent",
    "FleetSolution",
    "shared_params",
    "min_share_for",
    "solve_fleet",
    "solve_equal_split",
]

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Agent record and the shared-server parameter view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetAgent:
    """One agent–server pair inside a fleet, as the allocator sees it.

    ``sysp`` carries the agent's own hardware constants with
    ``f_server_max`` set to the **full** (unshared) server frequency;
    the allocator decides what fraction of it the agent receives.
    ``weight`` scales the agent's term of the fleet objective (traffic
    share or priority).  ``b_emb`` makes the per-agent solves link-aware
    exactly as in ``codesign.solve_sca`` (None = computation-only).
    """

    name: str
    lam: float                  # exponential-MLE weight statistic (eq. 3)
    sysp: SystemParams
    t0: float
    e0: float
    weight: float = 1.0
    b_emb: Optional[int] = None

    def __post_init__(self):
        if self.lam <= 0.0:
            raise ValueError(f"agent {self.name!r}: lam must be positive")
        if self.t0 <= 0.0 or self.e0 <= 0.0:
            raise ValueError(f"agent {self.name!r}: (T0, E0) must be "
                             "positive")
        if self.weight <= 0.0:
            raise ValueError(f"agent {self.name!r}: weight must be positive")


def shared_params(p: SystemParams, share: float, *,
                  share_link: bool = False) -> SystemParams:
    """Agent ``p`` granted fraction ``share`` of the edge server.

    The server slice is frequency-partitioned: the agent's effective
    server ceiling is ``share * f_server_max`` (eq. (5) then charges
    the slice's delay; eq. (7) bills energy at the *absolute* realized
    frequency, so a smaller slice can only spend less server energy).
    With ``share_link`` the uplink is a TDMA resource divided the same
    way (``link_bps`` scaled by ``share``); by default only the server
    is contended, matching the (P-fleet) formulation.

    ``share == 1`` returns params equal to ``p`` (same dataclass
    fields), which is what makes a single-agent fleet bitwise identical
    to the single-pair engines — cache keys included.
    """
    if not 0.0 < share <= 1.0 + 1e-12:
        raise ValueError(f"share must be in (0, 1], got {share}")
    share = min(share, 1.0)
    fields = {"f_server_max": p.f_server_max * share}
    if share_link and p.link_bps > 0.0:
        fields["link_bps"] = p.link_bps * share
    return dataclasses.replace(p, **fields)


# ---------------------------------------------------------------------------
# Share thresholds
# ---------------------------------------------------------------------------

def min_share_for(agent: FleetAgent, b_hat: int, *,
                  share_link: bool = False, iters: int = 50,
                  ) -> Optional[float]:
    """Smallest server share under which ``b_hat`` meets (T0_i, E0_i).

    Feasibility is monotone nondecreasing in the share (a bigger slice
    only loosens the server-frequency box of the min-energy-under-
    deadline subproblem), so the threshold is found by bisection over
    (0, 1].  Returns None when ``b_hat`` is infeasible even with the
    whole server.  The returned share is the bisection's *feasible*
    upper bracket, so building an engine at exactly this share succeeds.
    """

    def ok(share: float) -> bool:
        p = shared_params(agent.sysp, share, share_link=share_link)
        return cd.feasible_bitwidth(b_hat, p, agent.t0, agent.e0,
                                    b_emb=agent.b_emb)[0]

    if not ok(1.0):
        return None
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if mid <= 0.0:
            break
        if ok(mid):
            hi = mid
        else:
            lo = mid
    return hi


# ---------------------------------------------------------------------------
# Solution record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetSolution:
    """A share vector plus the per-agent (P1) solutions it induces.

    ``solutions[i]`` is agent i's ``CodesignSolution`` under
    ``shared_params(sysp_i, shares[i])``; ``aggregate_bound`` is the
    (P-fleet) objective Σ_i w_i · objective_i at those solutions.
    ``solves`` counts single-pair solver invocations (threshold
    bisections count feasibility probes, not solves).
    """

    solver: str                 # "water-filling" | "equal-split"
    shares: tuple               # per-agent server fraction, sums to <= 1
    solutions: tuple            # per-agent CodesignSolution
    aggregate_bound: float      # Σ w_i (D^U - D^L) at the solutions
    upgrades: int = 0           # greedy single-bit upgrades applied
    solves: int = 0
    # one record per greedy upgrade, in application order:
    # (agent name, new bit-width, share spent, marginal gain/share ratio)
    # — the decision log the fleet engine's tracer replays
    upgrade_log: tuple = ()


def _finalize(agents: Sequence[FleetAgent], shares: Sequence[float],
              solver: str, *, share_link: bool, upgrades: int = 0,
              upgrade_log: tuple = ()) -> Optional[FleetSolution]:
    """Solve every agent at its final share and assemble the record."""
    sols = []
    for a, s in zip(agents, shares):
        p = shared_params(a.sysp, s, share_link=share_link)
        sol = cd.solve_sca(a.lam, p, a.t0, a.e0,
                           b_max=int(p.b_full), b_emb=a.b_emb)
        if sol is None:
            return None
        sols.append(sol)
    agg = sum(a.weight * s.objective for a, s in zip(agents, sols))
    return FleetSolution(solver=solver, shares=tuple(float(s)
                                                     for s in shares),
                         solutions=tuple(sols), aggregate_bound=float(agg),
                         upgrades=upgrades, solves=len(sols),
                         upgrade_log=upgrade_log)


def _validate(agents: Sequence[FleetAgent]) -> None:
    if not agents:
        raise ValueError("need at least one FleetAgent")
    names = [a.name for a in agents]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate agent names: {sorted(names)}")


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

def solve_equal_split(agents: Sequence[FleetAgent], *,
                      share_link: bool = False) -> Optional[FleetSolution]:
    """The α_i = 1/N baseline: every agent gets the same server slice.

    Returns None when any agent is infeasible under its equal slice —
    the baseline has no degrade path; the joint allocator may still
    find a feasible (unequal) split for the same fleet.
    """
    _validate(agents)
    share = 1.0 / len(agents)
    return _finalize(agents, [share] * len(agents), "equal-split",
                     share_link=share_link)


def solve_fleet(agents: Sequence[FleetAgent], *,
                share_link: bool = False) -> Optional[FleetSolution]:
    """Water-filling-style joint allocation for (P-fleet).

    1. Threshold pass: ``s_i(b)`` = minimal share making bit-width b
       feasible for agent i (None past the agent's energy/deadline
       wall).  If Σ_i s_i(1) > 1 the fleet is infeasible → None.
    2. Greedy fill: every agent starts at (b_i = 1, s_i(1)); while
       leftover share remains, apply the single-bit upgrade
       b_i → b_i + 1 maximizing  w_i·[gap_i(b_i) − gap_i(b_i+1)] /
       [s_i(b_i+1) − current share]  among those that fit.  Marginal
       ratios decrease along each agent's curve (convex D^U, increasing
       thresholds), so this is the discrete water level rising across
       the fleet's distortion curves.
    3. Leftover share is spread equally (a single-agent fleet therefore
       ends at share exactly 1.0), and every agent is re-solved at its
       final share through ``codesign.solve_sca``.
    """
    _validate(agents)
    n = len(agents)
    if n == 1:
        # trivial fleet: the whole server; identical to the pair solve
        sol = _finalize(agents, [1.0], "water-filling",
                        share_link=share_link)
        return sol

    b_caps = [int(a.sysp.b_full) for a in agents]
    # s[i][b] = minimal share for bit-width b (lazily beyond b=1)
    thresholds: list = [{} for _ in range(n)]
    bits = [1] * n
    shares = [0.0] * n
    for i, a in enumerate(agents):
        s1 = min_share_for(a, 1, share_link=share_link)
        if s1 is None:
            return None      # agent i infeasible even owning the server
        thresholds[i][1] = s1
        shares[i] = s1
    leftover = 1.0 - sum(shares)
    if leftover < -1e-9:
        return None          # minimal slices already overflow the server

    def threshold(i: int, b: int) -> Optional[float]:
        if b not in thresholds[i]:
            thresholds[i][b] = min_share_for(agents[i], b,
                                             share_link=share_link)
        return thresholds[i][b]

    upgrades = 0
    upgrade_log: list = []
    while leftover > _EPS:
        best, best_ratio, best_cost = -1, -1.0, 0.0
        for i, a in enumerate(agents):
            b = bits[i]
            if b >= b_caps[i]:
                continue
            s_next = threshold(i, b + 1)
            if s_next is None:
                continue
            cost = max(s_next - shares[i], 0.0)
            if cost > leftover + 1e-12:
                continue
            gain = a.weight * (cd.distortion_gap(float(b), a.lam)
                               - cd.distortion_gap(float(b + 1), a.lam))
            ratio = gain / max(cost, _EPS)
            if ratio > best_ratio or (ratio == best_ratio
                                      and cost < best_cost):
                best, best_ratio, best_cost = i, ratio, cost
        if best < 0:
            break
        bits[best] += 1
        shares[best] += best_cost
        leftover -= best_cost
        upgrades += 1
        upgrade_log.append((agents[best].name, bits[best],
                            float(best_cost), float(best_ratio)))

    if leftover > _EPS:
        extra = leftover / n
        shares = [s + extra for s in shares]
    return _finalize(agents, shares, "water-filling",
                     share_link=share_link, upgrades=upgrades,
                     upgrade_log=tuple(upgrade_log))
