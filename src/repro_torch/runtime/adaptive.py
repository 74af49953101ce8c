"""Online adaptive co-inference serving (``repro/runtime/adaptive.py``).

:class:`AdaptiveCoInferenceEngine` extends the batched engine with a
closed loop over a dynamic environment (``env/``): before each batch it
observes the environment at the virtual-clock decision instant, detects
drift and, as its policy allows, re-solves the class's operating point
((P1) or the layer-wise allocation) against the *quantized* environment
state through the ``CodesignCache``'s environment keys.  The batch is then
billed under the *unquantized* current state with the plan's frequencies
clipped to the thermal cap, so the accounting shows what the hardware
would do, plan lag included.

Three policies share the one serving path:

* ``static``   — solve once under the initial state, never replan; the
                 environment still bills it (frequency caps clip f).
* ``adaptive`` — quantized-state drift detection and realized-QoS-miss
                 monitoring, debounced by ``hysteresis_steps`` and
                 ``min_replan_interval_s``: one replan needs that many
                 consecutive discrepant observations, so a state
                 oscillating across a bucket boundary never replans.
* ``oracle``   — re-solve on every change of the *exact* state (no
                 hysteresis, no quantization).

An infeasible window degrades instead of raising: the engine falls back
to the lowest-distortion plan that still meets the deadline alone, and
past that to b̂ = 1 at the maximum frequencies.  On the kernel path a
1-bit layer computes NaN in the reference and the port alike (levels = 0,
ROADMAP C.5(c)); the fallback is ported as it stands.

Every plan a replan installs goes through the engine's weight cache
(``group_quantize`` once per plan on the kernel path) and, with
``compiled=True``, gets its own captured forward per (plan, bucket) in the
compile cache, captured the first time a batch needs it.

With ``environment=None``, or an environment whose every state leaves the
base ``SystemParams`` unchanged, every decision is the static engine's and
the responses equal ``BatchedCoInferenceEngine``'s bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Literal, Optional, Sequence

from ..core import codesign as cd
from ..core import mixed_precision as mp
from ..core.cost_model import SystemParams, total_delay, total_energy
from ..env.environment import Environment, EnvState
from ..obs import ReportBase
from .serve_engine import (BatchedCoInferenceEngine, QosClass,
                           ServeResponse)

__all__ = ["AdaptiveCoInferenceEngine", "AdaptiveReport", "ReplanEvent"]


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One controller decision that re-solved a class's operating point."""
    t_s: float
    qos: str
    reason: str                 # "env-drift" | "qos-miss" | "oracle"
    env_key: tuple              # quantized state solved against
    b_before: float             # mean agent bits before/after: equal when
    b_after: float              # the new state maps to the same plan
    degraded: bool              # fell back to a best-effort plan


@dataclasses.dataclass(frozen=True)
class AdaptiveReport(ReportBase):
    """Whole-run controller accounting, beside ``EngineReport``."""
    policy: str
    requests_served: int
    deadline_violations: int    # responses with wait + batch delay > T0
    deadline_violation_rate: float
    energy_violations: int      # batches whose per-request energy > E0
    replans: int                # controller re-solves after construction
    plan_switches: int          # replans that changed the plan
    degraded_batches: int       # batches served on a best-effort plan
    weight_variants: int        # distinct materialized agent weight sets
    env_keys_seen: int          # distinct quantized states observed
    hysteresis_steps: int


class AdaptiveCoInferenceEngine(BatchedCoInferenceEngine):
    """Batched co-inference serving under a dynamic environment."""

    def __init__(self, model, params, sysp: SystemParams, *,
                 classes: Sequence[QosClass],
                 environment: Optional[Environment] = None,
                 policy: Literal["static", "adaptive", "oracle"]
                 = "adaptive",
                 hysteresis_steps: int = 2,
                 min_replan_interval_s: float = 0.0,
                 **kwargs):
        if policy not in ("static", "adaptive", "oracle"):
            raise ValueError(f"unknown policy {policy!r}")
        if hysteresis_steps < 1:
            raise ValueError("hysteresis_steps must be >= 1")
        self.environment = environment
        self.policy = policy
        self.hysteresis_steps = int(hysteresis_steps)
        self.min_replan_interval_s = float(min_replan_interval_s)
        self.base_sysp = sysp
        self.replan_events: List[ReplanEvent] = []
        self._plan_keys: Dict[str, tuple] = {}
        self._drift_streak: Dict[str, int] = {}
        self._miss_streak: Dict[str, int] = {}
        self._last_replan_t: Dict[str, float] = {}
        self._env_keys_seen: set = set()
        self._violations = 0
        self._energy_violations = 0
        self._degraded_batches = 0
        super().__init__(model, params, sysp, classes=classes, **kwargs)
        # the canonical per-class plans; _solutions also carries the
        # frequency clipping applied just before each batch
        self._base_solutions: Dict[str, Any] = dict(self._solutions)

    # ------------------------------------------------------------------
    # operating points under an environment state
    # ------------------------------------------------------------------
    def _resolve_class(self, c: QosClass):
        """The constructor's resolution, under the environment's state at
        the (zero) clock, degrading instead of returning None: an engine
        whose initial window is infeasible still constructs."""
        if self.environment is None:
            return super()._resolve_class(c)
        sol, key = self._solve_under(c, self.environment.state_at(
            self._clock))
        self._plan_keys[c.name] = key
        return sol

    def _observed(self, state: EnvState) -> "tuple[EnvState, tuple]":
        """What the controller sees: the exact state for the oracle, the
        quantized state for the others."""
        sq = state if self.policy == "oracle" else state.quantize()
        return sq, sq.key()

    def _solve_under(self, c: QosClass, state: EnvState,
                     exact: bool = False):
        """Solve class ``c`` against a state (quantized per policy); never
        None, an infeasible window degrades.  ``exact=True`` bypasses the
        quantizer (qos-miss replans: the quantized view is what misled the
        last plan, so a re-solve on the same key would change nothing)."""
        if exact:
            sq, key = state, state.key()
        else:
            sq, key = self._observed(state)
            self._env_keys_seen.add(key)
        sysp = sq.apply(self.base_sysp)
        c_eff = QosClass(c.name, c.t0, c.e0 * sq.energy_scale)
        sol = self._counted_solution(c_eff, sysp=sysp, env_key=key)
        if sol is None:
            sol = self._degraded_solution(c_eff, sysp)
        return sol, key

    def _degraded_solution(self, c: QosClass, sysp: SystemParams):
        """Best effort in an infeasible window: the largest b̂ whose
        deadline alone is meetable (the energy budget is forfeit), else
        b̂ = 1 at the maximum frequencies; ``feasible=False`` marks the
        batches served on it.  In mixed mode the degraded b̂ is spent as a
        flat per-layer budget."""
        b_emb = self.engine.b_emb
        b_max = int(sysp.b_full)
        lam = self.engine.lam
        for b_hat in range(b_max, 0, -1):
            ok, f, fs, _ = cd.feasible_bitwidth(b_hat, sysp, c.t0,
                                                math.inf, b_emb=b_emb)
            if ok:
                sol = cd._pack(b_hat, f, fs, lam, sysp, feasible=False,
                               b_emb=b_emb)
                break
        else:
            sol = cd._pack(1, sysp.f_max, sysp.f_server_max, lam, sysp,
                           feasible=False, b_emb=b_emb)
        if not self.mixed_precision:
            return sol
        stats = self.engine.layer_stats()
        bits = (sol.b_hat,) * stats.n_layers
        return mp.MixedSolution(
            bits=bits, f=sol.f, f_server=sol.f_server,
            objective=mp.allocation_objective(stats, bits),
            uniform_b=sol.b_hat,
            uniform_objective=mp.uniform_objective(stats, sol.b_hat),
            mean_bits=float(sol.b_hat),
            delay=float(total_delay(sol.b_hat, sol.f, sol.f_server, sysp,
                                    b_emb=b_emb)),
            energy=float(total_energy(sol.b_hat, sol.f, sol.f_server,
                                      sysp, b_emb=b_emb)),
            feasible=False)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------
    @staticmethod
    def _mean_bits(sol) -> float:
        """Mean agent bits of either solution type (the plan's mean when
        mixed, b̂ when uniform): the scalar the replan log compares."""
        return float(getattr(sol, "mean_bits", None) or sol.b_hat)

    def _replan(self, name: str, t: float, state: EnvState,
                reason: str) -> None:
        """Re-solve class ``name`` against ``state`` and install the plan:
        the canonical solution (and, mixed, the class's ``QuantPlan``),
        both debounce streaks reset, the replan time stamped, and a
        :class:`ReplanEvent` recorded."""
        c = self.classes[name]
        old = self._base_solutions[name]
        # qos-miss: solve against the exact state; the bookkeeping keeps
        # the quantized key, so drift detection stays in the coarse space
        sol, _ = self._solve_under(c, state, exact=reason == "qos-miss")
        _, key = self._observed(state)
        self._plan_keys[name] = key
        self._base_solutions[name] = sol
        if self.mixed_precision:
            self._plans[name] = self.engine.plan_of(sol)
        self._drift_streak[name] = 0
        self._miss_streak[name] = 0
        self._last_replan_t[name] = t
        degraded = not getattr(sol, "feasible", True)
        self.replan_events.append(ReplanEvent(
            t_s=t, qos=name, reason=reason, env_key=key,
            b_before=self._mean_bits(old), b_after=self._mean_bits(sol),
            degraded=degraded))
        self.tracer.instant("adaptive.replan", qos=name, reason=reason,
                            env_key=str(key),
                            b_before=self._mean_bits(old),
                            b_after=self._mean_bits(sol),
                            degraded=degraded)
        self.metrics.counter("adaptive.replans", engine="Adaptive",
                             qos=name, reason=reason).inc()

    def _maybe_replan(self, name: str, state: EnvState, t: float) -> None:
        """The per-batch decision: never for ``static``, on any key change
        for ``oracle``, and for ``adaptive`` only after
        ``hysteresis_steps`` consecutive discrepant observations (drift or
        realized QoS misses), at most once per ``min_replan_interval_s``."""
        if self.policy == "static":
            return
        _, key = self._observed(state)
        self._env_keys_seen.add(key)
        current = self._plan_keys.get(name)
        if self.policy == "oracle":
            if key != current:
                self._replan(name, t, state, reason="oracle")
            return
        if key != current:
            self._drift_streak[name] = self._drift_streak.get(name, 0) + 1
            self.tracer.instant("adaptive.env_drift", qos=name,
                                env_key=str(key),
                                streak=self._drift_streak[name])
            self.metrics.counter("adaptive.drift_observations",
                                 engine="Adaptive", qos=name).inc()
        else:
            self._drift_streak[name] = 0
        drift = self._drift_streak.get(name, 0) >= self.hysteresis_steps
        miss = self._miss_streak.get(name, 0) >= self.hysteresis_steps
        if not (drift or miss):
            if key != current:
                # a drift observation the debounce swallowed
                self.tracer.instant("adaptive.replan_suppressed",
                                    qos=name, reason="hysteresis",
                                    env_key=str(key),
                                    streak=self._drift_streak[name])
                self.metrics.counter("adaptive.replans_suppressed",
                                     engine="Adaptive", qos=name,
                                     reason="hysteresis").inc()
            return
        if t - self._last_replan_t.get(name, -math.inf) \
                < self.min_replan_interval_s:
            self.tracer.instant("adaptive.replan_suppressed", qos=name,
                                reason="min-interval", env_key=str(key))
            self.metrics.counter("adaptive.replans_suppressed",
                                 engine="Adaptive", qos=name,
                                 reason="min-interval").inc()
            return
        self._replan(name, t, state,
                     reason="env-drift" if drift else "qos-miss")

    def step(self) -> List[ServeResponse]:
        """Serve one batch under the environment: observe the state at the
        batch's earliest start, maybe replan, bill the batch under the
        true state with the plan's frequencies clipped to the live caps,
        then feed the realized deadline outcomes back into the miss
        streaks.  ``BatchedCoInferenceEngine.step`` without an
        environment."""
        if self.environment is None or not self._queue:
            return super().step()
        t = max(self._clock, self._queue[0].arrival_s)
        name = self._queue[0].qos
        state = self.environment.state_at(t)
        self._maybe_replan(name, state, t)

        # a stale plan runs slower; it does not run at a frequency that no
        # longer exists
        true_p = state.apply(self.base_sysp)
        self.engine.sysp = true_p
        base = self._base_solutions[name]
        self._solutions[name] = dataclasses.replace(
            base, f=min(base.f, true_p.f_max),
            f_server=min(base.f_server, true_p.f_server_max))
        responses = super().step()

        c = self.classes[name]
        bstats = self.batch_history[-1]
        viol = sum(1 for r in responses
                   if r.stats.total_delay_s > c.t0 * (1.0 + 1e-9))
        self._violations += viol
        if bstats.amortized_energy_j > c.e0 * (1.0 + 1e-9):
            self._energy_violations += 1
        if not getattr(base, "feasible", True):
            self._degraded_batches += 1
        if viol:
            self._miss_streak[name] = self._miss_streak.get(name, 0) + 1
        else:
            self._miss_streak[name] = 0
        return responses

    # ------------------------------------------------------------------
    def solution_for(self, qos_name: str):
        """The class's canonical operating point (before the per-batch
        frequency clipping)."""
        if self.environment is None:
            return super().solution_for(qos_name)
        return self._base_solutions[qos_name]

    def adaptive_report(self) -> AdaptiveReport:
        """The controller's accounting for the whole run: replans, plan
        switches, degraded batches, realized QoS violations and the
        weight cache's growth."""
        switches = sum(1 for e in self.replan_events
                       if e.b_before != e.b_after)
        wc = self.engine._weight_cache
        return AdaptiveReport(
            policy=self.policy,
            requests_served=self._served,
            deadline_violations=self._violations,
            deadline_violation_rate=self._violations / self._served
            if self._served else 0.0,
            energy_violations=self._energy_violations,
            replans=len(self.replan_events),
            plan_switches=switches,
            degraded_batches=self._degraded_batches,
            weight_variants=len(wc) if wc is not None else 0,
            env_keys_seen=len(self._env_keys_seen),
            hysteresis_steps=self.hysteresis_steps)
