"""Multi-agent fleet co-inference serving
(``repro/runtime/fleet_engine.py``).

:class:`FleetCoInferenceEngine` serves N heterogeneous agents — each
with its own model config, parameters, hardware constants, QoS budget,
and optionally its own dynamic-environment trace — from one shared edge
server.  The server split is decided once, up front, by the fleet
allocator of ``core.fleet``: either the water-filling joint allocation
(``allocator="joint"``) or the equal-split baseline
(``allocator="equal"``); each agent then serves through its own
:class:`~repro_torch.runtime.serve_engine.BatchedCoInferenceEngine` (or
:class:`~repro_torch.runtime.adaptive.AdaptiveCoInferenceEngine` when the
agent carries an environment) built against
``core.fleet.shared_params(sysp_i, α_i)`` — the agent's constants with
its server slice baked into ``f_server_max``.

Sharing that matters:

* one :class:`~repro_torch.runtime.serve_engine.CodesignCache` spans the
  fleet — two agents with the same decision inputs (λ, scaled params,
  (T0, E0), b_emb) share one (P1) solve;
* one :class:`~repro_torch.runtime.fastpath.CompiledForwardCache` spans
  the fleet.  A captured graph bakes its weights in, so agents over one
  params object share the materialized agent weights and, where their
  classes land on the same (plan, bucket), the graphs; an agent with
  weights of its own captures its own (the reference passes weights as
  arguments, so there different parameter values share compiled code:
  the port's misses are the reference's plus those captures).

Contention model: the frequency-partitioned server means each agent's
slice is always available — per-agent virtual clocks advance
independently and the fleet makespan is their max.  Cross-agent
queueing inside one slice is deliberately out of scope.

A single-agent fleet receives share exactly 1.0, so its engine is
constructed with ``SystemParams`` equal to the agent's own and serves
**bitwise identically** to a directly-built ``BatchedCoInferenceEngine``.
Member engines run on the CUDA card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import fleet as fl
from ..core.cost_model import SystemParams
from ..env.environment import Environment
from ..obs import NULL_METRICS, NULL_TRACER, ReportBase
from . import fastpath as fp
from .adaptive import AdaptiveCoInferenceEngine
from .serve_engine import (BatchedCoInferenceEngine, CodesignCache,
                           EngineReport, QosClass, ServeResponse, fit_lambda)

__all__ = ["FleetAgentSpec", "AgentServeStats", "FleetReport",
           "FleetCoInferenceEngine"]


@dataclasses.dataclass(frozen=True)
class FleetAgentSpec:
    """One fleet member, as handed to :class:`FleetCoInferenceEngine`.

    ``model``/``params`` may differ freely across agents (different
    architectures serve side by side).  ``sysp`` holds the agent's own
    constants with ``f_server_max`` at the **full** server frequency —
    the engine applies the allocated share, callers never pre-scale.
    ``qos`` is the agent's service class ((T0, E0) per request);
    ``weight`` its term in the fleet objective.  An ``environment``
    turns the agent's member engine into an adaptive one driven by
    ``policy``, closing the loop per agent while the share split stays
    fixed.
    """

    name: str
    model: Any
    params: Any
    sysp: SystemParams
    qos: QosClass
    weight: float = 1.0
    b_emb: int = 8
    environment: Optional[Environment] = None
    policy: str = "adaptive"


@dataclasses.dataclass(frozen=True)
class AgentServeStats(ReportBase):
    """Per-agent slice of a fleet run (the fleet-level analogue of
    ``ServeStats``: allocation + realized serving aggregates)."""

    name: str
    share: float                # fraction of the server's frequency
    b_hat: int                  # uniform b̂ / rounded mean plan bits
    plan_bits: tuple            # per-layer bits in mixed mode (else ())
    bound: float                # this agent's weighted objective term
    requests_served: int
    batches_served: int
    mean_occupancy: float
    clock_s: float              # the agent's virtual clock at the end
    energy_j: float
    deadline_violations: int    # responses with wait + delay > T0_i
    throughput_rps: float


@dataclasses.dataclass(frozen=True)
class FleetReport(ReportBase):
    """Whole-fleet aggregates plus the per-agent breakdown."""

    allocator: str              # "joint" | "equal"
    n_agents: int
    shares: tuple
    aggregate_bound: float      # Σ w_i · objective_i (the (P-fleet) value)
    requests_served: int
    batches_served: int
    total_energy_j: float
    makespan_s: float           # max over per-agent virtual clocks
    throughput_rps: float       # fleet requests / makespan
    deadline_violations: int
    codesign_hits: int          # shared-cache totals across the fleet
    codesign_misses: int
    compile_hits: int = 0
    compile_misses: int = 0
    compiled_variants: int = 0
    per_agent: tuple = ()       # AgentServeStats, in spec order


class FleetCoInferenceEngine:
    """N agent queues, one shared edge server, one allocation."""

    def __init__(self, agents: Sequence[FleetAgentSpec], *,
                 allocator: str = "joint",
                 max_batch: int = 8,
                 path: str = "fake",
                 scheme: str = "uniform",
                 mixed_precision: bool = False,
                 compiled: bool = False,
                 share_link: bool = False,
                 codesign_cache: Optional[CodesignCache] = None,
                 compile_cache: Optional[fp.CompiledForwardCache] = None,
                 pad_token: int = 0,
                 tracer=None, metrics=None, device=None):
        if allocator not in ("joint", "equal"):
            raise ValueError(f"unknown allocator {allocator!r} "
                             "(want 'joint' or 'equal')")
        if not agents:
            raise ValueError("need at least one FleetAgentSpec")
        names = [a.name for a in agents]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate agent names: {sorted(names)}")
        self.specs: Tuple[FleetAgentSpec, ...] = tuple(agents)
        self.allocator = allocator
        self.share_link = bool(share_link)
        self.mixed_precision = bool(mixed_precision)
        self.compiled = bool(compiled)
        self.codesign_cache = codesign_cache \
            if codesign_cache is not None else CodesignCache()
        self.compile_cache = compile_cache if compile_cache is not None \
            else (fp.CompiledForwardCache() if compiled else None)
        # observability: shared by every member engine,
        # so one trace/metrics sink sees the whole fleet
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS

        # the share split (core.fleet): per-agent λ via the engines' own
        # statistic, then water-filling or equal split over the server
        core_agents = [
            fl.FleetAgent(name=a.name,
                          lam=fit_lambda(a.params, a.model.cfg.split_layer),
                          sysp=a.sysp, t0=a.qos.t0, e0=a.qos.e0,
                          weight=a.weight, b_emb=a.b_emb)
            for a in agents]
        solve = fl.solve_fleet if allocator == "joint" \
            else fl.solve_equal_split
        alloc = solve(core_agents, share_link=self.share_link)
        if alloc is None:
            raise ValueError(
                f"fleet allocation infeasible ({allocator}): the agents' "
                "(T0, E0) budgets cannot all be met from one server — "
                "loosen a budget or shrink the fleet")
        self.allocation: fl.FleetSolution = alloc
        # replay the allocator's decisions into the trace: each greedy
        # water-filling upgrade, then every agent's final share
        for aname, new_b, cost, ratio in alloc.upgrade_log:
            self.tracer.instant("fleet.upgrade", agent=aname,
                                new_bits=new_b, share_cost=cost,
                                ratio=ratio)
        for spec, share in zip(self.specs, alloc.shares):
            self.tracer.instant("fleet.share", agent=spec.name,
                                share=share, allocator=allocator)
            self.metrics.gauge("fleet.agent_share",
                               agent=spec.name).set(share)
        self.metrics.counter("fleet.upgrades").inc(alloc.upgrades)

        # one member engine per agent, against its server slice, over
        # the shared caches
        self.engines: Dict[str, BatchedCoInferenceEngine] = {}
        for spec, share in zip(self.specs, alloc.shares):
            p = fl.shared_params(spec.sysp, share,
                                 share_link=self.share_link)
            kwargs = dict(classes=[spec.qos], max_batch=max_batch,
                          path=path, b_emb=spec.b_emb, scheme=scheme,
                          codesign_cache=self.codesign_cache,
                          mixed_precision=mixed_precision,
                          compiled=compiled,
                          compile_cache=self.compile_cache,
                          pad_token=pad_token,
                          tracer=self.tracer, metrics=self.metrics,
                          device=device)
            if spec.environment is not None:
                eng = AdaptiveCoInferenceEngine(
                    spec.model, spec.params, p,
                    environment=spec.environment, policy=spec.policy,
                    **kwargs)
            else:
                eng = BatchedCoInferenceEngine(spec.model, spec.params, p,
                                               **kwargs)
            self.engines[spec.name] = eng
        self._violations: Dict[str, int] = {a.name: 0 for a in self.specs}
        # membership: dropped agents keep their queues
        # but are skipped by step() until they rejoin; reallocate()
        # re-water-fills the server among whoever is present
        self._active = {a.name for a in self.specs}
        self._reallocations = 0

    # ------------------------------------------------------------------
    # allocation views
    # ------------------------------------------------------------------
    def share_of(self, agent: str) -> float:
        """The agent's allocated fraction of the server frequency."""
        return self.allocation.shares[self._index(agent)]

    def solution_for(self, agent: str):
        """The agent's operating point as its member engine serves it
        (a ``CodesignSolution``, or a ``MixedSolution`` in
        mixed-precision mode)."""
        spec = self.specs[self._index(agent)]
        return self.engines[agent].solution_for(spec.qos.name)

    def _index(self, agent: str) -> int:
        for i, a in enumerate(self.specs):
            if a.name == agent:
                return i
        raise KeyError(f"unknown agent {agent!r}; have "
                       f"{[a.name for a in self.specs]}")

    # ------------------------------------------------------------------
    # membership churn
    # ------------------------------------------------------------------
    @property
    def active_agents(self) -> tuple:
        """Currently-present members, in spec order."""
        return tuple(a.name for a in self.specs if a.name in self._active)

    @property
    def reallocations(self) -> int:
        """How many times the share split was re-solved — the churn
        bound is one per membership change, enforced by the supervisor
        calling :meth:`reallocate` only on a dropout/rejoin edge."""
        return self._reallocations

    def reallocate(self, active: "Sequence[str]") -> fl.FleetSolution:
        """Re-water-fill the server among ``active`` and retune each
        present member engine to its new share.

        A dropout hands its slice to the survivors (their ``f̃`` slices
        grow, possibly upgrading their b̂); a rejoin takes it back.
        Dropped agents keep their queues — their requests wait for the
        rejoin rather than being silently dropped — and their engines
        keep the last operating point.  Raises ``ValueError`` when the
        surviving subset is empty or its budgets can no longer be met
        from the shared server."""
        names = list(dict.fromkeys(active))
        for name in names:
            self._index(name)
        if not names:
            raise ValueError("fleet reallocation needs at least one "
                             "active agent")
        core = [
            fl.FleetAgent(name=a.name,
                          lam=fit_lambda(a.params, a.model.cfg.split_layer),
                          sysp=a.sysp, t0=a.qos.t0, e0=a.qos.e0,
                          weight=a.weight, b_emb=a.b_emb)
            for a in self.specs if a.name in names]
        solve = fl.solve_fleet if self.allocator == "joint" \
            else fl.solve_equal_split
        alloc = solve(core, share_link=self.share_link)
        if alloc is None:
            raise ValueError(
                f"fleet reallocation infeasible over {sorted(names)}: "
                "the surviving agents' (T0, E0) budgets cannot be met")
        shares = dict(zip([a.name for a in core], alloc.shares))
        for spec in self.specs:
            if spec.name not in shares:
                continue
            share = shares[spec.name]
            eng = self.engines[spec.name]
            p = fl.shared_params(spec.sysp, share,
                                 share_link=self.share_link)
            # retune in place: the member keeps its queue, clock, and
            # caches; only the operating point moves with the share
            eng.sysp = p
            eng.engine.sysp = p
            sol = eng._counted_solution(spec.qos, sysp=p)
            if sol is None:
                raise ValueError(
                    f"agent {spec.name!r} infeasible at share "
                    f"{share:.3f} after reallocation")
            eng._solutions[spec.qos.name] = sol
            if self.mixed_precision:
                eng._plans[spec.qos.name] = eng.engine.plan_of(sol)
            self.tracer.instant("fleet.share", agent=spec.name,
                                share=share, allocator=self.allocator,
                                reallocation=True)
            self.metrics.gauge("fleet.agent_share",
                               agent=spec.name).set(share)
        self._active = set(names)
        self._reallocations += 1
        self.metrics.counter("fleet.reallocations").inc()
        return alloc

    # ------------------------------------------------------------------
    # queue API (delegates to the member engines)
    # ------------------------------------------------------------------
    def submit(self, agent: str, tokens, arrival_s: Optional[float] = None
               ) -> int:
        """Enqueue one request on ``agent``'s queue; returns its id
        (unique per agent, not fleet-wide)."""
        spec = self.specs[self._index(agent)]
        return self.engines[agent].submit(tokens, spec.qos.name,
                                          arrival_s=arrival_s)

    def pending(self) -> int:
        return sum(e.pending() for e in self.engines.values())

    def warmup(self, max_seq: int) -> int:
        """Capture every member engine's (plan, bucket) forwards; agents
        sharing a params object and a plan hit the shared compile cache
        instead of capturing again.  Returns total misses added."""
        return sum(e.warmup(max_seq) for e in self.engines.values())

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def step(self) -> Tuple[Optional[str], List[ServeResponse]]:
        """Serve one batch from the agent whose oldest pending request
        arrived first (fleet-level FIFO across independent slices);
        returns ``(agent name, responses)`` or ``(None, [])`` when every
        queue is empty."""
        best_name, best_t = None, None
        for spec in self.specs:
            if spec.name not in self._active:
                continue  # dropped member: queue holds until rejoin
            t = self.engines[spec.name].oldest_pending_arrival()
            if t is not None and (best_t is None or t < best_t):
                best_name, best_t = spec.name, t
        if best_name is None:
            return None, []
        spec = self.specs[self._index(best_name)]
        responses = self.engines[best_name].step()
        self._violations[best_name] += sum(
            1 for r in responses
            if r.stats.total_delay_s > spec.qos.t0 * (1.0 + 1e-9))
        return best_name, responses

    def drain(self) -> Dict[str, List[ServeResponse]]:
        """Serve until every agent's queue is empty; responses grouped
        per agent, in completion order."""
        out: Dict[str, List[ServeResponse]] = {a.name: []
                                               for a in self.specs}
        # count only active queues: a dropped member's requests wait for
        # its rejoin and must not spin the drain loop
        while sum(self.engines[n].pending() for n in self.active_agents):
            name, responses = self.step()
            if name is not None:
                out[name].extend(responses)
        return out

    # ------------------------------------------------------------------
    def report(self) -> FleetReport:
        """Fleet aggregates plus per-agent :class:`AgentServeStats`."""
        per = []
        total_req = total_batches = total_viol = 0
        total_energy = 0.0
        makespan = 0.0
        agg_bound = 0.0
        for spec, share in zip(self.specs, self.allocation.shares):
            eng = self.engines[spec.name]
            rep: EngineReport = eng.report()
            sol = eng.solution_for(spec.qos.name)
            bound = spec.weight * float(sol.objective)
            agg_bound += bound
            plan = eng.plan_for(spec.qos.name)
            per.append(AgentServeStats(
                name=spec.name, share=share,
                b_hat=int(getattr(sol, "b_hat")),
                plan_bits=(plan.layer_bit_list(spec.model.cfg.split_layer)
                           if plan is not None else ()),
                bound=bound,
                requests_served=rep.requests_served,
                batches_served=rep.batches_served,
                mean_occupancy=rep.mean_occupancy,
                clock_s=rep.total_delay_s,
                energy_j=rep.total_energy_j,
                deadline_violations=self._violations[spec.name],
                throughput_rps=rep.throughput_rps))
            total_req += rep.requests_served
            total_batches += rep.batches_served
            total_energy += rep.total_energy_j
            makespan = max(makespan, rep.total_delay_s)
            total_viol += self._violations[spec.name]
        cc = self.compile_cache
        return FleetReport(
            allocator=self.allocator,
            n_agents=len(self.specs),
            shares=self.allocation.shares,
            aggregate_bound=agg_bound,
            requests_served=total_req,
            batches_served=total_batches,
            total_energy_j=total_energy,
            makespan_s=makespan,
            throughput_rps=total_req / makespan if makespan > 0 else 0.0,
            deadline_violations=total_viol,
            codesign_hits=self.codesign_cache.hits,
            codesign_misses=self.codesign_cache.misses,
            compile_hits=sum(e.engine._own_compile_hits
                             for e in self.engines.values()),
            compile_misses=sum(e.engine._own_compile_misses
                               for e in self.engines.values()),
            compiled_variants=len(cc) if cc is not None else 0,
            per_agent=tuple(per))
