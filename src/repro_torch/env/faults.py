"""Fault-injecting environment processes (DESIGN.md §15).

The chaos counterpart of `processes.py`: seeded, deterministic fault
processes realized once, up front, into time-indexed traces — the same
contract as the §9 dynamic environment, so a fault schedule is a pure
function of ``(seed, dt_s, horizon_s, processes)`` and every run over
it replays bit-identically.  Four faults cover the deployment failure
modes of the co-inference split:

* :class:`LinkOutage` — the uplink goes binary up/down as a two-state
  Markov chain (layered on top of, not replacing, the §9 link-rate
  processes: an outage means *no* transport, not a slow one);
* :class:`PacketCorruption` — an uplink payload arrives bit-flipped
  with a configurable per-step probability (detected by the
  supervisor's payload checksum, DESIGN.md §15);
* :class:`ServerPreemption` — the edge server disappears for
  repair-time windows (crash/restart events for decode recovery);
* :class:`AgentDropout` — a fleet member leaves and rejoins, driving
  re-water-filling of the server shares (DESIGN.md §11, §15).

:class:`ChaosTrace` composes them into one indexed schedule
(:class:`FaultState` per step) the :class:`repro.runtime.supervisor.
ServingSupervisor` samples at scheduling boundaries, and
:func:`chaos_from_spec` parses the JSON spec format of
``launch/serve.py --chaos-trace``.

A copy of the reference's ``repro/env/faults.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["LinkOutage", "PacketCorruption", "ServerPreemption",
           "AgentDropout", "FaultState", "ChaosTrace", "chaos_from_spec"]


# ----------------------------------------------------------------------
# fault processes — the `realize(rng, n_steps, dt_s) -> np.ndarray`
# protocol of processes.py, traces valued in {0.0, 1.0}
# ----------------------------------------------------------------------
def _markov_binary(rng: np.random.Generator, n_steps: int, *,
                   p_down: float, p_up: float, init_up: bool) -> np.ndarray:
    """Two-state up/down chain, one rng draw per step (so the schedule
    is a pure function of the seed regardless of parameter values)."""
    out = np.empty(n_steps, dtype=np.float64)
    up = bool(init_up)
    for i in range(n_steps):
        u = rng.random()
        if up:
            if u < p_down:
                up = False
        else:
            if u < p_up:
                up = True
        out[i] = 1.0 if up else 0.0
    return out


@dataclasses.dataclass(frozen=True)
class LinkOutage:
    """Binary uplink availability: a sticky Markov up/down chain.

    ``p_fail``/``p_recover`` are per-step transition probabilities; the
    stationary up-fraction is ``p_recover / (p_fail + p_recover)``
    (checked by the property tests).  Trace value 1.0 = link up.
    """

    p_fail: float = 0.05
    p_recover: float = 0.30
    init_up: bool = True

    def __post_init__(self):
        for name in ("p_fail", "p_recover"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        return _markov_binary(rng, n_steps, p_down=self.p_fail,
                              p_up=self.p_recover, init_up=self.init_up)


@dataclasses.dataclass(frozen=True)
class PacketCorruption:
    """Uplink payload bit-flips: each step's transmission is corrupted
    independently with probability ``rate``.  Trace value 1.0 = the
    payload sent during this step arrives corrupted (the supervisor's
    checksum detects it and retransmits; a bare engine serves garbage).
    """

    rate: float = 0.02

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        return (rng.random(n_steps) < self.rate).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class ServerPreemption:
    """Edge-server crash/restart windows: up/down Markov chain whose
    per-step rates derive from a mean time between failures and a mean
    time to repair, so the same physical story holds across ``dt_s``.
    Trace value 1.0 = server up."""

    mtbf_s: float = 30.0
    mttr_s: float = 5.0
    init_up: bool = True

    def __post_init__(self):
        for name in ("mtbf_s", "mttr_s"):
            v = getattr(self, name)
            if v <= 0.0:
                raise ValueError(f"{name} must be positive, got {v}")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        p_down = min(1.0, float(dt_s) / self.mtbf_s)
        p_up = min(1.0, float(dt_s) / self.mttr_s)
        return _markov_binary(rng, n_steps, p_down=p_down, p_up=p_up,
                              init_up=self.init_up)


@dataclasses.dataclass(frozen=True)
class AgentDropout:
    """Fleet-membership churn: one independent present/absent Markov
    chain per agent (``ChaosTrace`` realizes one child stream per
    agent).  Trace value 1.0 = agent present."""

    p_drop: float = 0.02
    p_rejoin: float = 0.20

    def __post_init__(self):
        for name in ("p_drop", "p_rejoin"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        return _markov_binary(rng, n_steps, p_down=self.p_drop,
                              p_up=self.p_rejoin, init_up=True)


# ----------------------------------------------------------------------
# composed schedule
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultState:
    """The fault vector at one instant (the §15 analogue of §9's
    ``EnvState``): what is up, what is corrupting, who is present."""

    t_s: float
    link_up: bool = True
    corrupt: bool = False
    server_up: bool = True
    agents_up: Tuple[bool, ...] = ()

    @property
    def server_reachable(self) -> bool:
        """True when the co-inference uplink can complete: both the
        link and the server must be up."""
        return self.link_up and self.server_up


class ChaosTrace:
    """A seeded, fully-realized fault schedule over a finite horizon.

    Mirrors :class:`~repro_torch.env.environment.Environment`: child rng
    streams are spawned from one ``SeedSequence`` (one per process plus
    one per fleet agent), every process is realized once at
    construction, and lookups are pure indexing — so two traces built
    from the same arguments are identical arrays and a supervisor run
    over them is deterministic.  Beyond the trace the last state holds
    (clamp-extend, like ``TraceReplay``).
    """

    def __init__(self, *, dt_s: float = 0.5, horizon_s: float = 60.0,
                 seed: int = 0,
                 link_outage: Optional[LinkOutage] = None,
                 corruption: Optional[PacketCorruption] = None,
                 preemption: Optional[ServerPreemption] = None,
                 dropout: Optional[AgentDropout] = None,
                 n_agents: int = 1):
        if dt_s <= 0.0:
            raise ValueError(f"dt_s must be positive, got {dt_s}")
        if horizon_s <= 0.0:
            raise ValueError(f"horizon_s must be positive, got {horizon_s}")
        if n_agents < 1:
            raise ValueError(f"n_agents must be >= 1, got {n_agents}")
        self.dt_s = float(dt_s)
        self.horizon_s = float(horizon_s)
        self.seed = int(seed)
        self.n_agents = int(n_agents)
        self.link_outage = link_outage
        self.corruption = corruption
        self.preemption = preemption
        self.dropout = dropout
        n = max(1, int(round(self.horizon_s / self.dt_s)))
        self.n_steps = n

        # one child stream per process slot + one per agent, spawned in
        # a fixed order so adding a process never reshuffles the others
        streams = [np.random.default_rng(s) for s in
                   np.random.SeedSequence(self.seed).spawn(3 + self.n_agents)]
        r_link, r_corrupt, r_server = streams[:3]
        ones = np.ones(n, dtype=np.float64)
        self.link_up = (link_outage.realize(r_link, n, self.dt_s)
                        if link_outage is not None else ones) > 0.5
        self.corrupt = (corruption.realize(r_corrupt, n, self.dt_s)
                        if corruption is not None
                        else np.zeros(n, dtype=np.float64)) > 0.5
        self.server_up = (preemption.realize(r_server, n, self.dt_s)
                          if preemption is not None else ones) > 0.5
        self.agents_up = np.stack(
            [(dropout.realize(streams[3 + i], n, self.dt_s)
              if dropout is not None else ones) > 0.5
             for i in range(self.n_agents)])

    # -- lookup -------------------------------------------------------
    @property
    def end_s(self) -> float:
        """One step past the last trace index; a ``_next_true``-family
        answer equal to this means 'never within the trace'."""
        return self.n_steps * self.dt_s

    def index_at(self, t_s: float) -> int:
        return int(np.clip(int(t_s / self.dt_s), 0, self.n_steps - 1))

    def fault_at(self, t_s: float) -> FaultState:
        i = self.index_at(t_s)
        return FaultState(
            t_s=i * self.dt_s,
            link_up=bool(self.link_up[i]),
            corrupt=bool(self.corrupt[i]),
            server_up=bool(self.server_up[i]),
            agents_up=tuple(bool(v) for v in self.agents_up[:, i]))

    def states(self) -> Iterator[FaultState]:
        for i in range(self.n_steps):
            yield self.fault_at(i * self.dt_s)

    # -- schedule queries (supervisor recovery planning) --------------
    def _next_true(self, flags: np.ndarray, t_s: float) -> float:
        """First trace time >= ``t_s`` at which ``flags`` holds; past
        the horizon the trace clamp-extends, so if the tail is down the
        answer is one step past the end (the clamped state there is the
        last step's — callers treat it as 'never recovered in trace')."""
        i = self.index_at(t_s)
        j = int(np.argmax(flags[i:])) + i if flags[i:].any() \
            else self.n_steps
        return j * self.dt_s

    def next_server_up(self, t_s: float) -> float:
        return self._next_true(self.server_up & self.link_up, t_s)

    def next_link_up(self, t_s: float) -> float:
        return self._next_true(self.link_up, t_s)

    def next_agent_up(self, agent_idx: int, t_s: float) -> float:
        return self._next_true(self.agents_up[int(agent_idx)], t_s)

    # -- aggregates ---------------------------------------------------
    def is_clean(self) -> bool:
        """True when no fault ever fires — the supervisor's pass-through
        (bitwise-identity) trigger."""
        return bool(self.link_up.all() and self.server_up.all()
                    and (~self.corrupt).all() and self.agents_up.all())

    def outage_fraction(self) -> float:
        """Fraction of steps during which the server is unreachable."""
        return float(np.mean(~(self.link_up & self.server_up)))

    def corruption_fraction(self) -> float:
        return float(np.mean(self.corrupt))


# ----------------------------------------------------------------------
# JSON spec (launch/serve.py --chaos-trace)
# ----------------------------------------------------------------------
_TOP_KEYS = {"dt_s", "horizon_s", "seed", "link_outage", "corruption",
             "preemption", "dropout"}
_SECTION_FIELDS = {
    "link_outage": {"p_fail", "p_recover", "init_up"},
    "corruption": {"rate"},
    "preemption": {"mtbf_s", "mttr_s", "init_up"},
    "dropout": {"p_drop", "p_rejoin", "n_agents"},
}


def _section(spec: dict, name: str) -> Optional[dict]:
    sub = spec.get(name)
    if sub is None:
        return None
    if not isinstance(sub, dict):
        raise ValueError(f"chaos spec: {name!r} must be an object, "
                         f"got {type(sub).__name__}")
    unknown = set(sub) - _SECTION_FIELDS[name]
    if unknown:
        raise ValueError(f"chaos spec: unknown key(s) in {name!r}: "
                         f"{sorted(unknown)}")
    return sub


def chaos_from_spec(spec: dict, *, seed: Optional[int] = None) -> ChaosTrace:
    """Build a :class:`ChaosTrace` from the ``--chaos-trace`` JSON spec.

    Raises :class:`ValueError` with a one-line message on any malformed
    spec (unknown keys, wrong types, out-of-range rates) — the CLI maps
    it to exit code 2, mirroring the fleet-spec handling.  ``seed``
    overrides the spec's own seed when given.
    """
    if not isinstance(spec, dict):
        raise ValueError("chaos spec: top level must be a JSON object, "
                         f"got {type(spec).__name__}")
    unknown = set(spec) - _TOP_KEYS
    if unknown:
        raise ValueError(f"chaos spec: unknown top-level key(s): "
                         f"{sorted(unknown)}")
    for key in ("dt_s", "horizon_s", "seed"):
        if key in spec and not isinstance(spec[key], (int, float)):
            raise ValueError(f"chaos spec: {key!r} must be a number, "
                             f"got {type(spec[key]).__name__}")
    n_agents = 1
    link = corr = preempt = drop = None
    try:
        sub = _section(spec, "link_outage")
        if sub is not None:
            link = LinkOutage(**{k: sub[k] for k in sub})
        sub = _section(spec, "corruption")
        if sub is not None:
            corr = PacketCorruption(**{k: sub[k] for k in sub})
        sub = _section(spec, "preemption")
        if sub is not None:
            preempt = ServerPreemption(**{k: sub[k] for k in sub})
        sub = _section(spec, "dropout")
        if sub is not None:
            n_agents = int(sub.get("n_agents", 1))
            drop = AgentDropout(**{k: sub[k] for k in sub
                                   if k != "n_agents"})
    except TypeError as e:  # wrong field type reaching a dataclass
        raise ValueError(f"chaos spec: {e}") from e
    return ChaosTrace(
        dt_s=float(spec.get("dt_s", 0.5)),
        horizon_s=float(spec.get("horizon_s", 60.0)),
        seed=int(seed if seed is not None else spec.get("seed", 0)),
        link_outage=link, corruption=corr, preemption=preempt,
        dropout=drop, n_agents=n_agents)
