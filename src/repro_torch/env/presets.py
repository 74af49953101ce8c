"""Canned environment scenarios (DESIGN.md §9) for the serve CLI,
examples, and benchmarks — one function per `--env-trace` choice.

Each preset returns a fully-seeded :class:`~repro_torch.env.Environment`; the
numbers are edge-plausible defaults (home-Wi-Fi uplink rates, Jetson-ish
thermal envelope, the Table I low/medium/high frequency profiles), not
paper constants — override per call site where a benchmark needs a
specific regime.

A copy of the reference's ``repro/env/presets.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .environment import Environment
from .faults import (AgentDropout, ChaosTrace, LinkOutage,
                     PacketCorruption, ServerPreemption)
from .processes import (Battery, MarkovLink, RayleighLink, ThermalThrottle,
                        TraceReplay)

__all__ = ["PROFILE_FMAX", "wifi_markov", "rayleigh_fading",
           "profile_replay", "battery_drain", "edge_day", "constant",
           "chaos_outage", "chaos_corruption", "chaos_preemption",
           "chaos_storm", "chaos_clean"]

# Table I coarse frequency profiles (benchmarks/testbed_profiles.py);
# duplicated here so src/ never imports from benchmarks/
PROFILE_FMAX = {"low": 0.6e9, "medium": 1.2e9, "high": 2.0e9}

# good / fair / bad home-uplink states in bytes/s (~20 / 4 / 0.8 Mbit/s)
_WIFI_RATES = (2.5e6, 5.0e5, 1.0e5)
_WIFI_TRANSITION = ((0.90, 0.08, 0.02),
                    (0.10, 0.80, 0.10),
                    (0.05, 0.20, 0.75))


def wifi_markov(*, seed: int = 0, horizon_s: float = 60.0,
                dt_s: float = 0.5,
                rates_bps: Sequence[float] = _WIFI_RATES,
                transition=_WIFI_TRANSITION) -> Environment:
    """Markov-chain Wi-Fi uplink; computation constants untouched.

    Defaults model a home link hopping between good/fair/bad states
    (~20/4/0.8 Mbit/s) with sticky transitions; the adaptive engine
    sees it as a time-varying ``SystemParams.link_bps``."""
    return Environment(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                       link=MarkovLink(rates_bps=rates_bps,
                                       transition=transition))


def rayleigh_fading(*, seed: int = 0, horizon_s: float = 60.0,
                    dt_s: float = 0.5, bandwidth_hz: float = 5.0e6,
                    mean_snr: float = 8.0,
                    coherence_s: float = 2.0) -> Environment:
    """Rayleigh block-fading uplink rate trace.

    Continuous-valued rates (Shannon over an Exp(1) power gain per
    ``coherence_s`` block) — the stress case for the adaptive engine's
    state *quantizer*: raw rates almost never repeat, so only the
    log-bucketed keys keep the codesign cache and drift detector
    effective (DESIGN.md §9)."""
    return Environment(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                       link=RayleighLink(bandwidth_hz=bandwidth_hz,
                                         mean_snr=mean_snr,
                                         coherence_s=coherence_s))


def profile_replay(schedule: Sequence[str] = ("high", "low", "medium"),
                   *, seed: int = 0, dwell_s: float = 20.0,
                   dt_s: float = 0.5,
                   profiles: Optional[dict] = None) -> Environment:
    """Replay a coarse-frequency-profile schedule as the f_max cap —
    the Table I testbed profiles as a time-varying governor.

    ``schedule`` names entries of ``profiles`` (default
    :data:`PROFILE_FMAX`), each held for ``dwell_s``; the horizon is
    exactly one pass over the schedule (the last profile then holds,
    per ``TraceReplay`` clamping)."""
    fmap = PROFILE_FMAX if profiles is None else profiles
    caps = [fmap[name] for name in schedule]
    return Environment(seed=seed, horizon_s=dwell_s * len(schedule),
                       dt_s=dt_s,
                       f_cap=TraceReplay(values=caps, dwell_s=dwell_s))


def battery_drain(*, seed: int = 0, horizon_s: float = 60.0,
                  dt_s: float = 0.5, capacity_j: float = 900.0,
                  drain_w: float = 12.0, soc0: float = 0.6) -> Environment:
    """Battery running down over the horizon; E0 derates below reserve.

    Defaults start at 60% charge with a drain that crosses the
    environment's reserve SoC mid-horizon, so per-request energy
    budgets visibly tighten (``EnvState.energy_scale``) during a run."""
    return Environment(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                       battery=Battery(capacity_j=capacity_j,
                                       drain_w=drain_w, soc0=soc0))


def edge_day(*, seed: int = 0, horizon_s: float = 90.0,
             dt_s: float = 0.5) -> Environment:
    """The kitchen-sink scenario: Markov Wi-Fi + thermal throttling under
    sustained load + battery drain — all three knobs moving at once.

    The thermal time constant is horizon/4 so the throttle actually
    bites within the run, and the battery crosses its reserve — the
    default demo trace of ``launch/serve.py --env-trace edge-day``."""
    return Environment(
        seed=seed, horizon_s=horizon_s, dt_s=dt_s,
        link=MarkovLink(rates_bps=_WIFI_RATES, transition=_WIFI_TRANSITION),
        f_cap=ThermalThrottle(tau_s=horizon_s / 4.0),
        battery=Battery(capacity_j=40.0 * horizon_s, drain_w=15.0,
                        soc0=0.5))


# ----------------------------------------------------------------------
# chaos presets (DESIGN.md §15) — seeded fault schedules for the
# supervisor, one per headline failure mode plus the kitchen sink
# ----------------------------------------------------------------------
def chaos_outage(*, seed: int = 0, horizon_s: float = 60.0,
                 dt_s: float = 0.5) -> ChaosTrace:
    """Flaky uplink: sticky Markov outages, ~14% of steps dark.

    The headline goodput scenario of ``benchmarks/chaos.py``: a bare
    engine loses every request in flight during a dark window, the
    supervisor backs off and retries through it."""
    return ChaosTrace(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                      link_outage=LinkOutage(p_fail=0.05, p_recover=0.30))


def chaos_corruption(*, seed: int = 0, horizon_s: float = 60.0,
                     dt_s: float = 0.5) -> ChaosTrace:
    """Noisy uplink: payload bit-flips on ~5% of transmissions — the
    checksum detect-and-retransmit scenario."""
    return ChaosTrace(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                      corruption=PacketCorruption(rate=0.05))


def chaos_preemption(*, seed: int = 0, horizon_s: float = 60.0,
                     dt_s: float = 0.5) -> ChaosTrace:
    """Preemptible edge server: crash/restart windows (MTBF 20 s,
    MTTR 4 s) — the decode snapshot/restore recovery scenario."""
    return ChaosTrace(seed=seed, horizon_s=horizon_s, dt_s=dt_s,
                      preemption=ServerPreemption(mtbf_s=20.0, mttr_s=4.0))


def chaos_storm(*, seed: int = 0, horizon_s: float = 90.0,
                dt_s: float = 0.5, n_agents: int = 1) -> ChaosTrace:
    """Everything at once: outages + corruption + preemption (+ fleet
    dropout when ``n_agents > 1``) — the zero-lost/zero-duplicated
    token stress test."""
    return ChaosTrace(
        seed=seed, horizon_s=horizon_s, dt_s=dt_s, n_agents=n_agents,
        link_outage=LinkOutage(p_fail=0.04, p_recover=0.35),
        corruption=PacketCorruption(rate=0.03),
        preemption=ServerPreemption(mtbf_s=30.0, mttr_s=5.0),
        dropout=AgentDropout(p_drop=0.02, p_rejoin=0.25)
        if n_agents > 1 else None)


def chaos_clean(*, seed: int = 0, horizon_s: float = 60.0,
                dt_s: float = 0.5) -> ChaosTrace:
    """The identity fault schedule: nothing ever fails, so the
    supervisor passes every step straight through and is bitwise
    identical to the bare engine (the §15 identity contract)."""
    return ChaosTrace(seed=seed, horizon_s=horizon_s, dt_s=dt_s)


def constant(*, horizon_s: float = 60.0, dt_s: float = 0.5,
             seed: int = 0) -> Environment:
    """The identity environment: no process attached, every state equal —
    the adaptive engine on it is bitwise identical to the static one
    (the §9 identity contract; ``seed`` is accepted for interface
    symmetry but nothing in the trace is random)."""
    return Environment(seed=seed, horizon_s=horizon_s, dt_s=dt_s)
