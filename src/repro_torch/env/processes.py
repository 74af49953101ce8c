"""Composable dynamic-environment processes (DESIGN.md §9).

Each process realizes one per-step scalar trace over a fixed horizon —
uplink rate, device frequency cap, or battery state of charge — via

    realize(rng, n_steps, dt_s) -> np.ndarray [n_steps] float64

``rng`` is a ``numpy.random.Generator`` the caller seeds explicitly
(``environment.Environment`` spawns one child stream per process from a
single seed), so the same seed always yields the identical trace: the
whole subsystem is a deterministic function of (seed, horizon, dt).
Processes that are deterministic by construction (trace replay, battery
drain, the thermal RC model) simply ignore ``rng``.

The processes:

* :class:`MarkovLink`       — discrete-state Wi-Fi link (good/fair/bad …)
                              with a row-stochastic transition matrix,
                              one transition per step.
* :class:`RayleighLink`     — Rayleigh block fading: per coherence block
                              the power gain g ~ Exp(1), and the uplink
                              rate follows Shannon, B·log2(1 + SNR·g)/8
                              bytes/s.
* :class:`TraceReplay`      — step-function replay of an explicit value
                              schedule (e.g. the Table I low/medium/high
                              frequency profiles of
                              ``benchmarks/testbed_profiles.py``).
* :class:`Battery`          — state-of-charge drain under a baseline
                              platform power draw, clipped at empty.
* :class:`ThermalThrottle`  — first-order RC die-temperature model whose
                              temperature maps to an f_max cap (linear
                              derate between t_throttle and t_max).

A copy of the reference's ``repro/env/processes.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = ["MarkovLink", "RayleighLink", "TraceReplay", "Battery",
           "ThermalThrottle"]


@dataclasses.dataclass(frozen=True)
class MarkovLink:
    """Markov-chain Wi-Fi uplink: one named rate per state, one
    transition draw per step.

    ``rates_bps`` are uplink rates in *bytes*/s (the unit of
    ``SystemParams.link_bps``); ``transition[i][j]`` is the per-step
    probability of moving from state i to state j.
    """

    rates_bps: Sequence[float]
    transition: Sequence[Sequence[float]]
    init_state: int = 0

    def __post_init__(self):
        p = np.asarray(self.transition, np.float64)
        n = len(self.rates_bps)
        if p.shape != (n, n):
            raise ValueError(f"transition must be {n}x{n}, got {p.shape}")
        if not np.allclose(p.sum(axis=1), 1.0, atol=1e-9):
            raise ValueError("transition rows must sum to 1")
        if (p < 0).any():
            raise ValueError("transition probabilities must be >= 0")
        if not 0 <= self.init_state < n:
            raise ValueError(f"init_state {self.init_state} out of range")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        """Per-step uplink rates (bytes/s): start in ``init_state``,
        draw one Markov transition per step from ``rng``.  ``dt_s`` is
        unused — the chain is specified per step, so dwell times scale
        with the environment's resolution by construction."""
        rates = np.asarray(self.rates_bps, np.float64)
        p = np.asarray(self.transition, np.float64)
        out = np.empty(n_steps, np.float64)
        s = self.init_state
        for k in range(n_steps):
            out[k] = rates[s]
            s = int(rng.choice(len(rates), p=p[s]))
        return out


@dataclasses.dataclass(frozen=True)
class RayleighLink:
    """Rayleigh block-fading uplink rate trace.

    Per coherence block the channel power gain is g ~ Exponential(1)
    (Rayleigh amplitude), and the achievable rate is Shannon's
    ``bandwidth_hz * log2(1 + mean_snr * g) / 8`` bytes/s, floored at
    ``rate_floor_bps`` (a deeply faded link still carries the control
    channel rather than dropping to exactly zero).
    """

    bandwidth_hz: float
    mean_snr: float            # linear (not dB)
    coherence_s: float         # fading block length
    rate_floor_bps: float = 1e3

    def __post_init__(self):
        if self.bandwidth_hz <= 0 or self.mean_snr <= 0 \
                or self.coherence_s <= 0:
            raise ValueError("bandwidth_hz, mean_snr and coherence_s must "
                             "be positive")

    def realize(self, rng: np.random.Generator, n_steps: int,
                dt_s: float) -> np.ndarray:
        """Per-step Shannon rates (bytes/s): one i.i.d. Exp(1) power
        gain per coherence block, each step indexing into the block
        covering its timestamp (so the trace is piecewise constant on
        ``coherence_s`` and independent of ``dt_s`` resolution)."""
        n_blocks = max(1, int(math.ceil(n_steps * dt_s / self.coherence_s)))
        gains = rng.exponential(1.0, size=n_blocks)
        rates = self.bandwidth_hz * np.log2(1.0 + self.mean_snr * gains) / 8.0
        rates = np.maximum(rates, self.rate_floor_bps)
        idx = np.minimum((np.arange(n_steps) * dt_s
                          / self.coherence_s).astype(np.int64), n_blocks - 1)
        return rates[idx]


@dataclasses.dataclass(frozen=True)
class TraceReplay:
    """Deterministic step-function replay of an explicit schedule.

    ``values[i]`` holds for ``dwell_s`` seconds; the last value holds
    forever (clamped, so any horizon is covered).  This is how measured
    testbed profiles — e.g. the Table I low/medium/high frequency map of
    ``benchmarks/testbed_profiles.py`` — replay as an f_max-cap process.
    """

    values: Sequence[float]
    dwell_s: float

    def __post_init__(self):
        if not len(self.values):
            raise ValueError("need at least one value to replay")
        if self.dwell_s <= 0:
            raise ValueError("dwell_s must be positive")

    def realize(self, rng: Optional[np.random.Generator], n_steps: int,
                dt_s: float) -> np.ndarray:
        """Per-step values: step k reads ``values[k·dt/dwell]``, clamped
        to the last entry; ``rng`` is accepted but unused (the replay is
        deterministic by construction)."""
        vals = np.asarray(self.values, np.float64)
        idx = np.minimum((np.arange(n_steps) * dt_s
                          / self.dwell_s).astype(np.int64), len(vals) - 1)
        return vals[idx]


@dataclasses.dataclass(frozen=True)
class Battery:
    """State-of-charge drain under a baseline platform draw.

    soc(t) = clip(soc0 − drain_w·t / capacity_j, 0, 1) — deterministic,
    so the oracle/static/adaptive policies of the benchmark see the same
    battery no matter what they serve.  The serving-side consequence
    (tightening per-request energy budgets as charge runs down) is the
    environment's ``energy_scale`` (environment.py), not the process's.
    """

    capacity_j: float
    drain_w: float
    soc0: float = 1.0

    def __post_init__(self):
        if self.capacity_j <= 0:
            raise ValueError("capacity_j must be positive")
        if self.drain_w < 0:
            raise ValueError("drain_w must be >= 0")
        if not 0.0 < self.soc0 <= 1.0:
            raise ValueError("soc0 must be in (0, 1]")

    def realize(self, rng: Optional[np.random.Generator], n_steps: int,
                dt_s: float) -> np.ndarray:
        """Per-step state of charge in [0, 1]: linear drain from
        ``soc0`` at ``drain_w`` watts against ``capacity_j``, clipped at
        empty; ``rng`` is accepted but unused (deterministic)."""
        t = np.arange(n_steps) * dt_s
        return np.clip(self.soc0 - self.drain_w * t / self.capacity_j,
                       0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class ThermalThrottle:
    """First-order RC thermal model driving an f_max cap.

    Die temperature relaxes toward ``ambient + duty·(peak − ambient)``
    with time constant ``tau_s`` (duty is a constant load fraction or a
    per-step schedule).  The cap is ``f_full_hz`` below ``t_throttle_c``,
    ``f_floor_hz`` above ``t_max_c``, and linearly derated between —
    the Jetson-style governor of the paper's testbed.
    """

    f_full_hz: float = 2.0e9
    f_floor_hz: float = 0.6e9
    t_ambient_c: float = 25.0
    t_peak_c: float = 95.0
    t_throttle_c: float = 70.0
    t_max_c: float = 90.0
    tau_s: float = 30.0
    duty: object = 1.0          # scalar in [0,1] or per-step sequence

    def __post_init__(self):
        if self.f_floor_hz > self.f_full_hz:
            raise ValueError("f_floor_hz must be <= f_full_hz")
        if self.t_max_c <= self.t_throttle_c:
            raise ValueError("t_max_c must be > t_throttle_c")
        if self.tau_s <= 0:
            raise ValueError("tau_s must be positive")

    def _duty_trace(self, n_steps: int) -> np.ndarray:
        """Per-step load fraction in [0, 1]: a scalar ``duty`` is
        broadcast, a sequence is clamp-extended with its last value
        (the same convention as :class:`TraceReplay`)."""
        if np.isscalar(self.duty):
            d = np.full(n_steps, float(self.duty))
        else:
            d = np.asarray(self.duty, np.float64)
            if d.shape[0] < n_steps:   # clamp-extend like TraceReplay
                d = np.concatenate([d, np.full(n_steps - d.shape[0], d[-1])])
            d = d[:n_steps]
        return np.clip(d, 0.0, 1.0)

    def temperature(self, n_steps: int, dt_s: float) -> np.ndarray:
        """Die-temperature trace (°C): first-order relaxation toward
        the duty-scaled target with step factor 1 − exp(−dt/τ), started
        from ambient.  Exposed separately so ``Environment`` can record
        the temperature alongside the frequency cap it induces."""
        duty = self._duty_trace(n_steps)
        temp = np.empty(n_steps, np.float64)
        t = self.t_ambient_c
        alpha = 1.0 - math.exp(-dt_s / self.tau_s)
        for k in range(n_steps):
            target = self.t_ambient_c + duty[k] \
                * (self.t_peak_c - self.t_ambient_c)
            t = t + alpha * (target - t)
            temp[k] = t
        return temp

    def cap_for(self, temp_c: np.ndarray) -> np.ndarray:
        """The governor map: f_full below ``t_throttle_c``, f_floor
        above ``t_max_c``, linear derate in between."""
        frac = np.clip((np.asarray(temp_c, np.float64) - self.t_throttle_c)
                       / (self.t_max_c - self.t_throttle_c), 0.0, 1.0)
        return self.f_full_hz - frac * (self.f_full_hz - self.f_floor_hz)

    def realize(self, rng: Optional[np.random.Generator], n_steps: int,
                dt_s: float) -> np.ndarray:
        """Per-step f_max caps (Hz): the governor map applied to the RC
        temperature trace; ``rng`` is accepted but unused."""
        return self.cap_for(self.temperature(n_steps, dt_s))
