"""Time-indexed environment state for adaptive serving (DESIGN.md §9).

:class:`Environment` composes the processes of ``processes.py`` — an
uplink-rate process, an f_max-cap process (thermal model or profile
replay), a battery — into one per-step trace, precomputed at
construction from a single explicit seed (one spawned child stream per
process), so the same seed always yields the identical environment.

:class:`EnvState` is the snapshot at a virtual-clock instant:

* ``apply(base)``    — the ``SystemParams`` view the cost model and the
  (P1) solver consume: f_max capped by the thermal governor, link_bps
  replaced by the current uplink rate.
* ``energy_scale``   — the battery-derived derate of per-request energy
  budgets (E0 shrinks as charge runs below the reserve), applied by
  ``runtime/adaptive.py`` at planning time.
* ``quantize()``     — a coarsened state (log-scale link buckets, linear
  f/scale buckets) whose ``key()`` is the *quantized environment-state
  key* the extended ``CodesignCache`` memoizes on: nearby states share
  one solve, and the adaptive controller's drift detector compares these
  keys instead of raw floats, so measurement jitter cannot thrash the
  plan.

A copy of the reference's ``repro/env/environment.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np

from ..core.cost_model import SystemParams

__all__ = ["EnvState", "Environment"]


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Environment snapshot at virtual time ``t_s``."""

    t_s: float
    link_bps: float             # current uplink rate (0 = unmodeled)
    f_cap_hz: float             # thermal f_max cap (inf = uncapped)
    battery_soc: float          # 1.0 = full
    temp_c: float
    energy_scale: float         # battery-derived E0 derate in (0, 1]

    def apply(self, base: SystemParams) -> SystemParams:
        """The ``SystemParams`` view of this state: the paper's constants
        with the time-varying fields swapped in."""
        return dataclasses.replace(
            base,
            f_max=min(base.f_max, self.f_cap_hz),
            link_bps=self.link_bps if self.link_bps > 0.0 else base.link_bps)

    def quantize(self, *, link_steps_per_octave: float = 2.0,
                 f_step_hz: float = 1.0e8,
                 scale_step: float = 0.05) -> "EnvState":
        """Coarsen to the resolution the plan actually responds to.

        Link rate is quantized on a log2 grid (``link_steps_per_octave``
        buckets per octave — rate changes matter multiplicatively), the
        frequency cap on a linear ``f_step_hz`` grid, and the battery
        energy scale on a ``scale_step`` grid.  Timestamp and raw
        SoC/temperature are dropped (they do not enter the solve).
        """
        if self.link_bps > 0.0:
            q = round(math.log2(self.link_bps) * link_steps_per_octave)
            link = 2.0 ** (q / link_steps_per_octave)
        else:
            link = 0.0
        # floor at one bucket: a positive cap must never quantize to 0 Hz
        f_cap = self.f_cap_hz if math.isinf(self.f_cap_hz) \
            else max(round(self.f_cap_hz / f_step_hz) * f_step_hz,
                     f_step_hz)
        scale = max(scale_step,
                    round(self.energy_scale / scale_step) * scale_step)
        return EnvState(t_s=0.0, link_bps=link, f_cap_hz=f_cap,
                        battery_soc=0.0, temp_c=0.0,
                        energy_scale=min(scale, 1.0))

    def key(self) -> tuple:
        """Hashable identity of the decision-relevant fields — what the
        ``CodesignCache`` env keyspace and the drift detector compare."""
        return (round(self.link_bps, 6), round(self.f_cap_hz, 3),
                round(self.energy_scale, 6))


class Environment:
    """Deterministic composition of environment processes.

    All traces are realized at construction over ``horizon_s`` in steps
    of ``dt_s`` from child streams of ``seed``; :meth:`state_at` indexes
    them with clamp-at-the-ends semantics, so any virtual-clock time maps
    to a well-defined state.

    ``link`` / ``f_cap`` / ``battery`` are processes from
    ``processes.py`` (anything with ``realize(rng, n, dt)``); each is
    optional — an :class:`Environment` with none of them is the identity
    (``apply`` returns the base ``SystemParams`` unchanged, energy scale
    1.0), which the adaptive engine serves bitwise identically to the
    static one.

    Battery → energy budget: above ``battery_reserve_soc`` the scale is
    1.0; below it the scale falls linearly with SoC down to
    ``battery_min_scale`` at empty — the OS-governor analogue of "stretch
    the remaining charge by spending less per request".
    """

    def __init__(self, *, dt_s: float = 0.5, horizon_s: float = 60.0,
                 seed: int = 0,
                 link=None, f_cap=None, battery=None,
                 battery_reserve_soc: float = 0.25,
                 battery_min_scale: float = 0.25):
        if dt_s <= 0 or horizon_s <= 0:
            raise ValueError("dt_s and horizon_s must be positive")
        self.dt_s = float(dt_s)
        self.n_steps = max(1, int(math.ceil(horizon_s / dt_s)))
        self.horizon_s = self.n_steps * self.dt_s
        self.seed = int(seed)
        self.battery_reserve_soc = float(battery_reserve_soc)
        self.battery_min_scale = float(battery_min_scale)
        r_link, r_fcap, r_batt = (np.random.default_rng(s) for s in
                                  np.random.SeedSequence(seed).spawn(3))
        n, dt = self.n_steps, self.dt_s
        self.link_trace = link.realize(r_link, n, dt) if link is not None \
            else np.zeros(n)
        if f_cap is not None:
            self.f_cap_trace = np.asarray(f_cap.realize(r_fcap, n, dt),
                                          np.float64)
            self.temp_trace = f_cap.temperature(n, dt) \
                if hasattr(f_cap, "temperature") else np.zeros(n)
        else:
            self.f_cap_trace = np.full(n, math.inf)
            self.temp_trace = np.zeros(n)
        self.soc_trace = battery.realize(r_batt, n, dt) \
            if battery is not None else np.ones(n)

    # ------------------------------------------------------------------
    def _energy_scale(self, soc: float) -> float:
        if soc >= self.battery_reserve_soc:
            return 1.0
        frac = soc / max(self.battery_reserve_soc, 1e-12)
        return self.battery_min_scale \
            + frac * (1.0 - self.battery_min_scale)

    def index_at(self, t_s: float) -> int:
        return min(max(int(t_s / self.dt_s), 0), self.n_steps - 1)

    def state_at(self, t_s: float) -> EnvState:
        k = self.index_at(t_s)
        soc = float(self.soc_trace[k])
        return EnvState(t_s=float(t_s),
                        link_bps=float(self.link_trace[k]),
                        f_cap_hz=float(self.f_cap_trace[k]),
                        battery_soc=soc,
                        temp_c=float(self.temp_trace[k]),
                        energy_scale=self._energy_scale(soc))

    def states(self) -> Iterator[EnvState]:
        for k in range(self.n_steps):
            yield self.state_at(k * self.dt_s)

    def is_constant(self) -> bool:
        """True when every step carries the same decision-relevant state
        (the bitwise-identity precondition of the adaptive engine)."""
        keys = {s.key() for s in self.states()}
        return len(keys) <= 1
