"""**Training-side** fault tolerance: checkpoint/restart, straggler
detection (``repro/runtime/fault_tolerance.py``).

Everything in this module supervises the *training loop*: it restarts
sessions, not requests.  The serving-side counterpart (retry, degraded
device-only fallback, crash-recoverable decode) is
:class:`~repro_torch.runtime.supervisor.ServingSupervisor`; the two share
:class:`~repro_torch.obs.ReportBase` for their reports and this module's
:class:`StragglerMonitor` for slow-step/slow-batch detection.

The *cluster* is simulated (a :class:`HostSet` of logical hosts with an
injectable failure schedule), but the recovery is real: the checkpoints
round-trip through disk (``checkpoint/store.py``), a corrupt newest step
falls back to the previous one, the session is rebuilt over a mesh of the
surviving ranks (:func:`survivor_mesh`: host h runs on rank h mod the
world size), and the restored state is re-sharded onto that mesh, each
rank keeping its part, before the session resumes from the newest intact
step.  Every rank runs the supervisor with the same failure schedule, so
all of them rebuild together; a rank whose hosts are all lost is outside
the new mesh and only follows the schedule.  ``remesh_history`` records
the logical host count after each (re)build, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch.distributed as dist

from ..launch.mesh import make_mesh
from ..obs import ReportBase


class HostFailure(RuntimeError):
    def __init__(self, host_id: int):
        super().__init__(f"host {host_id} failed")
        self.host_id = host_id


@dataclasses.dataclass
class HostSet:
    """Simulated cluster membership with failure injection."""

    n_hosts: int
    fail_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    # step -> host_id to kill at that step

    def __post_init__(self):
        self.alive = list(range(self.n_hosts))

    def check(self, step: int) -> None:
        if step in self.fail_at:
            host = self.fail_at.pop(step)
            if host in self.alive:
                self.alive.remove(host)
                raise HostFailure(host)

    @property
    def n_alive(self) -> int:
        return len(self.alive)


def survivor_mesh(hosts: HostSet, device=None):
    """A (data, model) = (ranks, 1) mesh over the ranks that run a
    surviving host (host h on rank h mod the world size).  Every rank of
    the group calls it; on a rank outside it ``get_coordinate()`` is
    None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = sorted({h % world for h in hosts.alive})
    return make_mesh((len(ranks), 1), ("data", "model"), ranks, device)


@dataclasses.dataclass
class StragglerMonitor:
    """Per-lane duration telemetry with a relative deadline.

    A lane is flagged when its reported duration exceeds ``factor`` x
    the rolling median across lanes.  Training feeds it per-host step
    times (lane = host id); serving reuses it unchanged for slow-batch
    detection (lane = QoS class or fleet agent name — any hashable id
    works).  Real pods feed this from per-host heartbeats; the tests
    feed synthetic durations.
    """

    factor: float = 3.0
    window: int = 20

    def __post_init__(self):
        self._times: Dict[Hashable, List[float]] = {}

    def report(self, lane: Hashable, duration_s: float) -> None:
        self._times.setdefault(lane, []).append(duration_s)
        self._times[lane] = self._times[lane][-self.window:]

    def stragglers(self) -> List[Hashable]:
        if not self._times:
            return []
        meds = {h: float(np.median(t)) for h, t in self._times.items()
                if t}
        global_med = float(np.median(list(meds.values())))
        if global_med <= 0:
            return []
        return [h for h, m in meds.items() if m > self.factor * global_med]


@dataclasses.dataclass
class SupervisorReport(ReportBase):
    steps_run: int
    restarts: int
    failures: List[int]
    stragglers_seen: List[int]
    final_step: int
    remesh_history: List[int]   # logical host count after each (re)build


class Supervisor:
    """Wraps a restartable **training** session (serving has its own
    :class:`~repro_torch.runtime.supervisor.ServingSupervisor`).

    The user supplies ``make_session(n_hosts) -> session`` where a session
    exposes ``run_until(target, hosts) -> None`` (raising
    :class:`HostFailure`), ``step`` (current step), and persists through a
    shared ``CheckpointManager``.  On a ``HostFailure`` the supervisor
    rebuilds the session over the surviving hosts (the checkpoint restore
    happens inside ``make_session``) and resumes until the target step
    count is reached.
    """

    def __init__(self, make_session: Callable[[int], "object"],
                 hosts: HostSet,
                 monitor: Optional[StragglerMonitor] = None,
                 max_restarts: int = 8):
        self.make_session = make_session
        self.hosts = hosts
        self.monitor = monitor or StragglerMonitor()
        self.max_restarts = max_restarts

    def run(self, target_steps: int) -> SupervisorReport:
        restarts = 0
        failures: List[int] = []
        remesh: List[int] = []
        session = self.make_session(self.hosts.n_alive)
        remesh.append(self.hosts.n_alive)
        while session.step < target_steps:
            try:
                session.run_until(target_steps, self.hosts)
            except HostFailure as e:
                failures.append(e.host_id)
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                if self.hosts.n_alive == 0:
                    raise RuntimeError("no hosts left") from e
                # elastic re-mesh over the survivors + restore
                session = self.make_session(self.hosts.n_alive)
                remesh.append(self.hosts.n_alive)
        return SupervisorReport(
            steps_run=session.step, restarts=restarts, failures=failures,
            stragglers_seen=self.monitor.stragglers(),
            final_step=session.step, remesh_history=remesh)
