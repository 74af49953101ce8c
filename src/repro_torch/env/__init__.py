"""Dynamic-environment simulation (DESIGN.md §9): composable link /
thermal / battery processes realized into deterministic, time-indexed
``SystemParams`` views for adaptive co-inference serving.

A copy of the reference's ``repro/env`` (numpy and the port's
``core.cost_model`` only), so the port imports nothing of the reference;
the fault processes of ``faults.py`` come along for ``presets.py``, and
their user, the serving supervisor, is not ported yet."""

from .environment import Environment, EnvState  # noqa: F401
from .faults import (AgentDropout, ChaosTrace, FaultState,  # noqa: F401
                     LinkOutage, PacketCorruption, ServerPreemption,
                     chaos_from_spec)
from .processes import (Battery, MarkovLink, RayleighLink,  # noqa: F401
                        ThermalThrottle, TraceReplay)
from . import presets  # noqa: F401
