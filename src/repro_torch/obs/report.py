"""Shared report serialization: one ``to_dict()``/``to_json()`` for all
engine reports.

Every engine ships a report dataclass (``EngineReport``,
``AdaptiveReport``, ``DecodeReport``, ``FleetReport``,
``SupervisorReport``).  Before DESIGN.md §14 each benchmark rebuilt
those fields into ad-hoc dicts by hand; now the classes mix in
:class:`ReportBase` and every consumer — benchmarks, ``--metrics-out``,
history rows — serializes through the same recursive converter, so
field names in JSON match field names in code by construction.
"""

from __future__ import annotations

import dataclasses
import json


def to_jsonable(obj):
    """Recursively convert dataclasses / numpy scalars / containers into
    plain JSON-serializable Python values.  Tuples become lists; numpy
    scalars and 0-d arrays collapse via ``item()``; mapping keys are
    coerced to ``str``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, (str, bool, int, float)) or obj is None:
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return to_jsonable(item())
        except (TypeError, ValueError):
            pass
    return str(obj)


class ReportBase:
    """Mixin giving report dataclasses a uniform serialization surface."""

    def to_dict(self) -> dict:
        return to_jsonable(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)
