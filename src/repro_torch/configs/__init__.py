"""Architecture registry of the port.

``get_config(arch_id)`` returns the published full config and
``get_smoke(arch_id)`` its reduced CPU-test config, as in the reference.
Only the architectures the port can serve are listed; any other id raises.
"""

from __future__ import annotations

from . import qwen2_0_5b
from .base import ModelConfig  # noqa: F401

_PORTED = {"qwen2-0.5b": qwen2_0_5b}


def _mod(arch_id: str):
    if arch_id not in _PORTED:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(_PORTED)}")
    return _PORTED[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()
