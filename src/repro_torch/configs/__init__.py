"""Architecture registry of the port.

``get_config(arch_id)`` returns the published full config and
``get_smoke(arch_id)`` its reduced CPU-test config, as in the reference.
Only the architectures the port can run are listed; any other id raises.
``fcdnn-16`` has no ``ModelConfig`` (both return None): it is the
paper's FC benchmark model of ``models/fcdnn.py``.
"""

from __future__ import annotations

from . import blip2_proxy, fcdnn16, git_proxy, qwen2_0_5b, stablelm_3b
from .base import ModelConfig  # noqa: F401

#: the paper's own evaluation models (§VI)
PAPER_IDS = ("fcdnn-16", "blip2-proxy", "git-proxy")

_PORTED = {"qwen2-0.5b": qwen2_0_5b, "stablelm-3b": stablelm_3b,
           "fcdnn-16": fcdnn16,
           "blip2-proxy": blip2_proxy, "git-proxy": git_proxy}


def _mod(arch_id: str):
    if arch_id not in _PORTED:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(_PORTED)}")
    return _PORTED[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()
