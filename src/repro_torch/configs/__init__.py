"""Architecture registry of the port.

``get_config(arch_id)`` returns the published full config and
``get_smoke(arch_id)`` its reduced CPU-test config, as in the reference,
for all of the reference's architectures; any other id raises.
``fcdnn-16`` has no ``ModelConfig`` (both return None): it is the
paper's FC benchmark model of ``models/fcdnn.py``.
"""

from __future__ import annotations

from . import (blip2_proxy, fcdnn16, git_proxy, granite_34b, internlm2_20b,
               jamba_1_5_large_398b, kimi_k2_1t_a32b, llava_next_mistral_7b,
               qwen2_0_5b, qwen3_moe_235b_a22b, seamless_m4t_large_v2,
               stablelm_3b, xlstm_350m)
from .base import ModelConfig  # noqa: F401

#: the paper's own evaluation models (§VI)
PAPER_IDS = ("fcdnn-16", "blip2-proxy", "git-proxy")

_PORTED = {"qwen2-0.5b": qwen2_0_5b, "stablelm-3b": stablelm_3b,
           "granite-34b": granite_34b, "internlm2-20b": internlm2_20b,
           "llava-next-mistral-7b": llava_next_mistral_7b,
           "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
           "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
           "xlstm-350m": xlstm_350m,
           "jamba-1.5-large-398b": jamba_1_5_large_398b,
           "seamless-m4t-large-v2": seamless_m4t_large_v2,
           "fcdnn-16": fcdnn16,
           "blip2-proxy": blip2_proxy, "git-proxy": git_proxy}


def _mod(arch_id: str):
    if arch_id not in _PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_PORTED)}")
    return _PORTED[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()
