"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

Expert weights dominate (~1T total, ~32B active): EP over the model axis
(384/16 = 24 experts per slice) x FSDP on the expert 'embed' axis ->
512-way parameter sharding on the multi-pod mesh.

A copy of the reference's ``configs/kimi_k2_1t_a32b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8, moe_d_ff=2048, moe_every=1,
    norm="rmsnorm", act="silu", rope_theta=5.0e4,
    fsdp=True,
    split_layer=15,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="kimi-k2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=8,
        experts_per_token=2, moe_d_ff=96, fsdp=False, split_layer=1)
