"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 — 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

A copy of the reference's ``configs/qwen3_moe_235b_a22b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8, moe_d_ff=1536, moe_every=1,
    norm="rmsnorm", act="silu", rope_theta=1.0e6,
    fsdp=True,
    split_layer=23,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="qwen3-moe-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512, n_experts=8,
        experts_per_token=2, moe_d_ff=96, fsdp=False, split_layer=1)
