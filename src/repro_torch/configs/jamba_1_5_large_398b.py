"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Super-block of 8 (7 Mamba + 1 attention), MoE every other layer.
Sub-quadratic (Mamba-dominant) -> runs long_500k with the 9 attention
caches sharded along the sequence axis.

A copy of the reference's ``configs/jamba_1_5_large_398b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_d_ff=24576, moe_every=2,
    attn_period=8, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    mamba_headdim=128,
    norm="rmsnorm", act="silu",
    fsdp=True,
    split_layer=16,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="jamba-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, n_experts=4,
        experts_per_token=2, moe_d_ff=128, mamba_headdim=32, fsdp=False,
        split_layer=4)
