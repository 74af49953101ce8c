"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b; unverified]

StableLM-2 family: LayerNorm, SiLU-gated MLP, RoPE (head_dim 80).
A copy of the reference's ``configs/stablelm_3b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    norm="layernorm", act="silu", rope_theta=1.0e4,
    split_layer=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="stablelm-3b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=512, split_layer=1)
