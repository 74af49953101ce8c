"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671; hf]

Qwen2: RMSNorm, SwiGLU, RoPE theta=1e6, QKV bias, tied embeddings (0.5B).
A copy of the reference's ``configs/qwen2_0_5b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, tie_embeddings=True,
    norm="rmsnorm", act="silu", rope_theta=1.0e6,
    split_layer=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="qwen2-0.5b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=512, split_layer=1)
