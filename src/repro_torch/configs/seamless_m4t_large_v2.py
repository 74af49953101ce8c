"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596; hf]

Encoder-decoder backbone (24 enc + 24 dec); the speech frontend is a STUB
(precomputed frame embeddings).  Shape cells split seq budget 50/50 between
encoder frames and decoder tokens (EXPERIMENTS.md).

A copy of the reference's ``configs/seamless_m4t_large_v2.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    n_enc_layers=24,
    norm="layernorm", act="gelu",
    frontend="audio",
    split_layer=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="seamless-m4t-large-v2-smoke", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=512, n_enc_layers=2,
        split_layer=1)
