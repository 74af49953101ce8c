"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only (Mistral-7B); the anyres vision frontend is a STUB:
input_specs supplies precomputed patch embeddings for vis_frac of the
sequence (anyres: up to 5 tiles x 576 patch tokens; at train_4k that is
~70%% of the 4096 budget -> vis_frac=0.7).

A copy of the reference's ``configs/llava_next_mistral_7b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    norm="rmsnorm", act="silu", rope_theta=1.0e6,
    frontend="vision", vis_frac=0.7,
    fsdp=True, remat_block=8,
    split_layer=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="llava-next-mistral-7b-smoke", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512, fsdp=False,
        remat_block=2, split_layer=1)
