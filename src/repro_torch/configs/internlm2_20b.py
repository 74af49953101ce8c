"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA.  [arXiv:2403.17297; hf]

A copy of the reference's ``configs/internlm2_20b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    norm="rmsnorm", act="silu", rope_theta=1.0e6,
    fsdp=True, remat_block=8,
    split_layer=12,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="internlm2-20b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=512, fsdp=False, remat_block=2,
        split_layer=1)
