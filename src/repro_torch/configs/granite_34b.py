"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]

MQA (kv=1): the KV head cannot TP-shard, so decode caches shard on batch
(default rules fall back via divisibility).  34B params -> fsdp weights,
two-level remat scan (8 x 11 layers).

A copy of the reference's ``configs/granite_34b.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    norm="rmsnorm", act="gelu", rope_theta=1.0e4,  # gpt_bigcode: non-gated MLP
    fsdp=True, remat_block=11,
    split_layer=22,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="granite-34b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=192, vocab_size=512, fsdp=False, remat_block=2,
        split_layer=1)
