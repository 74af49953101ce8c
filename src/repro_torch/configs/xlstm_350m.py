"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks.  [arXiv:2405.04517; unverified]

xLSTM[7:1]: one sLSTM block per 8 (slstm_period=8).  Fully recurrent ->
O(1) decode state -> runs long_500k.

A copy of the reference's ``configs/xlstm_350m.py``.
"""

import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_period=8,
    norm="layernorm", act="gelu",
    split_layer=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, name="xlstm-350m-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=4, vocab_size=512, slstm_period=4, split_layer=4)
