"""BLIP-2 proxy (paper §VI): a decoupled vision-encoder + LLM architecture
at a reduced scale (frozen frontend -> Q-Former-like boundary -> LM),
for the distortion and codesign experiments.  The paper's FLOP figure
(533.66 GFLOPs to first token, 3.75B params) parameterizes the cost
model.  A copy of the reference's ``configs/blip2_proxy.py``.
"""

import dataclasses

from .base import ModelConfig

N_FLOP_FIRST_TOKEN = 533.66e9   # paper §VI-A
N_PARAMS = 3.75e9

FULL = ModelConfig(
    name="blip2-proxy", family="vlm",
    n_layers=8, d_model=256, n_heads=8, n_kv_heads=8,
    d_ff=1024, vocab_size=2048,
    norm="layernorm", act="gelu",
    frontend="vision", vis_frac=0.5,
    split_layer=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(FULL, n_layers=4, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=160,
                               vocab_size=512, split_layer=1)
