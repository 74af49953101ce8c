"""GIT-base proxy (paper §VI): visual encoder + text decoder (176.62M
params, 212.27 GFLOPs to first token), as a reduced-scale stand-in with
the same decoupled structure.  A copy of the reference's
``configs/git_proxy.py``."""

import dataclasses

from .base import ModelConfig

N_FLOP_FIRST_TOKEN = 212.27e9   # paper §VI-A
N_PARAMS = 176.62e6

FULL = ModelConfig(
    name="git-proxy", family="vlm",
    n_layers=6, d_model=192, n_heads=6, n_kv_heads=6,
    d_ff=768, vocab_size=2048,
    norm="layernorm", act="gelu",
    frontend="vision", vis_frac=0.5,
    split_layer=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(FULL, n_layers=3, d_model=48, n_heads=4,
                               n_kv_heads=4, head_dim=12, d_ff=96,
                               vocab_size=512, split_layer=1)
