"""Model factory (``repro/models/registry.py``): ModelConfig -> model."""

from __future__ import annotations

from .encdec import EncDecModel
from .hybrid import HybridLM
from .lm import DecoderLM
from .xlstm_model import XLSTMModel


def build_model(cfg):
    """The reference's dispatch, in its order: an encoder-decoder when the
    config has encoder layers, the hybrid for ``family == "hybrid"`` or an
    attention period, the xLSTM for ``family == "ssm"``, else the
    decoder-only LM."""
    if cfg.n_enc_layers > 0:
        return EncDecModel(cfg)
    if cfg.family == "hybrid" or cfg.attn_period > 1:
        return HybridLM(cfg)
    if cfg.family == "ssm":
        return XLSTMModel(cfg)
    return DecoderLM(cfg)
