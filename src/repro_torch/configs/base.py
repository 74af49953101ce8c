"""Model configuration schema (a copy of the reference's ``ModelConfig``).

Field for field the same dataclass as ``repro/configs/base.py``, so a
config built on either side describes the same model and
``dataclasses.replace`` takes the same keywords.  The dry-run shape grid
of the reference is not part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # expert hidden size (0 -> d_ff)
    moe_every: int = 1                # MoE replaces MLP every k-th layer
    capacity_factor: float = 1.25

    # --- hybrid (Jamba-style) ---
    attn_period: int = 0              # 1 attention layer per `attn_period`
    mamba_d_state: int = 64
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_headdim: int = 64           # SSD head dim

    # --- xLSTM ---
    slstm_period: int = 0             # 1 sLSTM per `slstm_period` blocks

    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    sliding_window: int = 0           # 0 = full attention

    # --- encoder-decoder ---
    n_enc_layers: int = 0             # >0 -> enc-dec; n_layers is decoder depth

    # --- misc arch ---
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    tie_embeddings: bool = False
    frontend: Literal["none", "vision", "audio"] = "none"
    vis_frac: float = 0.5             # fraction of seq given to stub embeds

    # --- numerics ---
    param_dtype: str = "float32"
    dtype: str = "float32"

    # --- distribution ---
    fsdp: bool = False                # shard weight 'embed' axis over data
    remat_block: int = 0              # outer-scan block size (0 = single scan)
    scan_layers: bool = True

    # --- co-inference (the paper's feature) ---
    split_layer: int = -1             # agent/server boundary; -1 -> L // 4

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.split_layer < 0:
            object.__setattr__(self, "split_layer", max(1, self.n_layers // 4))
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ----- derived sizes -----
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, idx: int) -> bool:
        if not self.n_experts:
            return False
        return (idx % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, idx: int) -> bool:
        """Hybrid models: one attention layer per `attn_period`."""
        if self.attn_period <= 0:
            return True
        return (idx % self.attn_period) == (self.attn_period - 1)

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        per_mlp = 3 * d * f if self.act == "silu" else 2 * d * f
        per_moe = (3 * d * self.moe_d_ff) * self.n_experts + d * self.n_experts
        per_mamba = self._mamba_params()
        total = emb
        for i in range(self.n_layers):
            if self.family == "hybrid" and not self.is_attn_layer(i):
                total += per_mamba
            elif self.family == "ssm":
                total += self._xlstm_params()
                continue
            else:
                total += per_attn
            if self.is_moe_layer(i):
                total += per_moe
            elif f > 0:
                total += per_mlp
        for _ in range(self.n_enc_layers):
            total += per_attn + per_mlp
            total += per_attn  # decoder cross-attention (counted here)
        return float(total)

    def _mamba_params(self) -> int:
        d_in = self.d_model * self.mamba_expand
        n = self.mamba_d_state
        nh = d_in // self.mamba_headdim
        return (self.d_model * (2 * d_in + 2 * n + nh)  # in_proj(x,z)+B,C,dt
                + d_in * self.mamba_d_conv              # depthwise conv
                + d_in * self.d_model)                  # out_proj

    def _xlstm_params(self) -> int:
        d = self.d_model
        dq = self.q_dim
        # mLSTM block: q,k,v projections + gates + out + ffn-ish up/down
        return d * dq * 3 + d * self.n_heads * 3 + dq * d + 2 * d * 4 * d

    def active_param_count(self) -> float:
        """MoE: parameters touched per token (for MODEL_FLOPS = 6 N_active D)."""
        if not self.n_experts:
            return self.param_count()
        dense_like = dataclasses.replace(
            self, n_experts=0, experts_per_token=0)
        dense = dense_like.param_count()
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        active_moe = n_moe_layers * (
            3 * self.d_model * self.moe_d_ff * self.experts_per_token
            + self.d_model * self.n_experts)
        n_mlp_replaced = n_moe_layers * 3 * self.d_model * self.d_ff
        return float(dense - n_mlp_replaced + active_moe)
