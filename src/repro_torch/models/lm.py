"""Decoder-only language model, dense family (``repro/models/lm.py``).

The parameter dict has the reference's structure and layouts::

    {"embed": {"tok": [V, D]},
     "layers": {"attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]},
                "ffn": {"wi_gate", "wi_up", "wo"} | {"wi", "wo"},
                "ln1": {"scale"}, "ln2": {"scale"}},       # all [L, ...]
     "final_norm": {"scale": [D]}}

so ``bridge.params_from_jax`` carries the reference's pytree across leaf
for leaf.  The layer stack runs as a plain Python loop (the reference's
``lax.scan`` / ``while_loop``); MoE layers and the decode protocol wait for
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class DecoderLM:
    """Config-driven decoder-only LM (dense layers only in this port)."""

    def __init__(self, cfg):
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not yet ported to repro_torch")
        self.cfg = cfg
        self._axes = None

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _build(self, generator: Optional[torch.Generator], device=None):
        cfg = self.cfg
        dev = generator.device if generator is not None else device
        n = cfg.n_layers
        emb_p, emb_ax = L.init_embeddings(cfg, generator, device=dev)
        attn_p, attn_ax = L.init_attention(cfg, generator, layers=n,
                                           device=dev)
        ffn_p, ffn_ax = L.init_mlp(cfg, generator, layers=n, device=dev)
        norms = [L.init_norm(cfg, cfg.d_model, device=dev) for _ in range(3)]

        def stack(p, ax):
            return ({k: v[None].expand((n,) + v.shape).contiguous()
                     for k, v in p.items()},
                    {k: ("layers",) + t for k, t in ax.items()})

        (ln1_p, ln1_ax), (ln2_p, ln2_ax) = stack(*norms[0]), stack(*norms[1])
        lnf_p, lnf_ax = norms[2]
        params = {"embed": emb_p,
                  "layers": {"attn": attn_p, "ffn": ffn_p,
                             "ln1": ln1_p, "ln2": ln2_p},
                  "final_norm": lnf_p}
        self._axes = {"embed": emb_ax,
                      "layers": {"attn": attn_ax, "ffn": ffn_ax,
                                 "ln1": ln1_ax, "ln2": ln2_ax},
                      "final_norm": lnf_ax}
        return params

    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator``, on its device."""
        return self._build(generator)

    def logical_axes(self):
        if self._axes is None:
            self._build(None, device="meta")
        return self._axes

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _block(self, lp, x, positions):
        cfg = self.cfg
        h = L.apply_norm(cfg, x, lp["ln1"])
        q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
        attn = L.blockwise_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window)
        x = x + attn.reshape(x.shape[:2] + (cfg.q_dim,)) \
            @ lp["attn"]["wo"].to(x.dtype)
        h2 = L.apply_norm(cfg, x, lp["ln2"])
        return x + L.apply_mlp(cfg, lp["ffn"], h2)

    def run_layers_window(self, params, x, positions, lo: int, hi: int):
        """Layers [lo, hi) applied in order; returns (x, aux=0.0)."""
        lp = params["layers"]
        for i in range(int(lo), int(hi)):
            x = self._block(tree_map(lambda a: a[i], lp), x, positions)
        return x, 0.0

    def run_layers(self, params, x, positions, lo: int, hi: int):
        """Co-inference split execution: layers [lo, hi) on activations x."""
        return self.run_layers_window(params, x, positions, lo, hi)

    # ------------------------------------------------------------------
    # embedding
    # ------------------------------------------------------------------
    def _embed(self, params, batch: Dict[str, Any]):
        """batch dict -> (x [B, S, D], positions [B, S])."""
        dtype = getattr(torch, self.cfg.dtype)
        parts = []
        if "embeds" in batch:
            parts.append(batch["embeds"].to(dtype))
        if "tokens" in batch:
            parts.append(L.embed_tokens(params["embed"], batch["tokens"],
                                        dtype))
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        return x, positions

    def embed(self, params, batch):
        """Public embedding hook (the reference's compiled path traces it)."""
        return self._embed(params, batch)

    def forward(self, params, batch):
        """Full forward: (logits [B, S, V], aux=0.0)."""
        x, positions = self._embed(params, batch)
        x, aux = self.run_layers(params, x, positions, 0, self.cfg.n_layers)
        x = L.apply_norm(self.cfg, x, params["final_norm"])
        return L.unembed(self.cfg, params["embed"], x), aux
