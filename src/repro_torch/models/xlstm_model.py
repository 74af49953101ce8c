"""xLSTM language model (``repro/models/xlstm_model.py``, arXiv:2405.04517):
mLSTM and sLSTM blocks.

A super-block of ``slstm_period`` layers is (period - 1) mLSTM blocks and
then one sLSTM block (the paper's xLSTM[7:1] at period 8), each behind an
RMSNorm with a residual; the config's final norm follows the last block.
d_ff = 0: the gates and projections live inside the cells, there is no
separate FFN.  The parameter dict is the reference's::

    {"embed": {"tok", "unembed"},
     "blocks": {"mlstm": {...: [NB, period - 1, ...]},
                "slstm": {...: [NB, ...]}, "ln": [NB, period, D]},
     "final_norm": {...}}

The super-blocks run as a Python loop (the reference's ``lax.scan``),
each recomputed in the backward pass under ``loss(remat=True)`` as the
reference's ``jax.checkpoint``.  The decode state is O(1) per layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import ssm as S
from .lm import input_specs_of, refuse_quantized, tree_map, unstack_layers


def prepend_axis(ax, name: str = "blocks"):
    """``ax`` (nested dicts of axis-name tuples) with ``name`` in front of
    every tuple."""
    if isinstance(ax, dict):
        return {k: prepend_axis(v, name) for k, v in ax.items()}
    return (name,) + ax


class XLSTMModel:
    def __init__(self, cfg):
        per = cfg.slstm_period or 8
        if cfg.n_layers % per:
            raise ValueError("n_layers must divide by slstm_period")
        self.cfg = cfg
        self.per = per
        self.n_m = per - 1
        self.n_blocks = cfg.n_layers // per
        self._axes = None

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _build(self, generator: Optional[torch.Generator], device=None):
        cfg, nb = self.cfg, self.n_blocks
        dev = generator.device if generator is not None else device
        emb_p, emb_ax = L.init_embeddings(cfg, generator, device=dev)
        ml_p, _ = S.init_mlstm(cfg, generator, layers=(nb, self.n_m),
                               device=dev)
        sl_p, _ = S.init_slstm(cfg, generator, layers=nb, device=dev)
        # the axes are the reference's: one block's, with "blocks" in front
        ml_ax = S.init_mlstm(cfg, None, layers=self.n_m, device="meta")[1]
        sl_ax = S.init_slstm(cfg, None, device="meta")[1]
        ln = torch.ones((nb, self.per, cfg.d_model), device=dev)
        lnf_p, lnf_ax = L.init_norm(cfg, cfg.d_model, device=dev)
        params = {"embed": emb_p,
                  "blocks": {"mlstm": ml_p, "slstm": sl_p, "ln": ln},
                  "final_norm": lnf_p}
        self._axes = {"embed": emb_ax,
                      "blocks": {"mlstm": prepend_axis(ml_ax),
                                 "slstm": prepend_axis(sl_ax),
                                 "ln": ("blocks", "layers", "embed")},
                      "final_norm": lnf_ax}
        return params

    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator``, on its device."""
        return self._build(generator)

    def logical_axes(self):
        if self._axes is None:
            self._build(None, device="meta")
        return self._axes

    def param_structs(self):
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        memory (the reference's ``jax.eval_shape`` of ``init``)."""
        return self._build(None, device="meta")

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _super_block(self, bp, x):
        cfg = self.cfg
        mlstm = unstack_layers(bp["mlstm"], self.n_m)
        ln = bp["ln"].unbind(0)
        for slot in range(self.per):
            h = L.rmsnorm(x, ln[slot])
            if slot < self.n_m:
                x = x + S.mlstm_forward(cfg, mlstm[slot], h)
            else:
                x = x + S.slstm_forward(cfg, bp["slstm"], h)
        return x

    def _hidden(self, params, batch, remat: bool = False):
        cfg = self.cfg
        refuse_quantized(cfg, params)
        x = L.embed_tokens(params["embed"], batch["tokens"],
                           getattr(torch, cfg.dtype))
        for bp in unstack_layers(params["blocks"], self.n_blocks):
            if remat:
                x = checkpoint(self._super_block, bp, x, use_reentrant=False)
            else:
                x = self._super_block(bp, x)
        return L.apply_norm(cfg, x, params["final_norm"])

    def forward(self, params, batch):
        """(logits [B, S, V], aux = 0.0)."""
        x = self._hidden(params, batch)
        return L.unembed(self.cfg, params["embed"], x), 0.0

    def loss(self, params, batch, *, remat: bool = False):
        """Mean next-token CE of ``batch["labels"]`` (chunked unembedding);
        ``remat`` recomputes each super-block in the backward pass."""
        x = self._hidden(params, batch, remat)
        return L.chunked_cross_entropy(self.cfg, x, params["embed"],
                                       batch["labels"])

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        """The recurrent states, zero (stabilizers at -1e30): O(1) in
        ``max_len``."""
        del max_len
        cfg, nb, nm = self.cfg, self.n_blocks, self.n_m
        h, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def floor(*shape):
            return torch.full(shape, -1e30, dtype=torch.float32,
                              device=device)
        return {"mC": z(nb, nm, batch, h, dh, dh), "mn": z(nb, nm, batch, h,
                                                             dh),
                "mm": floor(nb, nm, batch, h),
                "sh": z(nb, batch, d), "sc": z(nb, batch, d),
                "sn": z(nb, batch, d), "sm": floor(nb, batch, d),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def cache_axes(self):
        return {"mC": ("blocks", "layers", "batch", "heads", "head_dim",
                       "head_dim2"),
                "mn": ("blocks", "layers", "batch", "heads", "head_dim"),
                "mm": ("blocks", "layers", "batch", "heads"),
                "sh": ("blocks", "batch", "embed"),
                "sc": ("blocks", "batch", "embed"),
                "sn": ("blocks", "batch", "embed"),
                "sm": ("blocks", "batch", "embed"),
                "len": ("batch",)}

    def input_specs(self, shape):
        """The batch of a dry-run cell as ``meta`` tensors."""
        return input_specs_of(shape)

    def cache_specs(self, shape):
        """The cache of a dry-run decode cell as ``meta`` tensors."""
        return self.init_cache(shape.global_batch, shape.seq_len,
                               device="meta")

    def prefill(self, params, batch):
        """(logits at the last position [B, V], cache).  As the
        reference's: the full forward, and a *fresh* zero-state cache
        whose ``len`` is the prompt length; the prompt's final states are
        not carried into it (ROADMAP C.7(d))."""
        logits, _ = self.forward(params, batch)
        b, s = batch["tokens"].shape
        cache = self.init_cache(b, 0, device=logits.device)
        cache["len"] = torch.full((b,), s, dtype=torch.int32,
                                  device=logits.device)
        return logits[:, -1], cache

    def decode_step(self, params, cache, batch):
        """One token: batch = {'token': [B, 1], ...}; returns (logits
        [B, V], the cache's new states with ``len + 1``)."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["token"],
                           getattr(torch, cfg.dtype))
        new = {k: [] for k in ("mC", "mn", "mm", "sh", "sc", "sn", "sm")}
        for bi in range(self.n_blocks):
            bp = tree_map(lambda a: a[bi], params["blocks"])
            mC, mn, mm = [], [], []
            for slot in range(self.per):
                h = L.rmsnorm(x, bp["ln"][slot])
                if slot < self.n_m:
                    st = {"C": cache["mC"][bi, slot],
                          "n": cache["mn"][bi, slot],
                          "m": cache["mm"][bi, slot]}
                    y, st = S.mlstm_decode_step(
                        cfg, tree_map(lambda a: a[slot], bp["mlstm"]), h, st)
                    mC.append(st["C"])
                    mn.append(st["n"])
                    mm.append(st["m"])
                else:
                    st = {"h": cache["sh"][bi], "c": cache["sc"][bi],
                          "n": cache["sn"][bi], "m": cache["sm"][bi]}
                    y, st = S.slstm_decode_step(cfg, bp["slstm"], h, st)
                    for k in ("h", "c", "n", "m"):
                        new["s" + k].append(st[k])
                x = x + y
            new["mC"].append(torch.stack(mC))
            new["mn"].append(torch.stack(mn))
            new["mm"].append(torch.stack(mm))
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed(cfg, params["embed"], x)[:, 0]
        out: Dict[str, Any] = {k: torch.stack(v) for k, v in new.items()}
        out["len"] = cache["len"] + 1
        return logits, out
