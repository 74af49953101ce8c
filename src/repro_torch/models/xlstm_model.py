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

``loss``, ``prefill`` and ``decode_step`` take ``tp``, tensor-parallel
compute over the mesh's ``model`` axis
(``parallel.tensor_parallel.model_plan``): the mLSTM layers on this
rank's heads where they divide (their partial sums all-reduced into the
replicated residual, the state this rank's heads), the sLSTM's input
projection on its stored chunk of the gates (the pre-activations
all-gathered, the cell replicated), the vocabulary where it divides.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import constrain_activations, sequence_sharded
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
    def _super_block(self, bp, x, tp=None, seq=False):
        """One super-block.  With ``seq`` x is this rank's sequence chunk:
        an mLSTM layer not split over ``model`` runs its norm and
        projections on the chunk, gathers what the recurrence needs and
        returns the chunk's output (``ssm.mlstm_forward(seq=)``, its
        weights through :func:`layers.seq_copied`); the other layers take
        x gathered whole (:func:`layers.seq_enter`) and give back the
        chunk: an mLSTM split over ``model`` its reduce-scatter
        (:func:`layers.seq_exit`), the sLSTM (its cell a recurrence run
        replicated) its output cut to the chunk before ``wout``."""
        cfg = self.cfg
        mlstm = unstack_layers(bp["mlstm"], self.n_m)
        ln = bp["ln"].unbind(0)
        for slot in range(self.per):
            if slot < self.n_m and seq and not tp.mlstm:
                h = L.rmsnorm(x, L.seq_copied(ln[slot], tp))
                x = x + S.mlstm_forward(
                    cfg, L.seq_copied(mlstm[slot], tp), h, seq=tp)
                continue
            h = L.rmsnorm(L.seq_enter(x, tp, True) if seq else x, ln[slot])
            if slot < self.n_m:
                y = S.mlstm_forward(cfg, mlstm[slot], h, tp=tp)
                x = x + L.seq_exit(y, tp, seq, tp is not None and tp.mlstm)
            else:
                x = x + S.slstm_forward(cfg, bp["slstm"], h, tp=tp, seq=seq)
        return x

    def _hidden(self, params, batch, remat: bool = False, tp=None,
                whole: bool = True):
        """The last hidden states.  Under the activation-sharding context
        the residual is this rank's sequence chunk between the
        super-blocks, as the reference's forward constrains it (its
        prefill runs the forward too); returned gathered whole and normed,
        or (``whole`` False) as the chunk, not normed."""
        cfg = self.cfg
        refuse_quantized(cfg, params)
        x = L.embed_tokens(params["embed"], batch["tokens"],
                           getattr(torch, cfg.dtype), tp)
        seq = sequence_sharded(tp, x.shape[1])
        x = constrain_activations(x, tp)
        for bp in unstack_layers(params["blocks"], self.n_blocks):
            if remat:
                x = checkpoint(self._super_block, bp, x, tp, seq,
                               use_reentrant=False)
            else:
                x = self._super_block(bp, x, tp, seq)
        if seq and not whole:
            return x
        if seq:
            x = tp.gather(x, 1)
        return L.apply_norm(cfg, x, params["final_norm"])

    def forward(self, params, batch):
        """(logits [B, S, V], aux = 0.0)."""
        x = self._hidden(params, batch)
        return L.unembed(self.cfg, params["embed"], x), 0.0

    def loss(self, params, batch, *, remat: bool = False, tp=None):
        """Mean next-token CE of ``batch["labels"]`` (chunked unembedding);
        ``remat`` recomputes each super-block in the backward pass;
        ``tp``: tensor-parallel compute over ``model``."""
        # a sequence-sharded residual with a replicated head: the final
        # norm and the cross-entropy on this rank's chunk
        local = sequence_sharded(tp, batch["tokens"].shape[1]) \
            and not tp.vocab
        x = self._hidden(params, batch, remat, tp, whole=not local)
        if local:
            return L.seq_cross_entropy(self.cfg, x, params["final_norm"],
                                       params["embed"], batch["labels"],
                                       None, tp)
        return L.chunked_cross_entropy(self.cfg, x, params["embed"],
                                       batch["labels"], tp=tp)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None, tp=None):
        """The recurrent states, zero (stabilizers at -1e30): O(1) in
        ``max_len``; under ``tp.mlstm`` the mLSTM states' heads are this
        rank's."""
        del max_len
        cfg, nb, nm = self.cfg, self.n_blocks, self.n_m
        h, dh, d = S._mlstm_heads(cfg, tp)[1], cfg.head_dim, cfg.d_model

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

    def prefill(self, params, batch, tp=None):
        """(logits at the last position [B, V], cache).  As the
        reference's: the full forward, and a *fresh* zero-state cache
        whose ``len`` is the prompt length; the prompt's final states are
        not carried into it (ROADMAP C.7(d)).  ``tp``: as in :meth:`loss`
        (the logits gathered whole, the cache this rank's part)."""
        x = self._hidden(params, batch, tp=tp)
        logits = L.unembed_whole(self.cfg, params["embed"], x, tp=tp)
        b, s = batch["tokens"].shape
        cache = self.init_cache(b, 0, device=logits.device, tp=tp)
        cache["len"] = torch.full((b,), s, dtype=torch.int32,
                                  device=logits.device)
        return logits[:, -1], cache

    def decode_step(self, params, cache, batch, tp=None):
        """One token: batch = {'token': [B, 1], ...}; returns (logits
        [B, V], the cache's new states with ``len + 1``).  ``tp`` as in
        :meth:`prefill`."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["token"],
                           getattr(torch, cfg.dtype), tp)
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
                        cfg, tree_map(lambda a: a[slot], bp["mlstm"]), h, st,
                        tp)
                    y = L.reduced(y, tp, tp is not None and tp.mlstm)
                    mC.append(st["C"])
                    mn.append(st["n"])
                    mm.append(st["m"])
                else:
                    st = {"h": cache["sh"][bi], "c": cache["sc"][bi],
                          "n": cache["sn"][bi], "m": cache["sm"][bi]}
                    y, st = S.slstm_decode_step(cfg, bp["slstm"], h, st, tp)
                    for k in ("h", "c", "n", "m"):
                        new["s" + k].append(st[k])
                x = x + y
            new["mC"].append(torch.stack(mC))
            new["mn"].append(torch.stack(mn))
            new["mm"].append(torch.stack(mm))
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed_whole(cfg, params["embed"], x, tp=tp)[:, 0]
        out: Dict[str, Any] = {k: torch.stack(v) for k, v in new.items()}
        out["len"] = cache["len"] + 1
        return logits, out
