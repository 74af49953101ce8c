"""Jamba-style hybrid (``repro/models/hybrid.py``, arXiv:2403.19887):
Mamba and attention interleaved 7:1, MoE on every other layer.

The layers of a super-block of ``attn_period`` (8) layers::

  in-block idx : 0      1      2      3      4      5      6      7
  mixer        : mamba  mamba  mamba  mamba  mamba  mamba  mamba  ATTN
  ffn          : MLP    MoE    MLP    MoE    MLP    MoE    MLP    MoE

The parameter dict is the reference's: ``{"embed", "blocks": {"mamba",
"attn", "mlp", "moe", "ln_mix", "ln_ffn"}, "final_norm"}``, every block
leaf with a leading ``[NB, ...]`` axis (and ``[NB, n, ...]`` for the
mamba, MLP and MoE stacks inside a block).  The super-blocks run as a
Python loop (the reference's ``lax.scan``).  The attention layer's
full-sequence pass goes through :meth:`attend`, one flash-kernel launch
on the card (:func:`layers.blockwise_attention`); its decode step attends
the cache with the plain :func:`layers.decode_attention`, as the
reference's.  The MoE layers run :func:`moe.apply_moe` (dense at <= 8
experts, else dispatch); ``forward`` returns their load-balancing loss
summed, ``loss`` adds 0.01 x it to the CE.

``loss``, ``prefill`` and ``decode_step`` take ``tp``, tensor-parallel
compute over the mesh's ``model`` axis
(``parallel.tensor_parallel.model_plan``): ``params`` then hold this
rank's shards of the parts it splits (attention by whole KV groups, the
MLP, the experts, the Mamba layers by heads, the vocabulary), whose
partial sums are all-reduced into the replicated residual, and the cache
this rank's KV heads and Mamba heads and channels.  ``loss`` also takes
``dp`` and ``ce_weight`` (MoE over data-parallel ranks), as
``DecoderLM.loss``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import constrain_activations, sequence_sharded
from . import layers as L
from . import moe as M
from . import ssm as S
from .lm import input_specs_of, refuse_quantized, tree_map, unstack_layers
from .xlstm_model import prepend_axis


class HybridLM:
    def __init__(self, cfg):
        if cfg.attn_period <= 1:
            raise ValueError("HybridLM needs attn_period > 1")
        if cfg.n_layers % cfg.attn_period:
            raise ValueError("n_layers must divide by attn_period")
        self.cfg = cfg
        self.n_blocks = cfg.n_layers // cfg.attn_period
        self.per = cfg.attn_period
        self.n_mamba = self.per - 1
        # the FFN of a block's slot: MoE at odd indices, MLP at even ones
        self.moe_slots = [i for i in range(self.per) if i % 2 == 1]
        self.mlp_slots = [i for i in range(self.per) if i % 2 == 0]
        self._axes = None

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _build(self, generator: Optional[torch.Generator], device=None):
        cfg, nb = self.cfg, self.n_blocks
        dev = generator.device if generator is not None else device
        n_mlp, n_moe = len(self.mlp_slots), len(self.moe_slots)
        emb_p, emb_ax = L.init_embeddings(cfg, generator, device=dev)
        mam_p, _ = S.init_mamba(cfg, generator, layers=(nb, self.n_mamba),
                                device=dev)
        att_p, _ = L.init_attention(cfg, generator, layers=nb, device=dev)
        mlp_p, _ = L.init_mlp(cfg, generator, d_ff=cfg.d_ff,
                              layers=(nb, n_mlp), device=dev)
        moe_p, _ = M.init_moe(cfg, generator, layers=(nb, n_moe), device=dev)
        # the axes are the reference's: one block's, with "blocks" in front
        meta = dict(device="meta")
        mam_ax = S.init_mamba(cfg, None, layers=self.n_mamba, **meta)[1]
        att_ax = L.init_attention(cfg, None, **meta)[1]
        mlp_ax = L.init_mlp(cfg, None, d_ff=cfg.d_ff, layers=n_mlp, **meta)[1]
        moe_ax = M.init_moe(cfg, None, layers=n_moe, **meta)[1]
        ln_mix = torch.ones((nb, self.per, cfg.d_model), device=dev)
        ln_ffn = torch.ones((nb, self.per, cfg.d_model), device=dev)
        lnf_p, lnf_ax = L.init_norm(cfg, cfg.d_model, device=dev)
        params = {"embed": emb_p,
                  "blocks": {"mamba": mam_p, "attn": att_p, "mlp": mlp_p,
                             "moe": moe_p, "ln_mix": ln_mix,
                             "ln_ffn": ln_ffn},
                  "final_norm": lnf_p}
        self._axes = {"embed": emb_ax,
                      "blocks": {"mamba": prepend_axis(mam_ax),
                                 "attn": prepend_axis(att_ax),
                                 "mlp": prepend_axis(mlp_ax),
                                 "moe": prepend_axis(moe_ax),
                                 "ln_mix": ("blocks", "layers", "embed"),
                                 "ln_ffn": ("blocks", "layers", "embed")},
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
    # blocks
    # ------------------------------------------------------------------
    def attend(self, q, k, v, q_offset: int = 0):
        """The attention layer's full-sequence causal attention, q
        [B, S, H, dh], k/v [B, S, KV, dh]: one flash-kernel launch on the
        card.  ``q_offset``: q is a sequence chunk whose rows sit at
        ``q_offset`` onward (k/v the whole sequence)."""
        return L.blockwise_attention(q, k, v, causal=True, q_offset=q_offset)

    def moe(self, p, h, tp=None, dp=None):
        """One MoE layer, (y, aux): :func:`moe.apply_moe`'s ``"auto"``
        path (``tp``: expert parallelism, y a partial sum; ``dp``: the
        router's statistics and capacity over the data-parallel
        ranks)."""
        return M.apply_moe(self.cfg, p, h, tp=tp, dp=dp)

    def _ffn(self, parts, slot, x, tp=None, dp=None, seq=False):
        """The FFN of ``slot`` with its residual; returns (x, aux).  With
        ``seq`` x is this rank's sequence chunk (``DecoderLM._block``): a
        part on its shards takes it gathered whole, a replicated MLP the
        chunk alone, a replicated MoE its input gathered whole (the
        capacity queues couple the tokens)."""
        ln = parts["ln_ffn"][slot]
        moe = slot in self.moe_slots
        split = tp is not None and (tp.experts if moe else tp.mlp)
        local = seq and not split
        h = L.rmsnorm(x, L.seq_copied(ln, tp)) if local else \
            L.rmsnorm(L.seq_enter(x, tp, True) if seq else x, ln)
        if moe:
            # a hook of the old (p, h) signature serves one device
            kw = {k: v for k, v in (("tp", tp), ("dp", dp)) if v is not None}
            y, aux = self.moe(parts["moe"][self.moe_slots.index(slot)],
                              tp.gather(h, 1) if local else h, **kw)
            if local:
                return x + tp.split(y, 1), aux
        else:
            p = parts["mlp"][self.mlp_slots.index(slot)]
            if local:
                return x + L.apply_mlp(self.cfg, L.seq_copied(p, tp), h), 0.0
            y, aux = L.apply_mlp(self.cfg, p, h, tp=tp), 0.0
        return x + L.seq_exit(y, tp, seq, split), aux

    def _parts(self, bp):
        """One block's stacks as per-slot lists (``unbind``: one stack op
        in the backward pass)."""
        return {"mamba": unstack_layers(bp["mamba"], self.n_mamba),
                "mlp": unstack_layers(bp["mlp"], len(self.mlp_slots)),
                "moe": unstack_layers(bp["moe"], len(self.moe_slots)),
                "ln_mix": bp["ln_mix"].unbind(0),
                "ln_ffn": bp["ln_ffn"].unbind(0), "attn": bp["attn"]}

    def _attention(self, p, h, positions, tp=None, seq=False):
        """The attention layer over the whole sequence: (out [B, S, D],
        k, v); under ``tp.attn`` this rank's KV heads, ``out`` reduced
        (reduce-scattered to this rank's chunk under ``seq``)."""
        q, k, v = L.qkv_project(self.cfg, p, h, positions, tp=tp)
        attn = self.attend(q, k, v)
        out = attn.reshape(h.shape[:2] + (q.shape[2] * q.shape[3],)) \
            @ p["wo"].to(h.dtype)
        return L.seq_exit(out, tp, seq, tp is not None and tp.attn), k, v

    def _super_block(self, bp, x, positions, tp=None, dp=None, seq=False):
        """One super-block: (x, aux summed, the attention layer's k, v).
        With ``seq`` (the training stack under the activation-sharding
        context) x is this rank's sequence chunk: the Mamba layers (a
        recurrence over the sequence) and the parts on their shards take
        it gathered whole, replicated attention runs on the chunk with K
        and V gathered (:func:`layers.seq_attention`; k and v None)."""
        parts = self._parts(bp)
        aux = 0.0
        k = v = None
        for slot in range(self.per):
            ln = parts["ln_mix"][slot]
            if slot < self.n_mamba:
                h = L.rmsnorm(L.seq_enter(x, tp, True) if seq else x, ln)
                y = S.mamba_forward(self.cfg, parts["mamba"][slot], h, tp=tp)
                x = x + L.seq_exit(y, tp, seq, tp is not None and tp.mamba)
            elif seq and not tp.attn:
                h = L.rmsnorm(x, L.seq_copied(ln, tp))
                x = x + L.seq_attention(self.cfg, parts["attn"], h,
                                        positions, tp, self.attend)
            else:
                h = L.rmsnorm(L.seq_enter(x, tp, True) if seq else x, ln)
                y, k, v = self._attention(parts["attn"], h, positions, tp,
                                          seq)
                x = x + y
            x, a = self._ffn(parts, slot, x, tp, dp, seq)
            aux = aux + a
        return x, aux, k, v

    def _block_train(self, bp, x, positions, tp=None, dp=None, seq=False):
        x, aux, _, _ = self._super_block(bp, x, positions, tp, dp, seq)
        return x, aux

    def _embed(self, params, tokens, tp=None):
        """(x [B, S, D], positions [B, S]); ``tp``: a vocabulary-parallel
        lookup."""
        x = L.embed_tokens(params["embed"], tokens,
                           getattr(torch, self.cfg.dtype), tp)
        b, s = x.shape[0], x.shape[1]
        return x, torch.arange(s, device=x.device).expand(b, s)

    def _hidden(self, params, batch, remat: bool = False, tp=None,
                dp=None, whole: bool = True):
        """(the last hidden states, aux).  Under the activation-sharding
        context (``parallel.sharding.constrain_activations``) the residual
        is this rank's sequence chunk between the super-blocks, as the
        reference's scan constrains it; returned gathered whole and
        normed, or (``whole`` False) as the chunk, not normed."""
        cfg = self.cfg
        refuse_quantized(cfg, params)
        x, positions = self._embed(params, batch["tokens"], tp)
        seq = sequence_sharded(tp, x.shape[1])
        x = constrain_activations(x, tp)
        aux = 0.0
        for bp in unstack_layers(params["blocks"], self.n_blocks):
            if remat:
                x, a = checkpoint(self._block_train, bp, x, positions, tp,
                                  dp, seq, use_reentrant=False)
            else:
                x, a = self._block_train(bp, x, positions, tp, dp, seq)
            aux = aux + a
        if seq and not whole:
            return x, aux
        if seq:
            x = tp.gather(x, 1)
        return L.apply_norm(cfg, x, params["final_norm"]), aux

    def forward(self, params, batch):
        """(logits [B, S, V], the MoE layers' load-balancing loss summed)."""
        x, aux = self._hidden(params, batch)
        return L.unembed(self.cfg, params["embed"], x), aux

    def loss(self, params, batch, *, remat: bool = False, tp=None,
             dp=None, ce_weight=None):
        """Mean next-token CE + 0.01 x the load-balancing loss; ``remat``
        recomputes each super-block in the backward pass.  ``tp``:
        tensor-parallel compute over ``model`` (the module's docstring).

        ``dp`` (the batch split over data-parallel ranks): this rank's
        part of the global batch's loss, as ``DecoderLM.loss``: the MoE
        layers' router statistics and capacity queues span the ranks, the
        result is ``ce_weight`` (this rank's share of the loss tokens) x
        its mean CE plus 0.01 x the aux term valued at 1 / ``dp.size`` of
        it, so that the ranks' values and gradients sum to the global
        loss's."""
        # a sequence-sharded residual with a replicated head: the final
        # norm and the cross-entropy on this rank's chunk
        local = sequence_sharded(tp, batch["tokens"].shape[1]) \
            and not tp.vocab
        x, aux = self._hidden(params, batch, remat, tp, dp, whole=not local)
        if local:
            ce = L.seq_cross_entropy(self.cfg, x, params["final_norm"],
                                     params["embed"], batch["labels"], None,
                                     tp)
        else:
            ce = L.chunked_cross_entropy(self.cfg, x, params["embed"],
                                         batch["labels"], tp=tp)
        if dp is not None:
            ce = ce * ce_weight
            aux = aux + aux.detach() * (1.0 / dp.size - 1.0)
        return ce + 0.01 * aux

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None, tp=None):
        """The attention layers' K/V [NB, B, T, KV, dh] and the Mamba
        layers' ``ssm`` [NB, 7, B, H, N, P] and ``conv`` states, zero;
        under ``tp`` this rank's KV heads (``tp.attn``) and Mamba heads
        and channels (``tp.mamba``) of them."""
        cfg, nb = self.cfg, self.n_blocks
        dt = getattr(torch, cfg.dtype)
        _, n, _, pd = S.mamba_dims(cfg)
        _, d_in, h = S._mamba_split(cfg, tp)
        kv_heads = cfg.n_kv_heads // (tp.size if tp is not None and tp.attn
                                      else 1)
        kv = (nb, batch, max_len, kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "ssm": torch.zeros((nb, self.n_mamba, batch, h, n, pd),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((nb, self.n_mamba, batch,
                                     cfg.mamba_d_conv - 1, d_in), dtype=dt,
                                    device=device),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def cache_axes(self):
        t = ("blocks", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": t, "v": t,
                "ssm": ("blocks", "layers", "batch", "heads", "state",
                        "head_dim"),
                "conv": ("blocks", "layers", "batch", "conv", "ffn"),
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
        reference's: the attention layers' K/V of the prompt, ``len`` the
        prompt length, and *zero* Mamba states (the prompt's are not kept:
        ROADMAP C.7(d)).  ``tp``: as in :meth:`loss`, the cache this
        rank's part (:meth:`init_cache`), the logits gathered whole."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x, positions = self._embed(params, batch["tokens"], tp)
        b, s = x.shape[0], x.shape[1]
        ks, vs = [], []
        for bp in unstack_layers(params["blocks"], self.n_blocks):
            x, _, k, v = self._super_block(bp, x, positions, tp)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed_whole(cfg, params["embed"], x[:, -1:],
                                 tp=tp)[:, 0]
        cache = self.init_cache(b, s, device=x.device, tp=tp)
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
        cache["len"] = torch.full((b,), s, dtype=torch.int32,
                                  device=x.device)
        return logits, cache

    def decode_step(self, params, cache, batch, tp=None, cache_seq=None):
        """One token: batch = {'token': [B, 1], 'pos': [B]}.  Writes the
        attention layers' fresh K/V into ``cache`` in place (the reference
        returns an updated copy; a ``pos`` past the cache writes its last
        entry, as ``dynamic_update_slice`` clamps); returns (logits
        [B, V], cache with the new Mamba states and ``len + 1``).  ``tp``
        as in :meth:`prefill`.  ``cache_seq``: the attention cache is this
        rank's shard of the sequence (``long_500k`` maps it over
        ``data``), written by the owner of ``pos`` and attended in
        partials merged over the shards, as ``DecoderLM.decode_step``."""
        cfg = self.cfg
        tok, pos = batch["token"], batch["pos"]
        x = L.embed_tokens(params["embed"], tok, getattr(torch, cfg.dtype),
                           tp)
        b = x.shape[0]
        positions = pos[:, None]
        kc, vc = cache["k"], cache["v"]
        rows = torch.arange(b, device=x.device)
        where = dict(shards=cache_seq, tp=tp)
        ssm_out, conv_out = [], []
        for bi in range(self.n_blocks):
            bp = tree_map(lambda a: a[bi], params["blocks"])
            parts = self._parts(bp)
            ssm_new, conv_new = [], []
            for slot in range(self.per):
                h = L.rmsnorm(x, parts["ln_mix"][slot])
                if slot < self.n_mamba:
                    st = {"ssm": cache["ssm"][bi, slot],
                          "conv": cache["conv"][bi, slot]}
                    y, st = S.mamba_decode_step(cfg, parts["mamba"][slot],
                                                h, st, tp)
                    ssm_new.append(st["ssm"])
                    conv_new.append(st["conv"])
                    y = L.reduced(y, tp, tp is not None and tp.mamba)
                else:
                    q, k, v = L.qkv_project(cfg, parts["attn"], h, positions,
                                            tp=tp)
                    L.decode_write(kc[bi], rows, pos, k[:, 0], **where)
                    L.decode_write(vc[bi], rows, pos, v[:, 0], **where)
                    attn = L.decode_attend(q, kc[bi], vc[bi], pos + 1,
                                           **where)
                    y = attn.reshape(b, 1, q.shape[2] * q.shape[3]) \
                        @ parts["attn"]["wo"].to(x.dtype)
                    y = L.reduced(y, tp, tp is not None and tp.attn)
                x = x + y
                x, _ = self._ffn(parts, slot, x, tp)
            ssm_out.append(torch.stack(ssm_new))
            conv_out.append(torch.stack(conv_new))
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed_whole(cfg, params["embed"], x, tp=tp)[:, 0]
        return logits, {"k": kc, "v": vc, "ssm": torch.stack(ssm_out),
                        "conv": torch.stack(conv_out),
                        "len": cache["len"] + 1}
