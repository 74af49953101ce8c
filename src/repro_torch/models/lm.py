"""Decoder-only language model, dense family (``repro/models/lm.py``).

The parameter dict has the reference's structure and layouts::

    {"embed": {"tok": [V, D]},
     "layers": {"attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]},
                "ffn": {"wi_gate", "wi_up", "wo"} | {"wi", "wo"},
                "ln1": {"scale"}, "ln2": {"scale"}},       # all [L, ...]
     "final_norm": {"scale": [D]}}

so ``bridge.params_from_jax`` carries the reference's pytree across leaf
for leaf.  The layer stack runs as a plain Python loop (the reference's
``lax.scan`` / ``while_loop``).  ``loss`` serves ``runtime.train_loop``;
the decode protocol (``prefill``, ``init_cache``, ``cache_axes``,
``decode_step``, ``decode_step_q``) serves ``runtime.decode_engine``.

MoE configs (``n_experts`` > 0, every layer: ``moe_every`` = 1) replace
the ``ffn`` subtree by ``{"router", "wi_gate", "wi_up", "wo"}``
(:mod:`models.moe`); the forward and ``loss`` carry the router's
load-balancing loss (``loss`` = CE + 0.01 * aux), the split-execution,
prefill and decode paths drop it, as the reference's do.  The decode
step runs the dense MoE path at <= 8 experts, else dispatch over the
whole slot block as one group (its rows then share the experts'
capacity, as in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attn import quantized_decode_attention
from ..kernels.quantize import kv_quantize
from ..parallel.sharding import constrain_activations, sequence_sharded
from . import layers as L
from . import moe as M


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict: a tensor, or a
    ``QuantizedTensor`` (codes and scale together) of an int8-resident
    tree (``core.quantization.quantize_tree_stacked``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(tree, n: int):
    """The n per-layer slices of a layer-stacked tree, as a list of trees.

    Through ``unbind``, whose backward stacks the slices' gradients in one
    op; indexing each layer instead would make autograd add a zero-filled
    gradient of the whole stack per layer (O(L^2) bytes in a training
    step).  A ``QuantizedTensor`` leaf unbinds into its layers' codes and
    scales."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def tree_leaves(tree):
    """The leaves of nested dicts (in sorted-key order) and lists: the
    reference's pytree order.  A ``QuantizedTensor`` is one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from tree_leaves(sub)
    else:
        yield tree


def refuse_quantized(cfg, params) -> None:
    """Raise, in one line, when ``params`` holds a ``QuantizedTensor``:
    the recurrent, hybrid and encoder-decoder families index their
    weights directly, and the reference's forwards refuse such a tree
    (``'QuantizedTensor' object is not subscriptable``); only the
    decoder-only LM reads every weight through ``.to(dtype)``."""
    from ..core.quantization import QuantizedTensor
    if any(isinstance(a, QuantizedTensor) for a in tree_leaves(params)):
        raise TypeError(f"{cfg.name}: 'QuantizedTensor' object is not "
                        "subscriptable (the int8-resident forward serves "
                        "the decoder-only LM only)")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs_of(shape, *, text: Optional[int] = None, embeds=None):
    """The dry-run's batch for ``shape`` (a ``configs.ShapeSpec``) as
    ``meta`` tensors, the reference's ``input_specs``: a training or
    prefill step's ``tokens`` (and a training step's ``labels``) of
    ``text`` positions (default the whole sequence), behind stub
    ``embeds`` of ``(positions, width, dtype)`` when given; a decode
    step's one ``token`` and its ``pos``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind not in ("train", "prefill"):
        return {"token": _meta((b, 1), i32), "pos": _meta((b,), i32)}
    st = s if text is None else text
    out = {}
    if embeds is not None:
        n, width, dt = embeds
        out["embeds"] = _meta((b, n, width), dt)
    out["tokens"] = _meta((b, st), i32)
    if shape.kind == "train":
        out["labels"] = _meta((b, st), i32)
    return out


class DecoderLM:
    """Config-driven decoder-only LM (dense or MoE layers)."""

    def __init__(self, cfg):
        # the layer stack is homogeneous: all layers MoE or all dense
        if cfg.n_experts and cfg.moe_every != 1:
            raise ValueError("DecoderLM supports moe_every=1; interleaved "
                             "MoE belongs to the hybrid model")
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
        if cfg.n_experts:
            ffn_p, ffn_ax = M.init_moe(cfg, generator, layers=n, device=dev)
        else:
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

    def param_structs(self):
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        memory (the reference's ``jax.eval_shape`` of ``init``)."""
        return self._build(None, device="meta")

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _block(self, lp, x, positions, tp=None, dp=None, seq=False):
        """One layer; returns (x, aux): the MoE router's load-balancing
        loss, or 0.0 for a dense layer.

        Under tensor-parallel compute (``tp``) the attention, MLP or
        experts whose sizes divide compute on this rank's shards and their
        partial sums are reduced over ``model``; the others compute
        replicated.  With ``seq`` (``parallel.sharding.sequence_sharded``)
        ``x`` is this rank's sequence chunk.  A part on its shards gathers
        it whole before its norm (so the norm's scale sees every
        position, as without ``seq``, and needs no reduction of its
        gradient) and its partial sums come back reduce-scattered
        (:func:`layers.seq_enter`, :func:`layers.seq_exit`).  A part that
        computes replicated runs on the chunk alone
        (:func:`layers.seq_attention`, :meth:`_seq_ffn`): its per-token
        work is this rank's positions only.  ``dp``: the MoE router's
        statistics and capacity over the data-parallel ranks."""
        cfg = self.cfg
        sharded = tp is not None and tp.attn
        if seq and not sharded:
            h = L.apply_norm(cfg, x, L.seq_copied(lp["ln1"], tp))
            x = x + L.seq_attention(cfg, lp["attn"], h, positions, tp,
                                    self.attend)
        else:
            h = L.apply_norm(cfg, L.seq_enter(x, tp, seq), lp["ln1"])
            q, k, v = L.qkv_project(cfg, lp["attn"], h, positions, tp=tp)
            attn = self.attend(q, k, v)
            y = attn.reshape(h.shape[:2] + (q.shape[2] * q.shape[3],)) \
                @ lp["attn"]["wo"].to(x.dtype)
            x = x + L.seq_exit(y, tp, seq, sharded)
        sharded = tp is not None and (tp.experts if cfg.n_experts
                                      else tp.mlp)
        if seq and not sharded:
            y, aux = self._seq_ffn(lp, x, tp, dp)
            return x + y, aux
        h2 = L.apply_norm(cfg, L.seq_enter(x, tp, seq), lp["ln2"])
        y, aux = self._ffn(lp["ffn"], h2, tp, dp)
        return x + L.seq_exit(y, tp, seq, sharded), aux

    def _seq_ffn(self, lp, x, tp, dp):
        """The FFN computed replicated on a sequence-sharded residual;
        returns (its output on this rank's chunk, aux).  The dense MLP is
        per-token work: the chunk alone, its weights through
        :func:`layers.seq_copied`.  The experts' capacity queues couple a
        batch's tokens, so an MoE whose experts do not divide over
        ``model`` takes its input gathered whole (each rank computes the
        one-rank MoE, its router statistics and queues those of every
        position) and keeps its chunk of the output."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, L.seq_copied(lp["ln2"], tp))
        if cfg.n_experts:
            y, aux = M.apply_moe(cfg, lp["ffn"], tp.gather(h, 1), tp=tp,
                                 dp=dp)
            return tp.split(y, 1), aux
        return L.apply_mlp(cfg, L.seq_copied(lp["ffn"], tp), h), 0.0

    def _ffn(self, p, h, tp=None, dp=None):
        """The layer's MLP, or its MoE (the reference's ``"auto"`` path);
        returns (y, aux), y a partial sum over ``model`` where ``tp``
        shards it."""
        if self.cfg.n_experts:
            return M.apply_moe(self.cfg, p, h, tp=tp, dp=dp)
        return L.apply_mlp(self.cfg, p, h, tp=tp), 0.0

    def attend(self, q, k, v, q_offset: int = 0):
        """One layer's full-sequence causal attention, q [B, S, H, dh],
        k/v [B, S, KV, dh]: the flash kernel on the card
        (:func:`layers.blockwise_attention`).  Every full-sequence pass
        (forward, both co-inference stages, prefill, training) attends
        through this hook.  ``q_offset``: q is a sequence chunk whose rows
        sit at ``q_offset`` onward (k/v the whole sequence)."""
        return L.blockwise_attention(q, k, v, causal=True,
                                     window=self.cfg.sliding_window,
                                     q_offset=q_offset)

    def _run_stack(self, params, x, positions, *, remat: bool = False,
                   tp=None, dp=None, whole: bool = True):
        """All layers for training; returns (x, the layers' aux losses
        summed in layer order).  ``remat`` recomputes each layer in the
        backward pass (``torch.utils.checkpoint``), keeping only the layer
        inputs alive, as the reference's per-layer ``jax.checkpoint``.
        ``tp``/``dp`` as in :meth:`_block`; under the activation-sharding
        context the residual is held as its spec says between the blocks
        (``parallel.sharding.constrain_activations``) and returned whole,
        or (``whole`` False) as this rank's chunk."""
        seq = sequence_sharded(tp, x.shape[1])
        x = constrain_activations(x, tp)
        aux = 0.0
        for lp_i in unstack_layers(params["layers"], self.cfg.n_layers):
            if remat:
                x, a = checkpoint(self._block, lp_i, x, positions, tp, dp,
                                  seq, use_reentrant=False)
            else:
                x, a = self._block(lp_i, x, positions, tp, dp, seq)
            aux = aux + a
        return (tp.gather(x, 1) if seq and whole else x), aux

    def run_layers_window(self, params, x, positions, lo: int, hi: int):
        """Layers [lo, hi) applied in order; returns (x, aux=0.0): the
        split-execution path drops the MoE aux loss, as the reference's."""
        lp = params["layers"]
        for i in range(int(lo), int(hi)):
            x, _ = self._block(tree_map(lambda a: a[i], lp), x, positions)
        return x, 0.0

    def run_layers(self, params, x, positions, lo: int, hi: int):
        """Co-inference split execution: layers [lo, hi) on activations x."""
        return self.run_layers_window(params, x, positions, lo, hi)

    # ------------------------------------------------------------------
    # embedding
    # ------------------------------------------------------------------
    def _embed(self, params, batch: Dict[str, Any], tp=None):
        """batch dict -> (x [B, S, D], positions [B, S]); ``tp``: a
        vocabulary-parallel lookup (:func:`layers.embed_tokens`)."""
        dtype = getattr(torch, self.cfg.dtype)
        parts = []
        if "embeds" in batch:
            parts.append(batch["embeds"].to(dtype))
        if "tokens" in batch:
            parts.append(L.embed_tokens(params["embed"], batch["tokens"],
                                        dtype, tp))
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        return x, positions

    def embed(self, params, batch):
        """Public embedding hook (the reference's compiled path traces it)."""
        return self._embed(params, batch)

    def forward(self, params, batch):
        """Full forward: (logits [B, S, V], aux): the MoE layers'
        load-balancing loss summed, 0.0 for a dense model."""
        x, positions = self._embed(params, batch)
        x, aux = self._run_stack(params, x, positions)
        x = L.apply_norm(self.cfg, x, params["final_norm"])
        return L.unembed(self.cfg, params["embed"], x), aux

    def loss(self, params, batch, *, remat: bool = False, tp=None,
             dp=None, ce_weight=None):
        """Mean next-token CE of ``batch["labels"]`` (masked by
        ``batch["loss_mask"]`` when present) from the final hidden states,
        with the chunked unembedding: the full [B, S, V] logits never
        materialize for long sequences.  MoE configs add 0.01 x the
        layers' load-balancing loss.  ``tp``: tensor-parallel compute over
        the mesh's ``model`` axis, ``params`` holding this rank's shards
        of the parts that ``tp`` splits (``parallel/tensor_parallel.py``).

        ``dp`` (an MoE config whose batch is split over data-parallel
        ranks): this rank's part of the global batch's loss.  The layers'
        router statistics and capacity queues span the ranks, so the aux
        term is the global batch's on every rank, and its gradient here is
        this rank's tokens' part.  The result is ``ce_weight`` (this
        rank's share of the loss tokens) x its mean CE plus 0.01 x the
        aux term valued at 1 / ``dp.size`` of it: summed over the ranks,
        the values give the global loss and the gradients its gradient."""
        x, positions = self._embed(params, batch, tp)
        labels = batch["labels"]
        # a sequence-sharded residual with a replicated head: the final
        # norm and the cross-entropy on this rank's chunk
        local = (sequence_sharded(tp, x.shape[1]) and not tp.vocab
                 and x.shape[1] == labels.shape[1])
        x, aux = self._run_stack(params, x, positions, remat=remat, tp=tp,
                                 dp=dp, whole=not local)
        if local:
            ce = L.seq_cross_entropy(self.cfg, x, params["final_norm"],
                                     params["embed"], labels,
                                     batch.get("loss_mask"), tp)
        else:
            x = L.apply_norm(self.cfg, x, params["final_norm"])
            if x.shape[1] != labels.shape[1]:
                x = x[:, -labels.shape[1]:]
            ce = L.chunked_cross_entropy(self.cfg, x, params["embed"],
                                         labels, batch.get("loss_mask"),
                                         tp=tp)
        if not self.cfg.n_experts:
            return ce
        if dp is not None:
            ce = ce * ce_weight
            aux = aux + aux.detach() * (1.0 / dp.size - 1.0)
        return ce + 0.01 * aux

    # ------------------------------------------------------------------
    # serving: the decode protocol
    # ------------------------------------------------------------------
    def prefill(self, params, batch, last_index=None, tp=None):
        """Full-sequence pass building the KV cache; returns (logits at
        each row's last prompt position [B, V], cache).

        ``tp``: tensor-parallel compute over ``model`` as in :meth:`loss`
        (``params`` holding this rank's shards of what it splits); the
        cache then holds this rank's KV heads where attention is split,
        and the logits are gathered whole.

        ``last_index`` ([B] ints, optional) names each row's true final
        position in a right-padded batch: logits are gathered there and
        the cache ``len`` is ``last_index + 1``.  Causal attention makes
        positions <= last_index independent of the padding.  The cache is
        ``{"k", "v": [L, B, S, KV, dh], "len": [B] int32}``.
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        x, positions = self._embed(params, batch, tp)
        b, s = x.shape[0], x.shape[1]
        lp = params["layers"]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p_i = tree_map(lambda a: a[i], lp)
            h = L.apply_norm(cfg, x, p_i["ln1"])
            q, k, v = L.qkv_project(cfg, p_i["attn"], h, positions, tp=tp)
            attn = self.attend(q, k, v)
            y = attn.reshape(b, s, q.shape[2] * q.shape[3]) \
                @ p_i["attn"]["wo"].to(x.dtype)
            x = x + L.reduced(y, tp, tp is not None and tp.attn)
            h2 = L.apply_norm(cfg, x, p_i["ln2"])
            y = self._ffn(p_i["ffn"], h2, tp)[0]
            x = x + L.reduced(y, tp, tp is not None and (
                tp.experts if cfg.n_experts else tp.mlp))
            ks.append(k.to(dtype))
            vs.append(v.to(dtype))
        x = L.apply_norm(cfg, x, params["final_norm"])
        if last_index is None:
            sel = x[:, -1:]
            lens = torch.full((b,), s, dtype=torch.int32, device=x.device)
        else:
            idx = torch.as_tensor(last_index, device=x.device).reshape(-1)
            sel = x[torch.arange(b, device=x.device), idx.long()][:, None]
            lens = (idx + 1).to(torch.int32)
        logits = self._logits(params, sel, tp)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "len": lens}

    def _logits(self, params, x, tp, matmul=torch.matmul):
        """The head's logits [B, V] of x [B, 1, D], gathered whole over
        ``model`` when ``tp`` splits the vocabulary."""
        return L.unembed_whole(self.cfg, params["embed"], x, matmul=matmul,
                               tp=tp)[:, 0]

    def init_cache(self, batch: int, max_len: int, device=None):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def cache_axes(self):
        t = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": t, "v": t, "len": ("batch",)}

    # ------------------------------------------------------------------
    # dry-run input specs
    # ------------------------------------------------------------------
    def input_specs(self, shape):
        """The batch of a dry-run cell as ``meta`` tensors: a multimodal
        config's first ``int(S * vis_frac) // 16 * 16`` positions are
        stub embeddings, the rest tokens."""
        cfg = self.cfg
        if cfg.frontend == "none":
            return input_specs_of(shape)
        sv = int(shape.seq_len * cfg.vis_frac) // 16 * 16
        return input_specs_of(shape, text=shape.seq_len - sv,
                              embeds=(sv, cfg.d_model,
                                      getattr(torch, cfg.dtype)))

    def cache_specs(self, shape):
        """The cache of a dry-run decode cell as ``meta`` tensors."""
        return self.init_cache(shape.global_batch, shape.seq_len,
                               device="meta")

    def _decode_layers(self, params, x, pos, t: int, write, attend,
                       tp=None):
        """The layer loop of one decode token over a cache of ``t``
        positions.  ``write(i, k, v, at)`` stores layer i's fresh entry at
        cache position ``at`` and
        ``attend(i, q)`` attends layer i's cache; the projections go
        through :func:`layers.row_matmul` (row-independent bits), q | k | v
        and gate | up as one grouped launch each
        (:func:`layers.row_matmul_group`).  An MoE layer's router takes
        :func:`layers.row_matmul` too; its experts run as the reference's
        products over the expert stacks: dense at <= 8 experts (one token
        at a time, so rows stay independent), else dispatch over the whole
        block as one group of ``min(1024, B)``.  ``tp``: tensor-parallel
        compute over ``model`` (as in :meth:`prefill`)."""
        cfg = self.cfg
        mm = L.row_matmul
        b = x.shape[0]
        positions = pos[:, None]
        # the reference writes with dynamic_update_slice, which clamps an
        # out-of-range start: a dead slot whose pos ran past the cache
        # writes its last entry instead of faulting
        at = torch.clamp(pos, max=t - 1)
        lp = params["layers"]
        for i in range(cfg.n_layers):
            p_i = tree_map(lambda a: a[i], lp)
            h = L.apply_norm(cfg, x, p_i["ln1"])
            q, k, v = L.qkv_project(cfg, p_i["attn"], h, positions,
                                    products=L.row_matmul_group, tp=tp)
            write(i, k, v, at)
            attn = attend(i, q)
            y = mm(attn.reshape(b, 1, q.shape[2] * q.shape[3]),
                   p_i["attn"]["wo"].to(x.dtype))
            x = x + L.reduced(y, tp, tp is not None and tp.attn)
            h2 = L.apply_norm(cfg, x, p_i["ln2"])
            if cfg.n_experts:
                y = M.apply_moe(
                    cfg, p_i["ffn"], h2,
                    path="dense" if cfg.n_experts <= 8 else "dispatch",
                    group_size=min(1024, b), router_matmul=mm,
                    experts=M.expert_matmul_rows, tp=tp)[0]
                split = tp is not None and tp.experts
            else:
                y = L.apply_mlp(cfg, p_i["ffn"], h2,
                                products=L.row_matmul_group, tp=tp)
                split = tp is not None and tp.mlp
            x = x + L.reduced(y, tp, split)
        x = L.apply_norm(cfg, x, params["final_norm"])
        return self._logits(params, x, tp, matmul=mm)

    def decode_step(self, params, cache, batch, tp=None, cache_seq=None):
        """One token over a full-precision cache: batch = {'token': [B, 1],
        'pos': [B]}.  Writes the fresh K/V into ``cache`` in place (the
        reference returns an updated copy) and returns (logits [B, V],
        cache with ``len + 1``).  ``tp`` as in :meth:`prefill`: the cache
        holds this rank's KV heads where attention is split.
        ``cache_seq`` (``parallel.tensor_parallel.SequenceShards``): the
        cache is this rank's shard of the sequence; the owner of ``pos``
        writes and the shards' attention partials are merged
        (:func:`layers.decode_attend`)."""
        tok, pos = batch["token"], batch["pos"]
        x = L.embed_tokens(params["embed"], tok, getattr(torch,
                                                         self.cfg.dtype), tp)
        kc, vc = cache["k"], cache["v"]
        rows = torch.arange(x.shape[0], device=x.device)
        where = dict(shards=cache_seq, tp=tp)

        def write(i, k, v, at):
            L.decode_write(kc[i], rows, pos, k[:, 0], **where)
            L.decode_write(vc[i], rows, pos, v[:, 0], **where)

        def attend(i, q):
            return L.decode_attend(q, kc[i], vc[i], pos + 1,
                                   window=self.cfg.sliding_window, **where)

        logits = self._decode_layers(params, x, pos, kc.shape[2], write,
                                     attend, tp)
        return logits, {**cache, "len": cache["len"] + 1}

    def decode_step_q(self, params, qcache, batch, *, b_kv: int):
        """One token straight over the quantized cache.

        ``qcache`` holds ``k_codes``/``v_codes`` [L, B, T, KV, dh] (int8
        codes for b_kv < 16, the raw float32 container otherwise),
        ``k_scales``/``v_scales`` [L, B, T, KV] f32 (ones for raw) and
        ``len``.  Each layer quantizes its fresh entry *before* writing it
        at ``pos`` (so this step reads it through the same dequant map as
        every later step), then attends through the
        ``quantized_decode_attention`` kernel with ``cache_len = pos + 1``.
        The cache tensors are updated in place (the reference donates
        them); returns (logits [B, V], qcache with ``len + 1``).
        """
        tok, pos = batch["token"], batch["pos"]
        x = L.embed_tokens(params["embed"], tok, getattr(torch,
                                                         self.cfg.dtype))
        kc, vc = qcache["k_codes"], qcache["v_codes"]
        ksc, vsc = qcache["k_scales"], qcache["v_scales"]
        rows = torch.arange(x.shape[0], device=x.device)
        lens = (pos + 1).to(torch.int32)

        def write(i, k, v, at):
            if b_kv < 16:
                k_new, ks_new = kv_quantize(k[:, 0], b_kv)
                v_new, vs_new = kv_quantize(v[:, 0], b_kv)
            else:
                k_new, v_new = k[:, 0], v[:, 0]
                # unit scales as a device tensor: a Python 1.0 would be
                # copied from the host at every call (and cannot be, under
                # a CUDA graph capture)
                ks_new = vs_new = torch.ones(k_new.shape[:-1],
                                             dtype=torch.float32,
                                             device=k_new.device)
            kc[i, rows, at] = k_new.to(kc.dtype)
            vc[i, rows, at] = v_new.to(vc.dtype)
            ksc[i, rows, at] = ks_new
            vsc[i, rows, at] = vs_new

        def attend(i, q):
            return self.decode_attend(q, kc[i], vc[i], ksc[i], vsc[i], lens)

        logits = self._decode_layers(params, x, pos, kc.shape[2], write,
                                     attend)
        return logits, {**qcache, "len": qcache["len"] + 1}

    def decode_attend(self, q, k_codes, v_codes, k_scales, v_scales,
                      cache_len):
        """One layer's attention over its quantized cache: the kernel."""
        return quantized_decode_attention(
            q, k_codes, v_codes, k_scales, v_scales, cache_len,
            window=self.cfg.sliding_window)
