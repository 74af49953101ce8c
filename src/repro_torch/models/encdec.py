"""Encoder-decoder transformer (``repro/models/encdec.py``; the
SeamlessM4T-v2 backbone's shape).

The modality frontend is a stub, as in the reference: the encoder's input
is precomputed frame embeddings ``batch["embeds"]`` [B, S_enc, D], which
it attends bidirectionally.  The decoder is a causal transformer with
cross-attention to per-layer K/V projected from the encoder's output
(:meth:`EncDecModel._cross_kv`; no RoPE on the cross side).  The parameter
dict is the reference's::

    {"embed": {...},
     "enc": {"attn": {...: [L_enc, ...]}, "mlp": {...}, "ln": [L_enc, 2, D]},
     "dec": {"attn", "cross", "mlp": {...: [L, ...]}, "ln": [L, 3, D]},
     "final_norm": {...}, "enc_norm": [D]}

Every full-sequence attention (the encoder's, the decoder's causal
self-attention and its cross-attention, S_dec != T_enc in general) goes
through :meth:`attend`: one flash-kernel launch each on the card
(:func:`layers.blockwise_attention`), 3 x 24 a forward at
seamless-m4t-large-v2's depth.  The decode step attends its caches with
the plain :func:`layers.decode_attention`, as the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .lm import input_specs_of, refuse_quantized, tree_map, unstack_layers


class EncDecModel:
    def __init__(self, cfg):
        if cfg.n_enc_layers <= 0:
            raise ValueError("EncDecModel needs n_enc_layers > 0")
        self.cfg = cfg
        self._axes = None

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _build(self, generator: Optional[torch.Generator], device=None):
        cfg = self.cfg
        dev = generator.device if generator is not None else device
        ne, nd = cfg.n_enc_layers, cfg.n_layers
        emb_p, emb_ax = L.init_embeddings(cfg, generator, device=dev)
        enc_attn_p, enc_attn_ax = L.init_attention(cfg, generator, layers=ne,
                                                   device=dev)
        enc_mlp_p, enc_mlp_ax = L.init_mlp(cfg, generator, layers=ne,
                                           device=dev)
        dec_attn_p, dec_attn_ax = L.init_attention(cfg, generator, layers=nd,
                                                   device=dev)
        dec_x_p, dec_x_ax = L.init_attention(cfg, generator, layers=nd,
                                             device=dev)
        dec_mlp_p, dec_mlp_ax = L.init_mlp(cfg, generator, layers=nd,
                                           device=dev)
        lnf_p, lnf_ax = L.init_norm(cfg, cfg.d_model, device=dev)
        params = {"embed": emb_p,
                  "enc": {"attn": enc_attn_p, "mlp": enc_mlp_p,
                          "ln": torch.ones((ne, 2, cfg.d_model), device=dev)},
                  "dec": {"attn": dec_attn_p, "cross": dec_x_p,
                          "mlp": dec_mlp_p,
                          "ln": torch.ones((nd, 3, cfg.d_model), device=dev)},
                  "final_norm": lnf_p,
                  "enc_norm": torch.ones((cfg.d_model,), device=dev)}
        self._axes = {"embed": emb_ax,
                      "enc": {"attn": enc_attn_ax, "mlp": enc_mlp_ax,
                              "ln": ("layers", "ln_idx", "embed")},
                      "dec": {"attn": dec_attn_ax, "cross": dec_x_ax,
                              "mlp": dec_mlp_ax,
                              "ln": ("layers", "ln_idx", "embed")},
                      "final_norm": lnf_ax, "enc_norm": ("embed",)}
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
    def attend(self, q, k, v, causal: bool):
        """Full-sequence attention, q [B, S, H, dh], k/v [B, T, KV, dh]:
        one flash-kernel launch on the card."""
        return L.blockwise_attention(q, k, v, causal=causal)

    def _enc_block(self, lp, x, positions):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        h = L.rmsnorm(x, lp["ln"][0])
        q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
        attn = self.attend(q, k, v, causal=False)
        x = x + attn.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"].to(x.dtype)
        h2 = L.rmsnorm(x, lp["ln"][1])
        return x + L.apply_mlp(cfg, lp["mlp"], h2)

    def encode(self, params, embeds, remat: bool = False):
        """The encoder over the frame embeddings [B, S_enc, D]."""
        cfg = self.cfg
        x = embeds.to(getattr(torch, cfg.dtype))
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in unstack_layers(params["enc"], cfg.n_enc_layers):
            if remat:
                x = checkpoint(self._enc_block, lp, x, positions,
                               use_reentrant=False)
            else:
                x = self._enc_block(lp, x, positions)
        return L.rmsnorm(x, params["enc_norm"])

    def _dec_block(self, lp, x, positions, enc_kv, self_kv=None, pos=None):
        """One decoder layer; returns (x, the self-attention's (k, v)).
        The full-sequence pass gives ``enc_kv`` = the layer's cross (k,
        v); a decode step also passes its ``self_kv`` caches, written in
        place at ``pos``."""
        cfg = self.cfg
        b = x.shape[0]
        h = L.rmsnorm(x, lp["ln"][0])
        q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
        if self_kv is None:
            attn = self.attend(q, k, v, causal=True)
            new_self = (k, v)
        else:
            kc, vc = self_kv
            rows = torch.arange(b, device=x.device)
            at = torch.clamp(pos, max=kc.shape[1] - 1)
            kc[rows, at] = k[:, 0].to(kc.dtype)
            vc[rows, at] = v[:, 0].to(vc.dtype)
            attn = L.decode_attention(q, kc, vc, pos + 1)
            new_self = (kc, vc)
        x = x + attn.reshape(x.shape[:2] + (cfg.q_dim,)) \
            @ lp["attn"]["wo"].to(x.dtype)
        # cross-attention: the keys are already projected, no RoPE
        h2 = L.rmsnorm(x, lp["ln"][1])
        qx = (h2 @ lp["cross"]["wq"].to(x.dtype)).reshape(
            x.shape[:2] + (cfg.n_heads, cfg.head_dim))
        ek, ev = enc_kv
        if self_kv is None:
            cross = self.attend(qx, ek, ev, causal=False)
        else:
            cross = L.decode_attention(qx, ek, ev, ek.shape[1])
        x = x + cross.reshape(x.shape[:2] + (cfg.q_dim,)) \
            @ lp["cross"]["wo"].to(x.dtype)
        h3 = L.rmsnorm(x, lp["ln"][2])
        return x + L.apply_mlp(cfg, lp["mlp"], h3), new_self

    def _cross_kv(self, params, enc_out):
        """Per-decoder-layer cross K/V from the encoder output:
        ([L, B, S_enc, KV, dh], same)."""
        cfg = self.cfg
        b, s = enc_out.shape[0], enc_out.shape[1]
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
        cross = params["dec"]["cross"]
        ek = torch.stack([(enc_out @ w.to(enc_out.dtype)).reshape(shape)
                          for w in cross["wk"].unbind(0)])
        ev = torch.stack([(enc_out @ w.to(enc_out.dtype)).reshape(shape)
                          for w in cross["wv"].unbind(0)])
        return ek, ev

    def _dec_block_train(self, lp, x, positions, k, v):
        return self._dec_block(lp, x, positions, (k, v))[0]

    def _hidden(self, params, batch, remat: bool = False):
        cfg = self.cfg
        refuse_quantized(cfg, params)
        enc_out = self.encode(params, batch["embeds"], remat)
        ek, ev = self._cross_kv(params, enc_out)
        x = L.embed_tokens(params["embed"], batch["tokens"],
                           getattr(torch, cfg.dtype))
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        layers = unstack_layers(params["dec"], cfg.n_layers)
        for lp, k, v in zip(layers, ek.unbind(0), ev.unbind(0)):
            if remat:
                x = checkpoint(self._dec_block_train, lp, x, positions, k, v,
                               use_reentrant=False)
            else:
                x = self._dec_block_train(lp, x, positions, k, v)
        return L.apply_norm(cfg, x, params["final_norm"])

    def forward(self, params, batch):
        """(logits [B, S_dec, V], aux = 0.0); batch = {'embeds', 'tokens'}."""
        x = self._hidden(params, batch)
        return L.unembed(self.cfg, params["embed"], x), 0.0

    def loss(self, params, batch, *, remat: bool = False):
        """Mean next-token CE of ``batch["labels"]`` (chunked
        unembedding); ``remat`` recomputes each layer in the backward
        pass."""
        x = self._hidden(params, batch, remat)
        return L.chunked_cross_entropy(self.cfg, x, params["embed"],
                                       batch["labels"])

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        """Zero self and cross caches, each [L, B, max(max_len // 2, 1),
        KV, dh]: the reference's cells give half the length to the
        encoder's frames and half to the decoder's tokens."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        half = max(max_len // 2, 1)
        kvs = (cfg.n_layers, batch, half, cfg.n_kv_heads, cfg.head_dim)
        cache = {n: torch.zeros(kvs, dtype=dt, device=device)
                 for n in ("k", "v", "ek", "ev")}
        cache["len"] = torch.zeros((batch,), dtype=torch.int32,
                                   device=device)
        return cache

    def cache_axes(self):
        t = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": t, "v": t, "ek": t, "ev": t, "len": ("batch",)}

    def input_specs(self, shape):
        """The batch of a dry-run cell as ``meta`` tensors: half the
        sequence is frame embeddings, half tokens."""
        half = shape.seq_len // 2
        return input_specs_of(shape, text=half,
                              embeds=(half, self.cfg.d_model,
                                      getattr(torch, self.cfg.dtype)))

    def cache_specs(self, shape):
        """The cache of a dry-run decode cell as ``meta`` tensors."""
        return self.init_cache(shape.global_batch, shape.seq_len,
                               device="meta")

    def prefill(self, params, batch):
        """(logits at the last position [B, V], cache): the decoder's
        self K/V over the prompt and the cross K/V of the encoded
        frames."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        enc_out = self.encode(params, batch["embeds"])
        ek, ev = self._cross_kv(params, enc_out)
        x = L.embed_tokens(params["embed"], batch["tokens"], dt)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        ks, vs = [], []
        layers = unstack_layers(params["dec"], cfg.n_layers)
        for lp, k, v in zip(layers, ek.unbind(0), ev.unbind(0)):
            x, (sk, sv) = self._dec_block(lp, x, positions, (k, v))
            ks.append(sk.to(dt))
            vs.append(sv.to(dt))
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed(cfg, params["embed"], x[:, -1:])[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "ek": ek.to(dt), "ev": ev.to(dt),
                        "len": torch.full((b,), s, dtype=torch.int32,
                                          device=x.device)}

    def decode_step(self, params, cache, batch):
        """One token: batch = {'token': [B, 1], 'pos': [B]}.  Writes the
        fresh self K/V into ``cache`` in place (the reference returns an
        updated copy); returns (logits [B, V], cache with ``len + 1``)."""
        cfg = self.cfg
        tok, pos = batch["token"], batch["pos"]
        x = L.embed_tokens(params["embed"], tok, getattr(torch, cfg.dtype))
        positions = pos[:, None]
        for i in range(cfg.n_layers):
            lp = tree_map(lambda a: a[i], params["dec"])
            x, _ = self._dec_block(lp, x, positions,
                                   (cache["ek"][i], cache["ev"][i]),
                                   self_kv=(cache["k"][i], cache["v"][i]),
                                   pos=pos)
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.unembed(cfg, params["embed"], x)[:, 0]
        return logits, {**cache, "len": cache["len"] + 1}
