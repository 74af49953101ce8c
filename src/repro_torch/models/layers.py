"""Neural net primitives of the dense decoder (``repro/models/layers.py``):
norms, RoPE, attention (the flash kernel on the card), MLP, embeddings and
the training losses.

Conventions kept from the reference so parameters cross unchanged:

* linear weights are ``[in, out]`` and applied as ``x @ W``; attention
  projections fuse heads into the last axis (``wq: [D, H*dh]``);
* layer-stacked parameters carry a leading ``[L, ...]`` axis;
* every ``init_*`` returns ``(params, axes)``, ``axes`` mirroring the
  parameter dict with tuples of logical axis names;
* norms and softmax accumulate in float32 whatever the compute dtype.

Initialization draws from an explicit ``torch.Generator`` on that
generator's device (``generator=None`` with ``device="meta"`` builds shapes
only).  The numbers differ from the reference's ``jax.random`` streams;
parity tests carry the reference's parameters across instead
(``repro_torch.bridge``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.bucketing import seq_bucket
from ..kernels.flash import flash_attention
from ..kernels.row_gemm import row_gemm, row_gemm_group


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def _randn(shape, generator, device):
    dev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=dev,
                       dtype=torch.float32)


def lead_shape(layers) -> tuple:
    """The leading stacked axes of a parameter: none for ``None``, one for
    an int, or a tuple as given (``(blocks, layers)`` in the recurrent and
    hybrid models)."""
    if layers is None:
        return ()
    return tuple(layers) if isinstance(layers, tuple) else (layers,)


def dense_init(generator, d_in: int, d_out: int, dtype, *,
               scale: Optional[float] = None, layers=None, device=None):
    """N(0, scale^2) ``[d_in, d_out]`` (``[*layers, d_in, d_out]`` stacked,
    ``layers`` an int or a tuple); ``scale`` defaults to ``d_in ** -0.5``."""
    scale = scale if scale is not None else d_in ** -0.5
    lead = lead_shape(layers)
    # scaled in place: no second copy of a large stack while drawing it
    return _randn(lead + (d_in, d_out), generator, device).mul_(scale).to(
        dtype)


def embed_init(generator, vocab: int, d: int, dtype, *, device=None):
    return (_randn((vocab, d), generator, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm in float32 through ``F.rms_norm``, which reduces each row on
    its own in an order set by the row's length alone (one block a row on
    the card), so a row's bits do not depend on how many rows share the
    call: the decode step's batched rows equal their rows alone.
    ``torch.mean`` over the last axis would not: on the card its reduction
    splits a row over fewer threads once more than 4 rows share it."""
    y = F.rms_norm(x.to(torch.float32), (x.shape[-1],),
                   scale.to(torch.float32), eps)
    return y.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in float32 through ``F.layer_norm``: each row reduced on
    its own, as in :func:`rmsnorm`."""
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],),
                     scale.to(torch.float32), bias.to(torch.float32), eps)
    return y.to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(cfg, d: int, *, device=None):
    if cfg.norm == "layernorm":
        return ({"scale": torch.ones((d,), device=device),
                 "bias": torch.zeros((d,), device=device)},
                {"scale": ("embed",), "bias": ("embed",)})
    return ({"scale": torch.ones((d,), device=device)}, {"scale": ("embed",)})


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    # theta stays a Python scalar: a 0-d device tensor would cost a
    # host-to-device copy that waits for the card on every call
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(theta, exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, dh]; positions: [B, S] (int)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)        # [dh/2]
    angles = positions[..., None].to(torch.float32) * freqs     # [B,S,dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg, generator, *, layers=None, device=None):
    """GQA projection params; ``layers`` (an int or a tuple of sizes) adds
    the leading stacked-layer axes."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = _dtype(cfg.param_dtype)

    def mk(i, o):
        return dense_init(generator, i, o, dt, layers=layers, device=device)
    p = {"wq": mk(d, qd), "wk": mk(d, kvd), "wv": mk(d, kvd),
         "wo": mk(qd, d)}
    lead = ("layers",) if layers is not None else ()
    ax = {"wq": lead + ("embed", "heads"), "wk": lead + ("embed", "kv"),
          "wv": lead + ("embed", "kv"), "wo": lead + ("heads", "embed")}
    if cfg.qkv_bias:
        dev = generator.device if generator is not None else device
        lshape = lead_shape(layers)
        p.update({n: torch.zeros(lshape + (w,), device=dev)
                  for n, w in (("bq", qd), ("bk", kvd), ("bv", kvd))})
        ax.update({"bq": lead + ("heads",), "bk": lead + ("kv",),
                   "bv": lead + ("kv",)})
    return p, ax


def matmul_group(x, ws, biases=None):
    """``[x @ w_i (+ b_i)]`` through ``torch.matmul``, one product each, then
    one add of its bias: the forward's and training's products."""
    ys = [torch.matmul(x, w) for w in ws]
    return ys if biases is None else [y + b for y, b in zip(ys, biases)]


def qkv_project(cfg, p, x, positions, products=matmul_group, tp=None):
    """x [B,S,D] -> q [B,S,H,dh], k/v [B,S,KV,dh] with RoPE applied.
    ``products(x, ws, biases)`` computes q, k and v (and adds their
    biases): :func:`matmul_group`, or the decode step's
    :func:`row_matmul_group`, one launch for the three.

    Under tensor-parallel attention (``tp.attn``) the weights are this
    rank's column shards, whole KV groups: the heads returned are its
    own, ``H / model`` and ``KV / model`` of them."""
    if tp is not None and tp.attn:
        x = tp.copy(x)
        cfg = tp.attn_cfg(cfg)
    biases = ([p[b].to(x.dtype) for b in ("bq", "bk", "bv")]
              if cfg.qkv_bias else None)
    q, k, v = products(x, [p[n].to(x.dtype) for n in ("wq", "wk", "wv")],
                       biases)
    return _heads_rope(cfg, q, k, v, positions)


def _heads_rope(cfg, q, k, v, positions):
    q = q.reshape(q.shape[:-1] + (cfg.n_heads, cfg.head_dim))
    k = k.reshape(k.shape[:-1] + (cfg.n_kv_heads, cfg.head_dim))
    v = v.reshape(v.shape[:-1] + (cfg.n_kv_heads, cfg.head_dim))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool, q_block: int = 512,
                        kv_block: int = 512, window: int = 0):
    """Memory-bounded attention via online softmax over blocks.

    q: [B, S, H, dh]; k, v: [B, T, KV, dh] with H = KV * G (GQA).

    Anywhere but on the CPU this is one call of
    :func:`kernels.flash.flash_attention` (differentiable): one launch of
    the flash kernel on a CUDA tensor, reading the [B, S, H, dh]
    activations in place, and an error on any other device.

    On a CPU tensor, plain torch with the reference's einsums: loops over
    KV blocks inside a loop over Q blocks, carrying the running (max, sum,
    acc) of the streaming softmax; ``window`` > 0 adds a sliding-window mask.  Block sizes snap
    to the geometric sequence ladder (``seq_bucket``), never to the raw
    S/T, so right-padding inside a bucket partitions the sequence into
    the same blocks and masked lanes contribute exact zeros.  The keys
    padded onto the last block are masked whether or not the attention is
    causal (the reference masks them only through the causal mask).
    """
    if q.device.type != "cpu":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal, window)
        return out.transpose(1, 2)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_block = min(q_block, seq_bucket(S))
    kv_block = min(kv_block, seq_bucket(T))
    nq = -(-S // q_block)
    nk = -(-T // kv_block)
    Sp, Tp = nq * q_block, nk * kv_block
    dev = q.device
    q_positions = torch.arange(S, device=dev).expand(B, S)
    kv_positions = torch.arange(T, device=dev).expand(B, T)

    scale = dh ** -0.5
    qs = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    ks = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
    vs = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
    qpos = F.pad(q_positions, (0, Sp - S), value=-1)
    kpos = F.pad(kv_positions, (0, Tp - T), value=2 ** 30)

    qs = qs.reshape(B, nq, q_block, KV, G, dh)
    ks = ks.reshape(B, nk, kv_block, KV, dh)
    vs = vs.reshape(B, nk, kv_block, KV, dh)
    qpos = qpos.reshape(B, nq, q_block)
    kpos = kpos.reshape(B, nk, kv_block)
    kreal = (torch.arange(Tp, device=dev) < T).reshape(nk, kv_block)

    # masks fill with Python scalars (no host-to-device copies in the loop)
    outs = []
    for i in range(nq):
        qb, qp = qs[:, i], qpos[:, i]
        m = torch.full((B, KV, G, q_block), -torch.inf, device=dev)
        l = torch.zeros((B, KV, G, q_block), device=dev)
        acc = torch.zeros((B, KV, G, q_block, dh), device=dev)
        for j in range(nk):
            kb, vb, kp = ks[:, j], vs[:, j], kpos[:, j]
            s = torch.einsum("bqkgd,btkd->bkgqt", qb.to(torch.float32),
                             kb.to(torch.float32)) * scale
            mask = kreal[j].expand(B, 1, 1, q_block, kv_block)
            if causal:
                mask = mask & (qp[:, None, None, :, None]
                               >= kp[:, None, None, None, :])
            if window > 0:
                mask = mask & ((qp[:, None, None, :, None]
                                - kp[:, None, None, None, :]) < window)
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            pexp = torch.exp(s - m_safe[..., None])
            pexp = torch.where(mask, pexp, 0.0)
            finite = torch.isfinite(m)
            corr = torch.exp(torch.where(finite, m - m_safe, -torch.inf))
            corr = torch.where(finite, corr, 0.0)
            l = l * corr + torch.sum(pexp, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", pexp.to(vb.dtype).to(torch.float32),
                vb.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                 # [B, KV, G, qb, dh]
    out = torch.stack(outs, dim=1)                   # [B, nq, KV, G, qb, dh]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sp, H, dh)
    return out[:, :S]


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-step attention against a full-precision cache (the plain
    decode step's; the engine attends the quantized cache through
    ``kernels.decode_attn``).

    q [B, 1, H, dh]; caches [B, T, KV, dh]; ``cache_len`` an int or [B]:
    entries >= it (and, with ``window``, before it - window) are masked.
    Dot products are elementwise products summed over one axis, so a
    row's bits do not depend on B.
    """
    B, _, H, dh = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, 1, dh).to(torch.float32)
    k = k_cache.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    v = v_cache.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    s = torch.sum(qr * k, dim=-1) * dh ** -0.5               # [B,KV,G,T]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    idx = torch.arange(T, device=q.device)
    valid = idx < lens
    if window > 0:
        valid = valid & (idx >= lens - window)
    p = torch.softmax(torch.where(valid, s, -torch.inf), dim=-1)
    out = torch.sum(p[..., None] * v, dim=-2)                # [B,KV,G,dh]
    return out.reshape(B, 1, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, generator, *, d_ff: Optional[int] = None, layers=None,
             device=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg.param_dtype)

    def mk(i, o):
        return dense_init(generator, i, o, dt, layers=layers, device=device)

    lead = ("layers",) if layers is not None else ()
    if cfg.act == "silu":  # SwiGLU
        p = {"wi_gate": mk(d, f), "wi_up": mk(d, f), "wo": mk(f, d)}
        ax = {"wi_gate": lead + ("embed", "ffn"),
              "wi_up": lead + ("embed", "ffn"), "wo": lead + ("ffn", "embed")}
    else:
        p = {"wi": mk(d, f), "wo": mk(f, d)}
        ax = {"wi": lead + ("embed", "ffn"), "wo": lead + ("ffn", "embed")}
    return p, ax


def activation(cfg, h):
    """The MLP nonlinearity: SiLU, or jax.nn.gelu's tanh approximation."""
    if cfg.act == "silu":
        return F.silu(h)
    return F.gelu(h, approximate="tanh")


def apply_mlp(cfg, p, x, products=matmul_group, tp=None):
    """The MLP; ``products`` as in :func:`qkv_project` (gate and up share
    one call).  Under a tensor-parallel MLP (``tp.mlp``) the weights are
    this rank's column (``wi*``) and row (``wo``) shards and the result is
    its partial sum, for the caller to reduce over ``model``."""
    if tp is not None and tp.mlp:
        x = tp.copy(x)
    if cfg.act == "silu":
        g, u = products(x, [p["wi_gate"].to(x.dtype),
                            p["wi_up"].to(x.dtype)])
        h = F.silu(g) * u
    else:
        h = activation(cfg, products(x, [p["wi"].to(x.dtype)])[0])
    return products(h, [p["wo"].to(x.dtype)])[0]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(cfg, generator, *, device=None):
    dt = _dtype(cfg.param_dtype)
    p = {"tok": embed_init(generator, cfg.vocab_size, cfg.d_model, dt,
                           device=device)}
    ax = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt,
                                  scale=cfg.d_model ** -0.5, device=device)
        ax["unembed"] = ("embed", "vocab")
    return p, ax


def embed_tokens(p, tokens, dtype, tp=None):
    """The token embeddings.  Vocabulary-parallel (``tp.vocab``): ``tok``
    holds this rank's rows; each rank looks up the tokens in its range,
    zeros the others and the ranks' rows are summed, which adds one
    nonzero term to zeros (exact)."""
    if tp is None or not tp.vocab:
        return p["tok"].to(dtype)[tokens]
    tok = p["tok"].to(dtype)
    local = tokens - tp.offset(tok.shape[0])
    mine = (local >= 0) & (local < tok.shape[0])
    rows = tok[torch.where(mine, local, torch.zeros_like(local))]
    return tp.reduce(torch.where(mine[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype)))


def unembed(cfg, p, x, matmul=torch.matmul, tp=None):
    """The head's logits; vocabulary-parallel (``tp.vocab``), this rank's
    columns of them."""
    if tp is not None and tp.vocab:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        return matmul(x, p["tok"].to(x.dtype).T)
    return matmul(x, p["unembed"].to(x.dtype))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _lse_label(logits, labels, tp=None):
    """(logsumexp, the label's logit) over the last axis of f32 logits.
    Vocabulary-parallel (``tp.vocab``), ``logits`` are this rank's
    columns: the max is reduced (no gradient: it cancels), then the sum
    of exponentials, and the label's logit comes from the rank that holds
    it (the others add zero)."""
    if tp is None or not tp.vocab:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None].long())[..., 0])
    mx = tp.all_max(torch.amax(logits, dim=-1))
    total = tp.reduce(torch.sum(torch.exp(logits - mx[..., None]), dim=-1))
    local = labels.long() - tp.offset(logits.shape[-1])
    mine = (local >= 0) & (local < logits.shape[-1])
    ll = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    return torch.log(total) + mx, tp.reduce(torch.where(mine, ll, 0.0))


def softmax_cross_entropy(logits, labels, mask=None, tp=None):
    """Mean next-token CE in float32.  logits [..., V] (vocabulary-parallel
    under ``tp.vocab``: this rank's columns), labels [...] int."""
    lse, ll = _lse_label(logits.to(torch.float32), labels, tp)
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def chunked_cross_entropy(cfg, x, embed_params, labels, mask=None,
                          chunk: int = 256, tp=None):
    """CE from final *hidden states* with sequence-chunked unembedding.

    The [B, S, V] logits dominate a training step's temporary memory at
    large vocabularies, so for S a multiple of ``chunk`` (and longer) the
    unembedding and logsumexp run per sequence chunk under
    ``torch.utils.checkpoint``: backward recomputes each chunk's logits,
    and only one chunk's are ever live.  x [B, S, D] (final-normed),
    labels [B, S], mask [B, S] or None; returns the mean NLL (masked mean
    when a mask is given).  Vocabulary-parallel under ``tp.vocab``: each
    chunk's logits are this rank's columns (:func:`_lse_label`).
    """
    b, s, _ = x.shape
    if s <= chunk or s % chunk != 0:
        return softmax_cross_entropy(unembed(cfg, embed_params, x, tp=tp),
                                     labels, mask, tp)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)

    def one(xi, li, mi):
        logits = unembed(cfg, embed_params, xi, tp=tp).to(torch.float32)
        lse, ll = _lse_label(logits, li, tp)
        return torch.sum((lse - ll) * mi)

    tot = x.new_zeros((), dtype=torch.float32)
    for c in range(0, s, chunk):
        sl = slice(c, c + chunk)
        tot = tot + checkpoint(one, x[:, sl], labels[:, sl], mask[:, sl],
                               use_reentrant=False)
    return tot / torch.clamp(torch.sum(mask), min=1.0)


def row_matmul(x, w):
    """``x [..., K] @ w [K, N]`` with each row (every leading index) its own
    product: :func:`kernels.row_gemm.row_gemm`.

    BLAS libraries take another kernel, summing in another order, for a
    single row than for several (a gemv at M = 1 and a gemm at M >= 2 on
    the CPU; cuBLAS chooses by shape too).  The decode step runs its
    projections and head through this, so a row's bits do not depend on
    how many rows share the step: the engine's batched decode equals the
    batch-1 reference bit for bit.  On the card that is one launch of the
    row-independent GEMM kernel per product (float32, any number of rows);
    on the CPU one BLAS product per row.
    """
    y = row_gemm(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def row_matmul_group(x, ws, biases=None):
    """``[x [..., K] @ w_i (+ b_i)]`` for products of one x, each row its
    own: :func:`kernels.row_gemm.row_gemm_group`, one launch on the card,
    each output bitwise :func:`row_matmul`'s followed by the bias add."""
    ys = row_gemm_group(x.reshape(-1, x.shape[-1]), ws, biases)
    return [y.reshape(x.shape[:-1] + (w.shape[-1],))
            for y, w in zip(ys, ws)]
