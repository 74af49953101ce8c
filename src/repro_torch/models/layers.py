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

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.bucketing import seq_bucket
from ..kernels.build import LIB, kernel_op
from ..kernels.flash import MAX_HEAD_DIM, flash_attention, \
    flash_attention_fwd
from ..kernels.row_gemm import row_gemm, row_gemm_group
from ..launch.opcount import note_flops
from ..parallel import sharding as _shctx

Axes = Any  # nested dicts of tuples of logical axis names


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
    splits a row over fewer threads once more than 4 rows share it.

    Off the CPU it is the op ``repro_norm::rms_norm`` (:func:`_fused_rms`),
    the card's one fused kernel and its backward, so that the accountant
    bills one op on the card and on ``meta`` alike."""
    xf, sf = x.to(torch.float32), scale.to(torch.float32)
    if x.device.type == "cpu":
        y = F.rms_norm(xf, (x.shape[-1],), sf, eps)
    else:
        y = _rms_norm_op(xf, sf, float(eps))[0]
    return y.to(x.dtype)


# ``F.rms_norm`` is one op on the card (``aten._fused_rms_norm``, and
# ``aten._fused_rms_norm_backward`` in the backward pass) but decomposes into
# five on ``meta`` tensors and under a dispatch mode, so the dry-run's
# accountant billed more bytes than the card moves.  Wrapped in an op of its
# own, each direction is one op on every device but the CPU; on the card
# the op runs exactly the aten kernels ``F.rms_norm`` runs there (the same
# bits).  Its namespace is not ``repro_torch``: it is no kernel of the
# port's, and the accountant's ``kernel_calls`` do not count it.
_NORM_LIB = torch.library.Library("repro_norm", "DEF")
_NORM_LIB.define("rms_norm(Tensor x, Tensor scale, float eps) "
                 "-> (Tensor, Tensor)")
_NORM_LIB.define("rms_norm_backward(Tensor g, Tensor x, Tensor rstd, "
                 "Tensor scale) -> (Tensor, Tensor)")


def _fused_rms(x, scale, eps):
    """(y, rstd [..., 1]) of the card's fused RMSNorm over the last axis."""
    return torch.ops.aten._fused_rms_norm(x, [x.shape[-1]], scale, eps)


def _fused_rms_bwd(g, x, rstd, scale):
    return torch.ops.aten._fused_rms_norm_backward(
        g, x, [x.shape[-1]], rstd, scale, [True, True])


_NORM_LIB.impl("rms_norm", _fused_rms, "CUDA")
_NORM_LIB.impl("rms_norm_backward", _fused_rms_bwd, "CUDA")


@torch.library.register_fake("repro_norm::rms_norm", lib=_NORM_LIB)
def _fused_rms_fake(x, scale, eps):
    return (torch.empty_like(x),
            x.new_empty(x.shape[:-1] + (1,), dtype=torch.float32))


@torch.library.register_fake("repro_norm::rms_norm_backward", lib=_NORM_LIB)
def _fused_rms_bwd_fake(g, x, rstd, scale):
    return torch.empty_like(x), torch.empty_like(scale)


def _rms_setup(ctx, inputs, output):
    x, scale, _ = inputs
    ctx.save_for_backward(x, output[1], scale)
    ctx.set_materialize_grads(False)     # rstd's gradient stays None


def _rms_backward(ctx, g, _g_rstd):
    x, rstd, scale = ctx.saved_tensors
    dx, dscale = _rms_norm_bwd_op(g, x, rstd, scale)
    return dx, dscale, None


torch.library.register_autograd("repro_norm::rms_norm", _rms_backward,
                                setup_context=_rms_setup, lib=_NORM_LIB)
_rms_norm_op = torch.ops.repro_norm.rms_norm.default
_rms_norm_bwd_op = torch.ops.repro_norm.rms_norm_backward.default


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
                        kv_block: int = 512, window: int = 0,
                        q_offset: int = 0):
    """Memory-bounded attention via online softmax over blocks.

    q: [B, S, H, dh]; k, v: [B, T, KV, dh] with H = KV * G (GQA).

    Anywhere but on the CPU this is one call of
    :func:`kernels.flash.flash_attention` (differentiable): one launch of
    the flash kernel on a CUDA tensor, reading the [B, S, H, dh]
    activations in place, and an error on any other device.

    On a CPU tensor, plain torch with the reference's einsums: loops over
    KV blocks inside a loop over Q blocks, carrying the running (max, sum,
    acc) of the streaming softmax; ``window`` > 0 adds a sliding-window
    mask.  Under ``parallel.sharding.flash_attention_mode`` it is
    :func:`fused_attention_acct` instead.  Block sizes snap
    to the geometric sequence ladder (``seq_bucket``), never to the raw
    S/T, so right-padding inside a bucket partitions the sequence into
    the same blocks and masked lanes contribute exact zeros.  The keys
    padded onto the last block are masked whether or not the attention is
    causal (the reference masks them only through the causal mask).

    ``q_offset``: query row r sits at position ``q_offset + r`` for the
    causal and window masks, a sequence chunk's queries against the whole
    sequence's keys (sequence-parallel attention; the kernel takes the
    offset).
    """
    if _shctx.flash_mesh() is not None:
        return fused_attention_acct(q, k, v, causal=causal, window=window,
                                    mesh=_shctx.flash_mesh(),
                                    q_offset=q_offset)
    if q.device.type != "cpu":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal, window, q_offset)
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
    q_positions = (q_offset + torch.arange(S, device=dev)).expand(B, S)
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
    row's bits do not depend on B.  Under
    ``parallel.sharding.flash_attention_mode`` it is
    :func:`fused_decode_attention_acct` instead.
    """
    if _shctx.flash_mesh() is not None:
        return fused_decode_attention_acct(q, k_cache, v_cache, cache_len,
                                           window=window,
                                           mesh=_shctx.flash_mesh())
    B, _, H, dh = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    # the reference's two einsums, 2 B H T dh each (the census cannot see
    # products computed as multiplies and sums)
    note_flops(4 * B * H * T * dh, dots=2)
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
# Fused attention with the fused kernel's accounting (the dry-run's path)
# ---------------------------------------------------------------------------
# The reference runs these bodies on the host inside ``pure_callback``s so
# that its compiled program shows one custom-call a layer with the fused
# kernel's operands and results.  Here each is one custom op of its own,
# with no FLOP formula: the accountant bills its operands and results as
# the kernel's HBM traffic and leaves its products to the roofline's
# analytic attention term, as the reference's census does.

def _attention_fwd_host(q, k, v, causal: bool, window: int,
                        q_offset: int = -1):
    """Plain GQA attention: q [B,S,H,dh], k/v [B,T,KV,dh] -> (out
    [B,S,H,dh], p [B,H,S,T]) in float32 (p is reused by the backward).
    Query row r sits at position ``q_offset + r`` for the masks; -1 (the
    default): a causal mask is right-aligned when T > S."""
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    ke = torch.repeat_interleave(k, G, dim=2)
    ve = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, ke) * dh ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    qpos = qpos + (T - S if q_offset < 0 else q_offset)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask, s, -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhst,bthd->bshd", p, ve), p


def _naive_attention_host(causal: bool, window: int, q, k, v,
                          q_offset: int = -1):
    """The accounting op's plain body: the attention in q's dtype."""
    return _attention_fwd_host(q, k, v, causal, window,
                               q_offset)[0].to(q.dtype)


def _attention_bwd_host(causal: bool, window: int, q, k, v, g,
                        q_offset: int = -1):
    """Plain attention backward: (q, k, v, dout) -> (dq, dk, dv), the
    gradients of the KV heads summed over the query heads sharing each."""
    qf, kf, vf, gf = (x.to(torch.float32) for x in (q, k, v, g))
    B, S, H, dh = qf.shape
    KV = kf.shape[2]
    G = H // KV
    _, p = _attention_fwd_host(qf, kf, vf, causal, window,
                               q_offset)                       # [B,H,S,T]
    ve = torch.repeat_interleave(vf, G, dim=2)
    dv_e = torch.einsum("bhst,bshd->bthd", p, gf)             # [B,T,H,dh]
    dp = torch.einsum("bshd,bthd->bhst", gf, ve)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    scale = dh ** -0.5
    ke = torch.repeat_interleave(kf, G, dim=2)
    dq = torch.einsum("bhst,bthd->bshd", ds, ke) * scale
    dk_e = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dk = dk_e.reshape(B, -1, KV, G, dh).sum(dim=3)
    dv = dv_e.reshape(B, -1, KV, G, dh).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fused_checks(q, k, v, causal: bool, q_offset: int = -1) -> None:
    """What the flash kernel refuses of CUDA operands in the model's
    layout (the accounting op's real and fake versions both run it)."""
    if q.device.type == "cpu":
        return
    if causal and q_offset < 0 and q.shape[1] != k.shape[1]:
        raise ValueError("the flash kernel's causal mask is not "
                         "right-aligned: causal attention needs S == T "
                         "or a query offset")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def _fused_impl(q, k, v, causal, window, q_offset=-1):
    _fused_checks(q, k, v, causal, q_offset)
    if q.device.type == "cpu":
        return _naive_attention_host(causal, window, q, k, v,
                                     q_offset).contiguous()
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, q_offset=max(q_offset, 0))
    return out.transpose(1, 2).contiguous()


def _fused_fake(q, k, v, causal, window, q_offset=-1):
    _fused_checks(q, k, v, causal, q_offset)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


_fused_attention_op = kernel_op(
    "fused_attention_acct",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, "
    "int q_offset=-1) -> Tensor", _fused_impl, _fused_fake)


def _fused_bwd_impl(q, k, v, g, causal, window, q_offset=-1):
    return [t.contiguous() for t in _attention_bwd_host(
        causal, window, q, k, v, g, q_offset)]


def _fused_bwd_fake(q, k, v, g, causal, window, q_offset=-1):
    return [torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for x in (q, k, v)]


_fused_attention_bwd_op = kernel_op(
    "fused_attention_acct_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor g, bool causal, int window, "
    "int q_offset=-1) -> Tensor[]", _fused_bwd_impl, _fused_bwd_fake)


def _fused_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs[:5]
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window
    ctx.q_offset = inputs[5] if len(inputs) > 5 else -1


def _fused_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _fused_attention_bwd_op(q, k, v, g.contiguous(),
                                         ctx.causal, ctx.window,
                                         ctx.q_offset)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("repro_torch::fused_attention_acct",
                                _fused_backward, setup_context=_fused_setup,
                                lib=LIB)


def fused_attention_acct(q, k, v, *, causal: bool, window: int = 0, mesh,
                         q_offset: int = -1):
    """Flash attention with the fused kernel's HBM accounting (the
    dry-run's path): q [B, S, H, dh], k/v [B, T, KV, dh] -> [B, S, H, dh].

    One op a call (``repro_torch::fused_attention_acct``): on a CUDA
    tensor it launches the flash kernel once (counted), on a CPU tensor
    it runs the plain attention, under fake tensors it allocates and
    launches nothing.  Differentiable: its backward is a second op,
    (q, k, v, dout) -> (dq, dk, dv), the flash backward's interface
    (plain torch on any device; the port has no backward kernel).

    The operands are this rank's already: the reference picks its own
    head layout inside a ``shard_map`` (KV heads split, or q heads split
    over replicated KV heads, or replicated); the port runs
    ``parallel.tensor_parallel.decoder_plan``'s, which splits attention
    only by whole KV groups, so a rank never holds q heads without their
    KV heads and no gradient sum over ``model`` is needed.  ``mesh`` is
    the accounting context's (:func:`parallel.sharding.flash_mesh`).
    ``q_offset``: query row r at position ``q_offset + r`` for the masks
    (a sequence chunk's queries); -1: a causal mask right-aligned.
    """
    del mesh
    return _fused_attention_op(q, k, v, causal, window, q_offset)


def _decode_partials_host(window: int, q, k, v, cache_len, offset):
    """Flash-decoding partials of one cache shard: unnormalized (acc [B, 1,
    KV, G, dh], m [B, KV, G, 1], l [B, KV, G, 1]) over the shard's
    positions [offset, offset + T_s), float32."""
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    B, _, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, 1, KV, G, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qr, k) * dh ** -0.5
    gidx = torch.as_tensor(offset, device=q.device).reshape(-1, 1) \
        + torch.arange(T, device=q.device)[None, :]
    ln = cache_len.reshape(-1, 1)
    valid = gidx < ln
    if window > 0:
        valid = valid & (gidx >= ln - window)
    valid = valid[:, None, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    m = torch.amax(s, dim=-1)                                 # [B,KV,G,1]
    msafe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(s - msafe[..., None]), 0.0)
    return (torch.einsum("bkgqt,btkd->bqkgd", p, v), m,
            torch.sum(p, dim=-1))


def _decode_impl(q, k, v, lens, offset, window):
    return [t.contiguous()
            for t in _decode_partials_host(window, q, k, v, lens, offset)]


def _decode_fake(q, k, v, lens, offset, window):
    B, _, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = dict(dtype=torch.float32, device=q.device)
    return [torch.empty((B, 1, KV, G, dh), **f32),
            torch.empty((B, KV, G, 1), **f32),
            torch.empty((B, KV, G, 1), **f32)]


_fused_decode_op = kernel_op(
    "fused_decode_attention_acct",
    "(Tensor q, Tensor k, Tensor v, Tensor lens, int offset, int window) "
    "-> Tensor[]", _decode_impl, _decode_fake)


def fused_decode_attention_acct(q, k_cache, v_cache, cache_len, *,
                                window: int, mesh, shards=None):
    """Flash-decoding with the fused kernel's accounting (the dry-run's
    path): q [B, 1, H, dh] over this rank's cache [B, T, KV, dh] ->
    [B, 1, H, dh].

    The cache is read once inside one op
    (``repro_torch::fused_decode_attention_acct``, plain torch on any
    device, nothing under fake tensors) that returns the unnormalized
    (acc, m, l) partials, then normalized.  ``shards`` (a
    ``parallel.tensor_parallel.SequenceShards``): the cache is this
    rank's shard of the sequence, the partials are over its global
    positions and merged over the shards' ranks, as the reference's
    ``cacheshard`` merge.  ``mesh`` is the accounting context's."""
    del mesh
    B, _, H, dh = q.shape
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1) \
        .expand(B).to(torch.int32)
    offset = 0 if shards is None else shards.offset
    acc, m, l = _fused_decode_op(q, k_cache, v_cache, lens, offset, window)
    if shards is not None:
        return shards.merge(acc, m, l).reshape(B, 1, H, dh).to(q.dtype)
    out = acc / torch.clamp(l[:, None], min=1e-30)
    return out.reshape(B, 1, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# A decode step's cache: whole along the sequence, or sequence-sharded
# ---------------------------------------------------------------------------

def _heads_gathered(tp, shards) -> bool:
    """Whether a decode step gathers its q, k and v heads over ``model``:
    attention computes on this rank's KV groups while the cache holds
    every KV head of this rank's positions (its sequence split over
    ``model``, which ``spec_for`` gives the axis before ``kv_heads``)."""
    return (shards is not None and tp is not None and tp.attn
            and "model" in shards.axes)


def decode_write(cache, rows, pos, new, *, shards=None, tp=None) -> None:
    """Store a decode step's fresh entry ``new`` [B, KV, dh] (this rank's
    KV heads under ``tp.attn``) at ``pos`` [B] of ``cache`` [B, T, KV,
    dh], in place.  Whole along the sequence: at ``pos`` clamped to the
    cache's last entry, as ``dynamic_update_slice`` clamps.  With
    ``shards``: on the rank that holds ``pos`` only
    (``SequenceShards.write``), every KV head of it."""
    if shards is None:
        at = torch.clamp(pos, max=cache.shape[1] - 1)
        cache[rows, at] = new.to(cache.dtype)
        return
    if _heads_gathered(tp, shards):
        new = tp.gather(new, 1)
    shards.write(cache, rows, pos, new)


def decode_attend(q, k_cache, v_cache, cache_len, *, window: int = 0,
                  shards=None, tp=None):
    """A decode step's attention, q [B, 1, H, dh] over its cache [B, T,
    KV, dh]: :func:`decode_attention` over a cache whole along the
    sequence; with ``shards`` flash-decoding partials over this rank's
    global positions merged over the shards' ranks
    (``SequenceShards.merge``; the fused accounting op's partials under
    ``flash_attention_mode``).  Where the cache's sequence is split over
    ``model`` and attention over KV groups (:func:`_heads_gathered`), q
    is gathered over ``model``, the partials cover every head and this
    rank keeps its own heads of the merged result."""
    if shards is None:
        return decode_attention(q, k_cache, v_cache, cache_len,
                                window=window)
    gathered = _heads_gathered(tp, shards)
    if gathered:
        q = tp.gather(q, 2)
    B, _, H, dh = q.shape
    if _shctx.flash_mesh() is not None:
        out = fused_decode_attention_acct(q, k_cache, v_cache, cache_len,
                                          window=window,
                                          mesh=_shctx.flash_mesh(),
                                          shards=shards)
    else:
        lens = torch.as_tensor(cache_len, device=q.device).reshape(-1) \
            .expand(B).to(torch.int32)
        acc, m, l = _decode_partials_host(window, q, k_cache, v_cache, lens,
                                          shards.offset)
        out = shards.merge(acc, m, l).reshape(B, 1, H, dh).to(q.dtype)
    return out.chunk(tp.size, 2)[tp.rank] if gathered else out


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


def unembed_whole(cfg, p, x, matmul=torch.matmul, tp=None):
    """The head's logits over the whole vocabulary: :func:`unembed`, its
    vocabulary-sharded columns all-gathered under ``tp.vocab``."""
    logits = unembed(cfg, p, x, matmul=matmul, tp=tp)
    if tp is not None and tp.vocab:
        logits = tp.gather(logits, -1)
    return logits


def reduced(y, tp, split: bool):
    """A block's output into the replicated residual: its partial sums
    all-reduced over ``model`` where the block computed ``split`` on its
    shards, else ``y`` as it is."""
    return tp.reduce(y) if tp is not None and split else y


# ---------------------------------------------------------------------------
# A residual held sequence-sharded over ``model`` (Megatron's sequence
# parallelism; ``parallel.sharding.sequence_sharded``)
# ---------------------------------------------------------------------------
# Every family's training stack (and the xLSTM's forward) keeps its residual
# as this rank's sequence chunk between blocks under the activation-sharding
# context.  A part that computes on its ``model`` shards, or whose work
# couples the sequence (a recurrence, MoE capacity queues), takes the chunk
# gathered whole (:func:`seq_enter`) and gives its output back as a chunk
# (:func:`seq_exit`).  A part that computes replicated and works token by
# token (norms, projections, the dense MLP, the head) runs on the chunk
# alone, its weights entering through ``tp.copy`` (:func:`seq_copied`): each
# rank's gradient is then its own positions' part, summed over ``model`` in
# the backward.  Attention of this kind gathers K and V
# (:func:`seq_attention`).

def seq_enter(x, tp, seq: bool):
    """The residual whole for a part that needs it: gathered over the
    sequence chunks under ``seq`` (chunk backward; the sharded products'
    inputs add their own all-reduce backward).  Under ``tp`` without
    ``seq``, a view: the norm's uses of its input then sum their
    gradients before the residual's is added, in the order the gather's
    backward sums them, so ``seq`` changes no bit."""
    if seq:
        return tp.gather(x, 1)
    return x if tp is None else x.view_as(x)


def seq_exit(y, tp, seq: bool, sharded: bool):
    """A part's output back into the residual's layout: partial sums
    (``sharded``) reduced, or reduce-scattered under ``seq``; a replicated
    result as it is, or its chunk under ``seq``."""
    if not seq:
        return reduced(y, tp, sharded)
    return tp.scatter(y, 1) if sharded else tp.split(y, 1)


def seq_copied(tree, tp):
    """Weights (a dict, or one tensor) used on this rank's sequence chunk
    alone: each through ``tp.copy`` (identity forward, their gradients
    summed over ``model``)."""
    if isinstance(tree, dict):
        return {k: seq_copied(v, tp) for k, v in tree.items()}
    return tp.copy(tree)


def seq_attention(cfg, p, h, positions, tp, attend):
    """Attention computed replicated on a sequence chunk h [B, S/m, D]
    (normed already): the projections on the chunk at its positions (of
    the whole ``positions``), K and V all-gathered over ``model`` (their
    gradients reduce-scattered back, ``tp.gather_summed``), the chunk's
    queries attending every key at their offset
    (``attend(q, k, v, q_offset=)``: one flash launch with the offset on
    the card).  ``p``'s weights enter through :func:`seq_copied`.
    Returns the chunk's output [B, S/m, D]."""
    s = h.shape[1]
    off = tp.offset(s)
    p = seq_copied(p, tp)
    q, k, v = qkv_project(cfg, p, h, positions[:, off:off + s])
    k, v = tp.gather_summed(k, 1), tp.gather_summed(v, 1)
    attn = attend(q, k, v, q_offset=off)
    return attn.reshape(h.shape[:2] + (q.shape[2] * q.shape[3],)) \
        @ p["wo"].to(h.dtype)


def seq_cross_entropy(cfg, x, final_norm, embed, labels, mask, tp):
    """The mean CE over the whole sequence from this rank's chunk x
    [B, S/m, D] of the last hidden states (a replicated head): the final
    norm and the (chunked) cross-entropy of the chunk's positions, their
    masked sum all-reduced over ``model`` (identity backward: each rank's
    gradient is its own tokens') over the token count summed alike; the
    norm's and head's weights through :func:`seq_copied`.  ``labels``
    and ``mask`` (or None) are the whole sequence's."""
    s = x.shape[1]
    sl = slice(tp.offset(s), tp.offset(s) + s)
    x = apply_norm(cfg, x, seq_copied(final_norm, tp))
    labels = labels[:, sl]
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
            if mask is None else mask[:, sl].to(torch.float32))
    ce = chunked_cross_entropy(cfg, x, seq_copied(embed, tp), labels, mask)
    n = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.clamp(tp.all_sum(torch.sum(mask)), min=1.0)
    return tp.reduce(ce * n) / total


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
