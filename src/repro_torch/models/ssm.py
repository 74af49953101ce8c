"""State-space and recurrent sequence mixers (``repro/models/ssm.py``):
Mamba-2 (SSD) and the two xLSTM cells.

  * ``mamba_forward``: Mamba-2 / SSD with a scalar decay per head.
  * ``mlstm_forward``: the xLSTM matrix-memory cell with the
    max-stabilized exponential gating of the xLSTM paper.
  * ``slstm_forward``: the xLSTM scalar cell, whose hidden state feeds
    its own gates (sequential over time).

As in the reference, the two parallel cells are *chunked*: within a chunk
of ``chunk`` positions, masked attention-like products; across chunks, a
Python loop carrying the recurrent state (the reference's ``lax.scan``).
Each ``*_decode_step`` takes one token and the O(1) state of its
``*_init_state``.  Parameter dicts have the reference's keys and layouts,
so ``bridge.params_from_jax`` carries them across; ``layers`` (an int or
a tuple of sizes) adds leading stacked axes.

Under tensor-parallel compute over ``model`` (``tp``, a
``parallel.tensor_parallel.TensorParallel`` whose ``mamba``, ``mlstm`` or
``slstm`` flag is set) each cell computes on this rank's shards and the
parallel cells return a partial sum for the caller to reduce: Mamba and
mLSTM on their local heads (the column-parallel projections' input
entering through ``tp.copy``), sLSTM with its gate pre-activations
all-gathered.  Without ``tp`` (or with the flag unset) they compute on
whole leaves, as before.

The reference's constants are kept: input-gate padding of -1e9,
stabilizer floors of -1e30, and -inf in masked exponents.  A mask is
applied to the exponent, before ``exp``, never to an ``exp`` that may
have overflowed: the masked upper triangle of a chunk's decay differences
is positive and overflows float32 past ~88, and the backward pass of a
mask applied after it would form 0 x inf = NaN.  The forward values are
the reference's either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dtype, dense_init, lead_shape, rmsnorm


def _vec(val: float, lead: tuple, shape: tuple, device):
    return torch.full(lead + shape, val, dtype=torch.float32, device=device)


def _pad_time(t, pad: int, value: float = 0.0):
    """``t`` [B, S, ...] right-padded by ``pad`` positions along S."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba_dims(cfg):
    d_in = cfg.d_model * cfg.mamba_expand
    n_heads = d_in // cfg.mamba_headdim
    return d_in, cfg.mamba_d_state, n_heads, cfg.mamba_headdim


def init_mamba(cfg, generator, *, layers=None, device=None):
    d = cfg.d_model
    d_in, n, h, _p = mamba_dims(cfg)
    dt = _dtype(cfg.param_dtype)
    dev = generator.device if generator is not None else device
    lead = lead_shape(layers)

    def mk(i, o):
        return dense_init(generator, i, o, dt, layers=layers, device=dev)

    p = {
        "in_x": mk(d, d_in), "in_z": mk(d, d_in),
        "in_B": mk(d, n), "in_C": mk(d, n),
        "in_dt": mk(d, h),
        "conv_x": _vec(0.0, lead, (cfg.mamba_d_conv, d_in), dev)
        + 1.0 / cfg.mamba_d_conv,
        "A_log": _vec(0.0, lead, (h,), dev),          # A = -exp(A_log) = -1
        "D": _vec(1.0, lead, (h,), dev),
        "dt_bias": _vec(0.0, lead, (h,), dev),
        "norm": _vec(1.0, lead, (d_in,), dev),
        "out": mk(d_in, d),
    }
    ax_lead = ("layers",) if layers is not None else ()
    ax = {
        "in_x": ax_lead + ("embed", "ffn"), "in_z": ax_lead + ("embed", "ffn"),
        "in_B": ax_lead + ("embed", "state"),
        "in_C": ax_lead + ("embed", "state"),
        "in_dt": ax_lead + ("embed", "heads"),
        "conv_x": ax_lead + ("conv", "ffn"),
        "A_log": ax_lead + ("heads",), "D": ax_lead + ("heads",),
        "dt_bias": ax_lead + ("heads",),
        "norm": ax_lead + ("ffn",),
        "out": ax_lead + ("ffn", "embed"),
    }
    return p, ax


def _causal_conv(x, w, state=None):
    """Depthwise causal convolution along time.  x [B, S, C]; w [K, C].

    ``state`` holds the previous segment's last K - 1 inputs
    ([B, K - 1, C], zeros when None); returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return y, new_state


def gated_rmsnorm(g, scale, tp=None, eps: float = 1e-6):
    """RMSNorm of f32 ``g`` [..., C] over its last axis.  Under ``tp``
    (Mamba split over ``model``) ``g`` is this rank's channels of the whole
    ``d_in`` and ``scale`` its chunk of the norm: the per-row sum of
    squares is all-reduced over the group (forward and backward: each
    rank's outputs are its own channels) before the ``rsqrt``."""
    if tp is None:
        return rmsnorm(g, scale, eps)
    ss = tp.total(torch.sum(g * g, dim=-1, keepdim=True))
    return g * torch.rsqrt(ss / (g.shape[-1] * tp.size) + eps) \
        * scale.to(torch.float32)


def _gated_out(p, y, z, dtype, tp=None):
    """Mamba-2's gated RMSNorm, then the out-projection (a partial sum
    over ``model`` under ``tp``)."""
    yf = gated_rmsnorm(y.to(torch.float32) * F.silu(z.to(torch.float32)),
                       p["norm"], tp)
    return yf.to(dtype) @ p["out"].to(dtype)


def _mamba_split(cfg, tp):
    """(tp where Mamba splits over ``model`` else None, d_in, heads):
    the local widths."""
    d_in, _, h, _ = mamba_dims(cfg)
    if tp is None or not tp.mamba:
        return None, d_in, h
    return tp, d_in // tp.size, h // tp.size


def _mamba_inputs(p, x, tp):
    """(x for the column-parallel products, B and C [.., N] in f32):
    under ``tp`` the products' input enters through ``tp.copy`` and
    ``in_B``/``in_C`` (replicated) are computed whole outside it, their
    results entering through ``tp.copy`` (each rank's scan reads them on
    its own heads)."""
    dt_ = x.dtype
    bc = (x @ p["in_B"].to(dt_)).to(torch.float32)
    cc = (x @ p["in_C"].to(dt_)).to(torch.float32)
    if tp is None:
        return x, bc, cc
    return tp.copy(x), tp.copy(bc), tp.copy(cc)


def mamba_forward(cfg, p, x, chunk: int = 256, tp=None):
    """x [B, S, D] -> [B, S, D]: the full-sequence (and prefill) path;
    a partial sum over ``model`` where ``tp.mamba``."""
    b, s, _ = x.shape
    _, n, _, pd = mamba_dims(cfg)
    tp, d_in, h = _mamba_split(cfg, tp)
    dt_ = x.dtype
    x, bc, cc = _mamba_inputs(p, x, tp)                        # [B,S,N]
    xb = x @ p["in_x"].to(dt_)
    z = x @ p["in_z"].to(dt_)
    xb, _ = _causal_conv(xb, p["conv_x"])
    xb = F.silu(xb)
    dt_r = (x @ p["in_dt"].to(dt_)).to(torch.float32)          # [B,S,H]
    dt = F.softplus(dt_r + p["dt_bias"])
    a = -torch.exp(p["A_log"])                                 # [H]
    log_decay = dt * a                                         # [B,S,H] <= 0

    xh = xb.reshape(b, s, h, pd).to(torch.float32)
    xbar = xh * dt[..., None]                                  # input scale

    c_len = min(chunk, s)
    nc = -(-s // c_len)
    pad = nc * c_len - s
    if pad:
        xbar, bc, cc, log_decay = (_pad_time(t, pad)
                                   for t in (xbar, bc, cc, log_decay))
    xbar = xbar.reshape(b, nc, c_len, h, pd)
    bc = bc.reshape(b, nc, c_len, n)
    cc = cc.reshape(b, nc, c_len, n)
    la = log_decay.reshape(b, nc, c_len, h)

    li = torch.arange(c_len, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]   # [1,L,L,1]
    hstate = torch.zeros((b, h, n, pd), dtype=torch.float32,
                         device=x.device)
    ys = []
    for c in range(nc):
        xc, bcc, ccc, lac = xbar[:, c], bc[:, c], cc[:, c], la[:, c]
        cum = torch.cumsum(lac, dim=1)                         # [B,L,H]
        # intra-chunk: attn[b,i,j,h] = (C_i . B_j) exp(cum_i - cum_j), j <= i
        scores = torch.einsum("bin,bjn->bij", ccc, bcc)        # [B,L,L]
        decay = torch.where(causal,
                            cum[:, :, None, :] - cum[:, None, :, :],
                            -torch.inf)                        # [B,i,j,H]
        attn = torch.exp(decay) * scores[..., None]
        y = torch.einsum("bijh,bjhp->bihp", attn, xc)
        # inbound state: C_i . h_in * exp(cum_i)
        y = y + torch.einsum("bin,bhnp,bih->bihp", ccc, hstate,
                             torch.exp(cum))
        # outbound state
        last = cum[:, -1:, :]                                  # [B,1,H]
        w = torch.exp(last - cum)                              # [B,L,H]
        hstate = torch.einsum("bjn,bjhp,bjh->bhnp", bcc, xc, w) \
            + torch.exp(last[:, 0, :])[:, :, None, None] * hstate
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * c_len, h, pd)[:, :s]
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(dt_)
    return _gated_out(p, y, z, dt_, tp)


def mamba_init_state(cfg, batch: int, dtype=torch.float32, device=None,
                     tp=None):
    """The zero decode state; under ``tp.mamba`` this rank's heads and
    channels of it."""
    _, n, _, pd = mamba_dims(cfg)
    _, d_in, h = _mamba_split(cfg, tp)
    return {"ssm": torch.zeros((batch, h, n, pd), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in),
                                dtype=dtype, device=device)}


def mamba_decode_step(cfg, p, x, state, tp=None):
    """x [B, 1, D]; ``state`` from :func:`mamba_init_state`; returns
    (y [B, 1, D], new state); under ``tp.mamba`` the state holds this
    rank's heads and y is a partial sum over ``model``."""
    b = x.shape[0]
    _, n, _, pd = mamba_dims(cfg)
    tp, d_in, h = _mamba_split(cfg, tp)
    dt_ = x.dtype
    x, bc, cc = _mamba_inputs(p, x, tp)
    bc, cc = bc[:, 0], cc[:, 0]                                # [B,N]
    xb = x @ p["in_x"].to(dt_)
    z = x @ p["in_z"].to(dt_)
    xb, conv_state = _causal_conv(xb, p["conv_x"], state["conv"])
    xb = F.silu(xb)
    dt_r = (x @ p["in_dt"].to(dt_)).to(torch.float32)[:, 0]
    dt = F.softplus(dt_r + p["dt_bias"])                       # [B,H]
    a = torch.exp(dt * -torch.exp(p["A_log"]))                 # [B,H]
    xh = xb.reshape(b, h, pd).to(torch.float32)
    xbar = xh * dt[..., None]
    hs = state["ssm"] * a[:, :, None, None] \
        + torch.einsum("bn,bhp->bhnp", bc, xbar)
    y = torch.einsum("bn,bhnp->bhp", cc, hs) + xh * p["D"][None, :, None]
    out = _gated_out(p, y.reshape(b, 1, d_in), z, dt_, tp)
    return out, {"ssm": hs, "conv": conv_state}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunked)
# ---------------------------------------------------------------------------

def init_mlstm(cfg, generator, *, layers=None, device=None):
    d, qd, h = cfg.d_model, cfg.q_dim, cfg.n_heads
    dt = _dtype(cfg.param_dtype)
    dev = generator.device if generator is not None else device
    lead = lead_shape(layers)

    def mk(i, o):
        return dense_init(generator, i, o, dt, layers=layers, device=dev)

    p = {"wq": mk(d, qd), "wk": mk(d, qd), "wv": mk(d, qd),
         "w_i": mk(d, h), "w_f": mk(d, h),
         "b_i": _vec(0.0, lead, (h,), dev), "b_f": _vec(3.0, lead, (h,), dev),
         "w_o": mk(d, qd),     # sigmoid output gate (a vector)
         "wout": mk(qd, d)}
    ax_lead = ("layers",) if layers is not None else ()
    ax = {"wq": ax_lead + ("embed", "heads"),
          "wk": ax_lead + ("embed", "heads"),
          "wv": ax_lead + ("embed", "heads"),
          "w_i": ax_lead + ("embed", "head_vec"),
          "w_f": ax_lead + ("embed", "head_vec"),
          "b_i": ax_lead + ("head_vec",), "b_f": ax_lead + ("head_vec",),
          "w_o": ax_lead + ("embed", "heads"),
          "wout": ax_lead + ("heads", "embed")}
    return p, ax


def _mlstm_heads(cfg, tp):
    """(tp where mLSTM splits over ``model`` else None, the local heads)."""
    if tp is None or not tp.mlstm:
        return None, cfg.n_heads
    return tp, cfg.n_heads // tp.size


def _mlstm_inputs(cfg, p, x, tp=None):
    """q, k (scaled by dh^-0.5), v [B, S, H, dh] in x's dtype, and the
    f32 input gate's pre-activation, log forget gate [B, S, H] and output
    gate [B, S, H*dh].  Under ``tp`` (:func:`_mlstm_heads`) this rank's
    heads: the input enters through ``tp.copy`` and the replicated gate
    weights are sliced to the local heads through ``tp.split`` (their
    gradient all-gathered whole)."""
    b, s, _ = x.shape
    tp, h = _mlstm_heads(cfg, tp)
    dh = cfg.head_dim
    dt_ = x.dtype
    gates = {n: p[n] for n in ("w_i", "w_f", "b_i", "b_f")}
    if tp is not None:
        x = tp.copy(x)
        gates = {n: tp.split(w, -1) for n, w in gates.items()}
    q = (x @ p["wq"].to(dt_)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(dt_)).reshape(b, s, h, dh) * dh ** -0.5
    v = (x @ p["wv"].to(dt_)).reshape(b, s, h, dh)
    i_raw = (x @ gates["w_i"].to(dt_)).to(torch.float32) + gates["b_i"]
    f_raw = (x @ gates["w_f"].to(dt_)).to(torch.float32) + gates["b_f"]
    o_gate = torch.sigmoid((x @ p["w_o"].to(dt_)).to(torch.float32))
    return q, k, v, i_raw, F.logsigmoid(f_raw), o_gate


def mlstm_forward(cfg, p, x, chunk: int = 256, tp=None):
    """Chunked matrix LSTM.  x [B, S, D] -> [B, S, D] (a partial sum
    over ``model`` where ``tp.mlstm``: this rank's heads).

    Recurrence (per head, stabilizer m):
        m_t = max(log f_t + m_{t-1}, i_t)
        C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{i_t - m_t} k_t v_t^T
        n_t = (same) n_{t-1} + e^{i_t - m_t} k_t
        y_t = (q_t C_t) / max(|q_t n_t|, e^{-m_t})
    Within a chunk the pairs are a masked product, across chunks the loop.
    """
    b, s, _ = x.shape
    h, dh = _mlstm_heads(cfg, tp)[1], cfg.head_dim
    q, k, v, i_raw, log_f, o_gate = _mlstm_inputs(cfg, p, x, tp)

    c_len = min(chunk, s)
    nc = -(-s // c_len)
    pad = nc * c_len - s
    if pad:
        q, k, v, log_f = (_pad_time(t, pad) for t in (q, k, v, log_f))
        i_raw = _pad_time(i_raw, pad, value=-1e9)

    qc = q.reshape(b, nc, c_len, h, dh).to(torch.float32)
    kc = k.reshape(b, nc, c_len, h, dh).to(torch.float32)
    vc = v.reshape(b, nc, c_len, h, dh).to(torch.float32)
    ic = i_raw.reshape(b, nc, c_len, h)
    fc = log_f.reshape(b, nc, c_len, h)

    li = torch.arange(c_len, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]   # [1,L,L,1]
    floor = torch.tensor(-1e30, device=x.device)
    cs = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    ns = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    ms = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[:, c], kc[:, c], vc[:, c], ic[:, c], fc[:, c]
        cumf = torch.cumsum(fb, dim=1)                         # [B,L,H]
        # log-weight of source j at target i: cumf_i - cumf_j + i_j
        lw = torch.where(causal,
                         cumf[:, :, None, :] - cumf[:, None, :, :]
                         + ib[:, None, :, :], -torch.inf)      # [B,i,j,H]
        # inbound state's log-weight at target i: cumf_i + m_state
        lw_state = cumf + ms[:, None, :]                       # [B,L,H]
        m_loc = torch.maximum(torch.amax(lw, dim=2), lw_state)
        m_loc = torch.maximum(m_loc, floor)
        w = torch.exp(lw - m_loc[:, :, None, :])               # [B,i,j,H]
        scores = torch.einsum("bihd,bjhd->bijh", qb, kb) * w
        y = torch.einsum("bijh,bjhd->bihd", scores, vb)
        denom = torch.sum(scores, dim=2)                       # [B,L,H]
        w_state = torch.exp(lw_state - m_loc)                  # [B,L,H]
        y = y + torch.einsum("bihd,bhde,bih->bihe", qb, cs, w_state)
        denom = denom + torch.einsum("bihd,bhd,bih->bih", qb, ns, w_state)
        y = y / torch.maximum(torch.abs(denom),
                              torch.exp(-m_loc))[..., None]
        # the state carried to the end of the chunk
        last = cumf[:, -1:, :]                                 # [B,1,H]
        m_new = torch.maximum(last[:, 0] + ms,
                              torch.amax(last - cumf + ib, dim=1))
        wk = torch.exp(last - cumf + ib - m_new[:, None, :])   # [B,L,H]
        decay = torch.exp(last[:, 0] + ms - m_new)             # [B,H]
        cs = decay[:, :, None, None] * cs \
            + torch.einsum("bjh,bjhd,bjhe->bhde", wk, kb, vb)
        ns = decay[:, :, None] * ns + torch.einsum("bjh,bjhd->bhd", wk, kb)
        ms = m_new
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * c_len, h, dh)[:, :s]
    y = y.reshape(b, s, h * dh) * o_gate
    return y.to(x.dtype) @ p["wout"].to(x.dtype)


def mlstm_init_state(cfg, batch: int, device=None, tp=None):
    h, dh = _mlstm_heads(cfg, tp)[1], cfg.head_dim
    return {"C": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, dh), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, h), -1e30, dtype=torch.float32,
                            device=device)}


def mlstm_decode_step(cfg, p, x, state, tp=None):
    """x [B, 1, D], O(1) state; returns (y [B, 1, D], new state); under
    ``tp.mlstm`` the state holds this rank's heads and y is a partial
    sum over ``model``."""
    b = x.shape[0]
    h, dh = _mlstm_heads(cfg, tp)[1], cfg.head_dim
    q, k, v, i_raw, log_f, o_gate = _mlstm_inputs(cfg, p, x, tp)
    q, k, v = (t.reshape(b, h, dh).to(torch.float32) for t in (q, k, v))
    i_raw, log_f, o_gate = i_raw[:, 0], log_f[:, 0], o_gate[:, 0]
    m_new = torch.maximum(log_f + state["m"], i_raw)
    fg = torch.exp(log_f + state["m"] - m_new)
    ig = torch.exp(i_raw - m_new)
    c_new = fg[:, :, None, None] * state["C"] \
        + ig[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n_new = fg[:, :, None] * state["n"] + ig[:, :, None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    y = (y.reshape(b, 1, h * dh) * o_gate[:, None, :]).to(x.dtype)
    return y @ p["wout"].to(x.dtype), {"C": c_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar cell, hidden-state recurrence: sequential)
# ---------------------------------------------------------------------------

def init_slstm(cfg, generator, *, layers=None, device=None):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = _dtype(cfg.param_dtype)
    dev = generator.device if generator is not None else device
    lead = lead_shape(layers)

    def mk(i, o):
        return dense_init(generator, i, o, dt, layers=layers, device=dev)

    # block-diagonal recurrent weights: per gate and head [dh, dh]
    r = dense_init(generator, dh, dh, dt, layers=lead + (4, h),
                   device=dev) * 0.5
    p = {"wx": mk(d, 4 * d),      # z, i, f, o pre-activations from x
         "r": r,
         "b": _vec(0.0, lead, (4, d), dev),
         "wout": mk(d, d)}
    ax_lead = ("layers",) if layers is not None else ()
    ax = {"wx": ax_lead + ("embed", "gates"),
          "r": ax_lead + ("gate4", "head_vec", "hd1", "hd2"),
          "b": ax_lead + ("gate4", "embed"),
          "wout": ax_lead + ("embed", "embed2")}
    return p, ax


def _slstm_cell(cfg, r, xt, hs, c, n, m):
    """One sLSTM step from the input's gate pre-activations xt [B, 4, D]
    and the state (h, c, n, m), each [B, D]; returns the new state."""
    b, d = hs.shape
    h = cfg.n_heads
    rg = torch.einsum("ghij,bhj->gbhi", r, hs.reshape(b, h, d // h))
    rg = rg.reshape(4, b, d)
    z = torch.tanh(xt[:, 0] + rg[0])
    i_log = xt[:, 1] + rg[1]
    f_log = F.logsigmoid(xt[:, 2] + rg[2])
    o = torch.sigmoid(xt[:, 3] + rg[3])
    m_new = torch.maximum(f_log + m, i_log)
    ig = torch.exp(i_log - m_new)
    fg = torch.exp(f_log + m - m_new)
    c_new = fg * c + ig * z
    # a tensor bound, not clamp: jnp.maximum halves the gradient on a tie
    # (every row's first step has fg * n + ig == 1 exactly), and so does
    # torch.maximum
    n_new = torch.maximum(fg * n + ig, torch.ones((), device=hs.device))
    return o * c_new / n_new, c_new, n_new, m_new


def _slstm_gates(p, x, tp):
    """The gate pre-activations x @ wx [..., 4D] in f32: under
    ``tp.slstm`` from this rank's chunk of ``wx``'s columns (its input
    through ``tp.copy``), all-gathered whole."""
    if tp is None or not tp.slstm:
        return (x @ p["wx"].to(x.dtype)).to(torch.float32)
    xg = (tp.copy(x) @ p["wx"].to(x.dtype)).to(torch.float32)
    return tp.gather(xg, -1)


def slstm_forward(cfg, p, x, tp=None):
    """Sequential sLSTM.  x [B, S, D] -> [B, S, D], whole under ``tp``
    too (the cell runs replicated)."""
    b, s, d = x.shape
    xg = _slstm_gates(p, x, tp).reshape(b, s, 4, d) + p["b"]
    r = p["r"].to(torch.float32)
    zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros,
             torch.full((b, d), -1e30, dtype=torch.float32, device=x.device))
    ys = []
    for t in range(s):
        state = _slstm_cell(cfg, r, xg[:, t], *state)
        ys.append(state[0])
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y @ p["wout"].to(x.dtype)


def slstm_init_state(cfg, batch: int, device=None):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z,
            "m": torch.full((batch, d), -1e30, dtype=torch.float32,
                            device=device)}


def slstm_decode_step(cfg, p, x, state, tp=None):
    """x [B, 1, D]; returns (y [B, 1, D], new state), whole under
    ``tp`` as :func:`slstm_forward`."""
    b, _, d = x.shape
    xg = _slstm_gates(p, x, tp).reshape(b, 4, d) + p["b"]
    h_new, c_new, n_new, m_new = _slstm_cell(
        cfg, p["r"].to(torch.float32), xg, state["h"], state["c"],
        state["n"], state["m"])
    out = h_new[:, None, :].to(x.dtype) @ p["wout"].to(x.dtype)
    return out, {"h": h_new, "c": c_new, "n": n_new, "m": m_new}
