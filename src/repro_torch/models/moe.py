"""Mixture-of-Experts layer (``repro/models/moe.py``): a top-k softmax
router and two ways to run the experts.

* ``dense``: every expert on every token, combined with the top-k gate
  weights; exact, the reference's path at <= 8 experts.
* ``dispatch``: GShard capacity dispatch.  Tokens are viewed as groups of
  ``S_g``; each expert takes at most ``cap = max(ceil(k * S_g * cf / E),
  1)`` of a group's (token, slot) assignments, counted slot-major, and
  drops the rest.  The reference forms [G, S_g, E, C] one-hot
  dispatch/combine tensors and contracts them; each (expert, group,
  capacity) slot holds at most one token, so the port copies the kept
  tokens into their slots (``index_copy_``) and gathers each token's
  expert outputs back, which gives the same values without the one-hots.
  The combine adds a token's k weighted outputs in slot order (the
  reference's contraction adds them among zeros in XLA's order: the sums
  agree to float32 rounding).

Weights: ``wi_gate``/``wi_up`` [E, D, F], ``wo`` [E, F, D], ``router``
[D, E] (``[L, ...]`` stacked), with the reference's logical axes.  The
router's scores are an f32 softmax.  :func:`top_k` orders as
``jax.lax.top_k`` does: descending, the lower index first on a tie.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .layers import _dtype, _randn, lead_shape


def init_moe(cfg, generator: Optional[torch.Generator], *,
             layers=None, device=None):
    """Router and expert stacks drawn from ``generator`` (N(0, 1/fan_in)),
    and their logical axes; ``layers`` (an int, or a tuple of leading
    sizes) adds the leading stacked axes, named ``"layers"``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = _dtype(cfg.param_dtype)
    lead = lead_shape(layers)

    def mk(shape, fan_in):
        return _randn(lead + shape, generator, device).mul_(
            fan_in ** -0.5).to(dt)

    p = {"router": mk((d, e), d),
         "wi_gate": mk((e, d, f), d),
         "wi_up": mk((e, d, f), d),
         "wo": mk((e, f, d), f)}
    ax_lead = ("layers",) if layers is not None else ()
    ax = {"router": ax_lead + ("embed", "experts"),
          "wi_gate": ax_lead + ("experts", "embed", "ffn"),
          "wi_up": ax_lead + ("experts", "embed", "ffn"),
          "wo": ax_lead + ("experts", "ffn", "embed")}
    return p, ax


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (a stable sort; ``torch.topk`` promises no order on a
    tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(cfg, p, x, matmul: Callable = torch.matmul):
    """Softmax router over the experts in float32; returns (probs [..., E],
    logits).  ``matmul`` computes ``x @ router`` (the decode step passes
    its row-independent product)."""
    logits = matmul(x, p["router"].to(x.dtype)).to(torch.float32)
    return torch.softmax(logits, dim=-1), logits


def load_balancing_loss(router_probs, expert_mask, dp=None):
    """Switch-style aux loss: E * sum_e f_e * p_e, f_e and p_e the means
    over every token.  Over data-parallel ranks (``dp``, a
    ``DataParallel``) the means are of the global batch: each rank's
    per-expert sums and token count are summed over the ranks, the
    probabilities' sums with this rank's own gradient
    (``DataParallel.sum``), so the ranks' backwards add up to the global
    loss's gradient."""
    e = router_probs.shape[-1]
    lead = tuple(range(expert_mask.dim() - 1))
    if dp is None:
        f_e = torch.mean(expert_mask, dim=lead)
        p_e = torch.mean(router_probs,
                         dim=tuple(range(router_probs.dim() - 1)))
        return e * torch.sum(f_e * p_e)
    n = dp.sum(torch.full((), float(expert_mask[..., 0].numel()),
                          device=router_probs.device))
    f_e = dp.sum(torch.sum(expert_mask, dim=lead).detach()) / n
    p_e = dp.sum(torch.sum(router_probs,
                           dim=tuple(range(router_probs.dim() - 1)))) / n
    return e * torch.sum(f_e * p_e)


def expert_matmul(h, w):
    """``h [..., E, K] @ w [E, K, N]`` expert by expert -> [..., E, N]: one
    batched product over the experts for all tokens."""
    return torch.einsum("...ek,ekn->...en", h, w)


def expert_matmul_rows(h, w):
    """:func:`expert_matmul` one token at a time: each token's E products
    are one ``torch.matmul`` of its own (M = 1 each), so its bits do not
    depend on how many tokens share the call.  The decode step's dense
    path, where a batched step must equal its rows decoded alone."""
    flat = h.reshape((-1,) + tuple(h.shape[-2:]))            # [T, E, K]
    ys = [torch.matmul(t[:, None, :], w)[:, 0] for t in flat.unbind(0)]
    return torch.stack(ys).reshape(tuple(h.shape[:-1]) + (w.shape[-1],))


def _local_experts(tp, cfg):
    """The range of experts this rank runs: all of them, or under expert
    parallelism (``tp.experts``) its ``E / model``."""
    if tp is None or not tp.experts:
        return 0, cfg.n_experts
    n = cfg.n_experts // tp.size
    return tp.offset(n), tp.offset(n) + n


def apply_moe_dense(cfg, p, x, *, router_matmul: Callable = torch.matmul,
                    experts: Callable = expert_matmul,
                    router_topk: Callable = top_k, tp=None, dp=None):
    """Every expert on every token, combined with the top-k gate weights.
    x [B, S, D] -> ([B, S, D], aux).  Cost scales with the expert count.

    Expert-parallel (``tp.experts``): the router runs replicated, the
    expert stacks are this rank's experts and the result is their partial
    sum, for the caller to reduce over ``model``; the gates and the
    experts' input enter the region through ``tp.copy``.  ``dp``: the
    aux loss over the data-parallel ranks' tokens."""
    probs, _ = _router_probs(cfg, p, x, router_matmul)
    topv, topi = router_topk(probs, cfg.experts_per_token)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(-1, topi, topv)    # [B, S, E]
    aux = load_balancing_loss(probs, (gates > 0).to(torch.float32), dp)
    lo, hi = _local_experts(tp, cfg)
    if hi - lo != cfg.n_experts:
        x, gates = tp.copy(x), tp.copy(gates)[..., lo:hi]
    dt = x.dtype
    xe = x[..., None, :].expand(x.shape[:-1] + (hi - lo, x.shape[-1]))
    g = experts(xe, p["wi_gate"].to(dt))
    u = experts(xe, p["wi_up"].to(dt))
    y = experts(F.silu(g) * u, p["wo"].to(dt))                # [B, S, E, D]
    out = torch.einsum("bsed,bse->bsd", y, gates.to(dt))
    return out, aux


#: per-call token budget of a dispatch: longer inputs run in sequence
#: chunks (the reference's bound on its [tokens, E, C] one-hots)
MAX_CHUNK_TOKENS = 65536


def apply_moe_dispatch(cfg, p, x, group_size: int = 1024,
                       max_chunk_tokens: int = MAX_CHUNK_TOKENS, *,
                       router_matmul: Callable = torch.matmul,
                       router_topk: Callable = top_k, tp=None, dp=None):
    """GShard capacity dispatch, sequence-chunked as the reference's
    ``lax.scan``: one :func:`_dispatch_one` per chunk, the aux loss the
    mean over chunks.  x [B, S, D] -> ([B, S, D], aux).  Over
    data-parallel ranks (``dp``) ``x`` is this rank's rows of the global
    batch, whose tokens set the chunk count."""
    b, s, d = x.shape
    tokens = b * s * (1 if dp is None else dp.size)
    if tokens > max_chunk_tokens and s > 1:
        n = max(-(-tokens // max_chunk_tokens), 1)
        while n <= s and s % n != 0:
            n += 1
        if 1 < n <= s:
            chunks = x.reshape(b, n, s // n, d).transpose(0, 1)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            ys = []
            for xi in chunks.unbind(0):
                y, a = _dispatch_one(cfg, p, xi, group_size, router_matmul,
                                     router_topk, tp, dp)
                ys.append(y)
                aux = aux + a
            return (torch.stack(ys).transpose(0, 1).reshape(b, s, d),
                    aux / n)
    return _dispatch_one(cfg, p, x, group_size, router_matmul, router_topk,
                         tp, dp)


def _queue_offsets(assign, dp, g0: int, n_all: int):
    """[G, k, E]: for each of this rank's groups (global groups g0 ..
    g0 + G - 1), the place in each expert's slot-major queue that the
    other data-parallel ranks' assignments take before this rank's at
    slot j: all of theirs at the earlier slots, and at slot j those of
    the ranks before it (lower token indices).  One exchange of the
    ranks' per-(group, slot, expert) counts (integers: exact)."""
    g, k, e = assign.shape[0], assign.shape[2], assign.shape[3]
    counts = torch.zeros((n_all, k, e), dtype=assign.dtype,
                         device=assign.device)
    counts[g0:g0 + g] = assign.sum(dim=1)
    every = dp.stack(counts)                               # [R, G_all, k, E]
    others = every.sum(dim=0) - every[dp.index]
    before = every[:dp.index].sum(dim=0)
    return (torch.cumsum(others, dim=1) - others + before)[g0:g0 + g]


def _dispatch_one(cfg, p, x, group_size: int = 1024,
                  router_matmul: Callable = torch.matmul,
                  router_topk: Callable = top_k, tp=None, dp=None):
    """Single-shot capacity dispatch over groups of ``min(group_size,
    tokens)`` tokens; assignments past an expert's capacity are dropped
    (their weight is lost, as in GShard).

    Over data-parallel ranks (``dp``) the groups are the global batch's:
    this rank's tokens are a contiguous run of the global token order
    (the loader slices rows), which may start or end inside a group.  It
    routes its own tokens, laid out in their groups beside zero rows that
    take no assignment, and counts each (token, slot) from the other
    ranks' counts in its groups on (:func:`_queue_offsets`); where its run
    is whole groups no exchange is needed.  Expert-parallel
    (``tp.experts``): every rank computes the queues whole, runs its own
    experts' capacity rows and returns the partial combine, for the
    caller to reduce over ``model``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    mine = b * s
    ranks = 1 if dp is None else dp.size
    tokens = mine * ranks
    g_sz = min(group_size, tokens)
    n_all = tokens // g_sz
    if n_all * g_sz != tokens:
        raise ValueError(f"tokens {tokens} not divisible by group size "
                         f"{g_sz}")
    cap = max(int(-(-k * g_sz * cfg.capacity_factor // e)), 1)
    # this rank's global tokens [first, first + mine): groups g0 .. g0 +
    # n_g - 1, the first entered at ``lead``, the last left ``pad`` early
    g0, lead = divmod(0 if dp is None else dp.index * mine, g_sz)
    n_g = -(-(lead + mine) // g_sz)
    pad = n_g * g_sz - lead - mine

    xf = x.reshape(mine, d)
    if lead or pad:
        xf = F.pad(xf, (0, 0, lead, pad))
    xg = xf.reshape(n_g, g_sz, d)
    probs, _ = _router_probs(cfg, p, xg, router_matmul)       # [G, Sg, E]
    topv, topi = router_topk(probs, k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)

    # each (token, slot)'s place in its expert's queue, counted over the
    # slot-major order (slot 0 of every token, then slot 1, ...), in
    # integers: exact
    assign = torch.zeros(topi.shape + (e,), dtype=torch.int32,
                         device=x.device).scatter_(-1, topi[..., None], 1)
    real = None
    if lead or pad:
        real = torch.zeros(n_g * g_sz, dtype=torch.bool, device=x.device)
        real[lead:lead + mine] = True
        real = real.reshape(n_g, g_sz)
        assign = assign * real[..., None, None]
    flat = assign.transpose(1, 2).reshape(n_g, k * g_sz, e)
    queue = (torch.cumsum(flat, dim=1) - flat).reshape(
        n_g, k, g_sz, e).transpose(1, 2)                      # [G,Sg,k,E]
    if ranks > 1 and mine % g_sz:
        queue = queue + _queue_offsets(assign, dp, g0, n_all)[:, None]
    slot = torch.gather(queue, -1, topi[..., None])[..., 0]   # [G, Sg, k]
    kept = slot < cap
    if real is not None:
        kept = kept & real[..., None]
    # the (expert, group, slot) row of each kept assignment; the dropped
    # ones all go to one spare row past the end, never read
    spare = e * n_g * cap
    grp = torch.arange(n_g, device=x.device)[:, None, None]
    row = torch.where(kept, (topi * n_g + grp) * cap + slot,
                      torch.full_like(topi, spare))
    lo, hi = _local_experts(tp, cfg)
    src = xg
    if hi - lo != e:
        src, topv = tp.copy(xg), tp.copy(topv)
    xin = x.new_zeros((spare + 1, d)).index_copy(
        0, row.reshape(-1),
        src[:, :, None, :].expand(n_g, g_sz, k, d).reshape(-1, d))
    xin = xin[:spare].reshape(e, n_g * cap, d)[lo:hi]
    dt = x.dtype
    gte = torch.matmul(xin, p["wi_gate"].to(dt))              # [E, G*C, F]
    up = torch.matmul(xin, p["wi_up"].to(dt))
    yout = torch.matmul(F.silu(gte) * up, p["wo"].to(dt))     # [E, G*C, D]
    yflat = torch.cat([yout.new_zeros((lo * n_g * cap, d)),
                       yout.reshape(-1, d),
                       yout.new_zeros(((e - hi) * n_g * cap + 1, d))])
    picked = yflat[row]                                       # [G,Sg,k,D]
    # the kept outputs weighted, added in slot order (a dropped slot
    # reads the zero row)
    y = picked[:, :, 0] * topv[..., 0, None].to(dt)
    for j in range(1, k):
        y = y + picked[:, :, j] * topv[..., j, None].to(dt)
    hits = torch.amax(assign, dim=2).to(torch.float32)
    if real is not None:
        probs = probs.reshape(-1, e)[lead:lead + mine]
        hits = hits.reshape(-1, e)[lead:lead + mine]
        y = y.reshape(-1, d)[lead:lead + mine]
    aux = load_balancing_loss(probs, hits, dp)
    return y.reshape(b, s, d), aux


def apply_moe(cfg, p, x, *, path: str = "auto", group_size: int = 1024,
              router_matmul: Callable = torch.matmul,
              experts: Callable = expert_matmul,
              router_topk: Callable = top_k, tp=None, dp=None):
    """The MoE FFN: ``"auto"`` runs dense at <= 8 experts, else dispatch.
    ``router_matmul`` and ``experts`` (dense only) are the products'
    hooks (the decode step passes row-independent ones);
    ``router_topk(probs, k)`` picks each token's experts (:func:`top_k`;
    a caller may record or replay the choice).  ``tp``: expert
    parallelism over ``model`` (the result a partial sum); ``dp``: the
    router's statistics and capacity over the data-parallel ranks."""
    if path == "auto":
        path = "dense" if cfg.n_experts <= 8 else "dispatch"
    if path == "dense":
        return apply_moe_dense(cfg, p, x, router_matmul=router_matmul,
                               experts=experts, router_topk=router_topk,
                               tp=tp, dp=dp)
    return apply_moe_dispatch(cfg, p, x, group_size=group_size,
                              router_matmul=router_matmul,
                              router_topk=router_topk, tp=tp, dp=dp)
