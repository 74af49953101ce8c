"""Joint quantization bit-width x computation frequency co-design (paper §V).

Port of the uniform (P1) solvers of ``repro/core/codesign.py``:

    min_{b_hat, f, f~}   D^U(b_hat - 1) - D^L(b_hat - 1)
    s.t.                 T(b_hat, f, f~) <= T0,  E(b_hat, f, f~) <= E0
                         b_hat in {1..B_max},  0 <= f <= f_max,  0 <= f~ <= f~_max

* :func:`solve_sca` — the paper's Algorithm 1: continuous relaxation,
  auxiliary variable b' ~ 1/b, iterative convex surrogates solved exactly
  (`_solve_p4k`), rounding.
* :func:`solve_oracle` — exhaustive search over the discrete bit-width with
  the closed-form min-energy frequency split per bit-width.
* :func:`solve_device_only` — (P1) with the whole model on the agent
  (:func:`device_only_params`), the serving supervisor's failover point.

* :func:`solve_decode` — (P1) extended with the stored KV-cache
  bit-width b_kv, enumerated over the container ladder.

* :func:`solve_speculative` — the decode solve extended with the draft
  bit-width and lookahead (b̂, f, f̃, b_kv, b_draft, k), priced with the
  draft model of :func:`acceptance_rate` and
  :func:`expected_tokens_per_round` (which the layer-wise allocator of
  ``core.mixed_precision`` uses too).

All math is float64 on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .cost_model import (SystemParams, draft_delay, draft_energy, kv_delay,
                         kv_energy, rollback_delay, rollback_energy,
                         speculative_round_delay, speculative_round_energy,
                         total_delay, total_energy, transport_delay,
                         transport_energy)

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Objective (float64 host mirror of the rate-distortion bounds)
# ---------------------------------------------------------------------------

def _d_upper(rate: float, lam: float) -> float:
    denom = max(2.0 ** rate - 1.0, _EPS)
    return (math.sqrt(1.0 + 4.0 / denom) - 1.0) / (2.0 * lam)


def _d_lower(rate: float, lam: float) -> float:
    return 1.0 / (lam * 2.0 ** (rate + 1.0))


def distortion_gap(b_hat: float, lam: float) -> float:
    """(P1)/(P2) objective D^U(b-1) - D^L(b-1); sign bit costs one bit."""
    r = b_hat - 1.0
    return _d_upper(r, lam) - _d_lower(r, lam)


# ---------------------------------------------------------------------------
# Link-aware budget reduction
# ---------------------------------------------------------------------------

def net_budgets(p: SystemParams, t0: float, e0: float,
                b_emb: Optional[float],
                b_kv: Optional[float] = None) -> "tuple[float, float]":
    """(T0, E0) left for computation after the uplink and, for decode, the
    KV-cache read at ``b_kv`` take their shares; neither depends on
    (b̂, f, f̃), so each simply shrinks the budgets."""
    if b_emb is not None:
        t0 = t0 - float(transport_delay(b_emb, p))
        e0 = e0 - float(transport_energy(b_emb, p))
    if b_kv is not None:
        t0 = t0 - float(kv_delay(b_kv, p))
        e0 = e0 - float(kv_energy(b_kv, p))
    return t0, e0


# ---------------------------------------------------------------------------
# Frequency subproblem: minimal energy subject to the deadline
# ---------------------------------------------------------------------------

def _workload_constants(p: SystemParams):
    """Ka, Ks (seconds at f=f_max) and Ea, Es (joules at f=f_max)."""
    ka = p.n_flop_agent / (p.c_agent * p.f_max)
    ks = p.n_flop_server / (p.c_server * p.f_server_max)
    ea = p.eta_agent * p.n_flop_agent * p.psi_agent * p.f_max ** 2 / p.c_agent
    es = p.eta_server * p.n_flop_server * p.psi_server * p.f_server_max ** 2 \
        / p.c_server
    return ka, ks, ea, es


def min_energy_under_deadline(workload_frac: float, p: SystemParams,
                              t0: float):
    """min_{f, f~} E  s.t.  T <= t0, f <= f_max, f~ <= f~_max.

    The KKT point splits the deadline tau_a : tau_s = A^{1/3} : B^{1/3},
    clipped to the frequency boxes.  Returns (e_min, f_opt, f_server_opt)
    or (inf, nan, nan) if the deadline is unmeetable at max frequencies.
    """
    w = workload_frac
    ka, ks, ea, es = _workload_constants(p)
    tau_a_lo = ka * w          # at u = 1
    tau_s_lo = ks              # at u~ = 1
    if tau_a_lo + tau_s_lo > t0 * (1.0 + 1e-12):
        return math.inf, math.nan, math.nan
    a = ea * (w ** 3) * ka * ka
    b = es * ks * ks
    if a <= 0.0:  # degenerate: no agent workload
        tau_s = min(max(t0, tau_s_lo), t0)
        e = b / max(tau_s, _EPS) ** 2
        return e, 0.0, p.f_server_max * ks / max(tau_s, _EPS)
    if b <= 0.0:  # degenerate: no server workload (device-only split)
        tau_a = t0
        e = a / max(tau_a, _EPS) ** 2
        f_opt = p.f_max * ka * w / max(tau_a, _EPS)
        return e, min(f_opt, p.f_max), p.f_server_max
    r = (a / b) ** (1.0 / 3.0)
    tau_a = t0 * r / (1.0 + r)
    tau_a = min(max(tau_a, tau_a_lo), t0 - tau_s_lo)
    tau_s = t0 - tau_a
    e = a / tau_a ** 2 + b / tau_s ** 2
    f_opt = p.f_max * ka * w / tau_a
    fs_opt = p.f_server_max * ks / tau_s
    return e, min(f_opt, p.f_max), min(fs_opt, p.f_server_max)


def feasible_bitwidth(b_hat: float, p: SystemParams, t0: float,
                      e0: float, b_emb: Optional[float] = None
                      ) -> "tuple[bool, float, float, float]":
    """Can bit-width ``b_hat`` meet (T0, E0) at *some* frequency pair?
    Returns ``(ok, f, f_server, e_min)``."""
    t0, e0 = net_budgets(p, t0, e0, b_emb)
    if t0 <= 0.0 or e0 <= 0.0:
        return False, math.nan, math.nan, math.inf
    w = b_hat / p.b_full
    e_min, f, fs = min_energy_under_deadline(w, p, t0)
    if math.isfinite(e_min) and e_min <= e0 * (1.0 + 1e-9):
        return True, f, fs, e_min
    return False, math.nan, math.nan, e_min


# ---------------------------------------------------------------------------
# Solution record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodesignSolution:
    b_hat: int                  # chosen bit-width
    f: float                    # device frequency (Hz)
    f_server: float             # server frequency (Hz)
    objective: float            # D^U - D^L gap at b_hat
    d_upper: float              # conservative distortion estimate
    d_lower: float              # optimistic floor
    delay: float                # realized T at the solution
    energy: float               # realized E at the solution
    feasible: bool
    iterations: int = 0         # SCA outer iterations (0 for oracle)
    b_relaxed: float = float("nan")  # pre-rounding b~* (SCA only)


def _pack(b_hat: int, f: float, fs: float, lam: float, p: SystemParams,
          iterations: int = 0, b_relaxed: float = float("nan"),
          feasible: bool = True,
          b_emb: Optional[float] = None) -> CodesignSolution:
    t = float(total_delay(b_hat, f, fs, p, b_emb=b_emb))
    e = float(total_energy(b_hat, f, fs, p, b_emb=b_emb))
    r = b_hat - 1.0
    return CodesignSolution(
        b_hat=b_hat, f=f, f_server=fs,
        objective=distortion_gap(b_hat, lam),
        d_upper=_d_upper(r, lam), d_lower=_d_lower(r, lam),
        delay=t, energy=e, feasible=feasible, iterations=iterations,
        b_relaxed=b_relaxed)


# ---------------------------------------------------------------------------
# Oracle: exhaustive over the discrete bit-width set
# ---------------------------------------------------------------------------

def solve_oracle(lam: float, p: SystemParams, t0: float, e0: float,
                 b_max: int = 16, b_emb: Optional[float] = None
                 ) -> Optional[CodesignSolution]:
    """Exact (P1): the objective decreases in b_hat, so the optimum is the
    largest feasible bit-width with its min-energy frequencies."""
    for b_hat in range(b_max, 0, -1):
        ok, f, fs, _ = feasible_bitwidth(b_hat, p, t0, e0, b_emb=b_emb)
        if ok:
            return _pack(b_hat, f, fs, lam, p, b_emb=b_emb)
    return None


# ---------------------------------------------------------------------------
# Degraded device-only fallback (the serving supervisor's failover)
# ---------------------------------------------------------------------------

def device_only_params(p: SystemParams) -> SystemParams:
    """The system with the split pinned fully on-agent: every server
    FLOP moves to the device, and the uplink disappears (no boundary
    embedding is ever transmitted, so transport delay/energy and the
    link rate are all zeroed).  This is (P1) restricted to the corner
    the paper's split makes first-class: when the server is
    unreachable the agent still holds the full model at some b̂."""
    return dataclasses.replace(
        p, n_flop_agent=p.n_flop_agent + p.n_flop_server,
        n_flop_server=0.0, link_bps=0.0, emb_bytes_full=0.0,
        tx_power_w=0.0)


def solve_device_only(lam: float, p: SystemParams, t0: float, e0: float,
                      b_max: int = 16) -> CodesignSolution:
    """(P1) over :func:`device_only_params`: the largest bit-width the
    agent can run the *whole* model at within (T0, E0), with the
    min-energy frequency assignment — the supervisor's degraded
    operating point when the server is unreachable.

    Never returns ``None``: if no bit-width meets both budgets the
    energy budget is relaxed (deadline kept), and failing that the
    solve pins b̂=1 at full frequency with ``feasible=False`` — a
    degraded agent keeps acting, it does not halt."""
    pl = device_only_params(p)
    for b_hat in range(b_max, 0, -1):
        ok, f, fs, _ = feasible_bitwidth(b_hat, pl, t0, e0)
        if ok:
            return _pack(b_hat, f, fs, lam, pl)
    for b_hat in range(b_max, 0, -1):
        ok, f, fs, _ = feasible_bitwidth(b_hat, pl, t0, math.inf)
        if ok:
            return _pack(b_hat, f, fs, lam, pl, feasible=False)
    return _pack(1, pl.f_max, pl.f_server_max, lam, pl, feasible=False)


# ---------------------------------------------------------------------------
# Algorithm 1: SCA on (P2)/(P3)/(P4.k)
# ---------------------------------------------------------------------------

def _solve_p4k(b_k: float, v_k: float, lam: float, p: SystemParams,
               t0: float, e0: float, b_max: int):
    """Exactly solve the convex subproblem (P4.k): the smallest feasible v
    by bisection, then a golden-section minimization of the surrogate
    objective over [1+eps, min(B_max, cap(v*))]."""

    def v_feasible(v: float) -> bool:
        w = 1.0 / (v * p.b_full)  # b~_effective / b  implied by v
        e_min, _, _ = min_energy_under_deadline(w, p, t0)
        return e_min <= e0 * (1.0 + 1e-9)

    v_hi = 1.0  # v = 1 -> effective bit-width 1: the cheapest workload
    if not v_feasible(v_hi):
        return None
    v_lo = 1.0 / b_max
    if v_feasible(v_lo):
        v_star = v_lo
    else:
        lo, hi = v_lo, v_hi
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if v_feasible(mid):
                hi = mid
            else:
                lo = mid
        v_star = hi

    cap = 1.0 / v_k - (v_star - v_k) / (v_k * v_k)
    b_hi = min(float(b_max), cap)
    b_lo = 1.0 + 1e-6
    if b_hi < b_lo:
        b_hi = b_lo

    lin_slope = math.log(2.0) / (lam * 2.0 ** b_k)

    def surrogate(b: float) -> float:
        return _d_upper(b - 1.0, lam) \
            - (1.0 / (lam * 2.0 ** b_k) - lin_slope * (b - b_k))

    phi = (math.sqrt(5.0) - 1.0) / 2.0
    lo, hi = b_lo, b_hi
    c = hi - phi * (hi - lo)
    d = lo + phi * (hi - lo)
    fc, fd = surrogate(c), surrogate(d)
    for _ in range(200):
        if hi - lo < 1e-10:
            break
        if fc < fd:
            hi, d, fd = d, c, fc
            c = hi - phi * (hi - lo)
            fc = surrogate(c)
        else:
            lo, c, fc = c, d, fd
            d = lo + phi * (hi - lo)
            fd = surrogate(d)
    b_star = 0.5 * (lo + hi)

    w = 1.0 / (v_star * p.b_full)
    _, f, fs = min_energy_under_deadline(w, p, t0)
    return b_star, v_star, f, fs


def solve_sca(lam: float, p: SystemParams, t0: float, e0: float,
              b_max: int = 16, tol: float = 1e-6, max_iters: int = 64,
              b_emb: Optional[float] = None) -> Optional[CodesignSolution]:
    """Algorithm 1 (paper).  Returns None when (P1) is infeasible."""
    t0_net, e0_net = net_budgets(p, t0, e0, b_emb)
    if t0_net <= 0.0 or e0_net <= 0.0:
        return None
    t0, e0 = t0_net, e0_net
    ok1, _, _, _ = feasible_bitwidth(1.0, p, t0, e0)
    if not ok1:
        return None
    b_k, v_k = 1.0 + 1e-3, 1.0 / (1.0 + 1e-3)
    prev_obj = math.inf
    iters = 0
    for k in range(1, max_iters + 1):
        iters = k
        out = _solve_p4k(b_k, v_k, lam, p, t0, e0, b_max)
        if out is None:
            return None
        b_star, v_star, _, _ = out
        obj = distortion_gap(b_star, lam)
        b_k, v_k = b_star, v_star
        # relative decrease: the objective scales like 1/lam
        if prev_obj - obj < tol * max(abs(prev_obj), _EPS):
            break
        prev_obj = obj

    b_round = max(1, min(b_max, int(round(b_k))))
    for b_hat in range(b_round, 0, -1):
        ok, f_r, fs_r, _ = feasible_bitwidth(b_hat, p, t0, e0)
        if ok:
            return _pack(b_hat, f_r, fs_r, lam, p, iterations=iters,
                         b_relaxed=b_k, b_emb=b_emb)
    return None


# ---------------------------------------------------------------------------
# Decode extension: the KV-cache bit-width as a third allocated variable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeSolution:
    """(P1) extended with the stored KV-cache bit-width.

    ``inner`` is the (b̂, f, f̃) solution against the budgets left after
    the cache takes its share at ``b_kv``; ``objective`` is the joint gap
    ``inner.objective + kv_weight · gap(b_kv; λ_kv)``.
    """

    b_kv: int                   # stored KV-cache bit-width
    inner: CodesignSolution     # (b̂, f, f̃) solve under the net budgets
    objective: float            # joint weight + cache distortion gap
    kv_gap: float               # cache share of the objective (unweighted)
    delay: float                # realized T including the cache read
    energy: float               # realized E including cache access energy

    @property
    def b_hat(self) -> int:
        return self.inner.b_hat

    @property
    def f(self) -> float:
        return self.inner.f

    @property
    def f_server(self) -> float:
        return self.inner.f_server

    @property
    def feasible(self) -> bool:
        return self.inner.feasible


def solve_decode(lam: float, lam_kv: float, p: SystemParams, t0: float,
                 e0: float, b_max: int = 16,
                 b_emb: Optional[float] = None,
                 kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                 kv_weight: float = 1.0) -> Optional[DecodeSolution]:
    """Joint (b̂, f, f̃, b_kv) solve for decode serving.

    For each rung of the realizable container ladder: deduct the cache's
    delay/energy share from (T0, E0), run Algorithm 1 on what is left, and
    score the weight gap at λ plus ``kv_weight`` times the cache gap at
    λ_kv.  Returns the rung with the least joint gap, or None when every
    rung is infeasible.
    """
    best: Optional[DecodeSolution] = None
    for b_kv in kv_ladder:
        t0_net, e0_net = net_budgets(p, t0, e0, None, b_kv=b_kv)
        if t0_net <= 0.0 or e0_net <= 0.0:
            continue
        inner = solve_sca(lam, p, t0_net, e0_net, b_max, b_emb=b_emb)
        if inner is None:
            continue
        kv_gap = distortion_gap(b_kv, lam_kv)
        cand = DecodeSolution(
            b_kv=int(b_kv), inner=inner,
            objective=inner.objective + kv_weight * kv_gap,
            kv_gap=kv_gap,
            delay=inner.delay + float(kv_delay(b_kv, p)),
            energy=inner.energy + float(kv_energy(b_kv, p)))
        if best is None or cand.objective < best.objective:
            best = cand
    return best


# ---------------------------------------------------------------------------
# Speculative draft model (the reference's DESIGN.md §16)
# ---------------------------------------------------------------------------

# acceptance sharpness: how fast the modeled per-token acceptance decays
# with the draft's normalized distortion bound (b_draft = 2/4/8 ->
# alpha ~ 0.29/0.78/0.98)
SPEC_GAMMA = 2.0


def acceptance_from_distortion(d_rel: float,
                               gamma: float = SPEC_GAMMA) -> float:
    """Modeled per-token draft acceptance ``exp(-gamma d)`` from the
    draft's normalized distortion bound ``d_rel = lam D^U(b_draft - 1)``:
    1 at zero distortion, in [0, 1], non-increasing in the distortion."""
    return math.exp(-gamma * max(float(d_rel), 0.0))


def acceptance_rate(b_draft: float, lam: float,
                    gamma: float = SPEC_GAMMA) -> float:
    """Acceptance estimate for a draft quantized at ``b_draft`` bits; D^U
    scales like 1/lam, so lam cancels and only the bit-width matters."""
    return acceptance_from_distortion(
        lam * _d_upper(b_draft - 1.0, lam), gamma)


def expected_tokens_per_round(alpha: float, k: int) -> float:
    """E[delivered tokens per round] with lookahead ``k`` under i.i.d.
    acceptance ``alpha``: ``sum_{i=0..k} alpha^i``, in [1, k + 1]."""
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclasses.dataclass(frozen=True)
class SpeculativeSolution:
    """(P1) extended with the draft bit-width and lookahead.

    ``inner`` is the decode-style (b̂, f, f̃, b_kv) solution against the
    budgets left after the per-round draft, uplink, cache and rollback
    overheads take their per-delivered-token share, with the batched
    verify forward's 1/τ workload folded into the FLOP counts;
    ``objective`` is the joint distortion gap per expected delivered
    token.
    """

    b_draft: int                # draft bit-width (agent partition)
    k: int                      # lookahead: drafted tokens per round
    alpha: float                # modeled per-token acceptance
    tokens_per_round: float     # tau = E[delivered per round] in [1, k+1]
    inner: DecodeSolution       # (b̂, f, f̃, b_kv) under the net budgets
    objective: float            # joint gap / tau
    delay: float                # expected per-delivered-token delay
    energy: float               # expected per-delivered-token energy

    @property
    def b_hat(self) -> int:
        return self.inner.b_hat

    @property
    def b_kv(self) -> int:
        return self.inner.b_kv

    @property
    def f(self) -> float:
        return self.inner.f

    @property
    def f_server(self) -> float:
        return self.inner.f_server

    @property
    def kv_gap(self) -> float:
        return self.inner.kv_gap

    @property
    def feasible(self) -> bool:
        return self.inner.feasible


def solve_speculative(lam: float, lam_kv: float, p: SystemParams,
                      t0: float, e0: float, b_max: int = 16,
                      b_emb: Optional[float] = None,
                      kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                      kv_weight: float = 1.0,
                      draft_ladder: "tuple[int, ...]" = (2, 4, 8),
                      lookahead: "tuple[int, ...]" = (2, 4, 8),
                      gamma: float = SPEC_GAMMA
                      ) -> Optional[SpeculativeSolution]:
    """Joint (b̂, f, f̃, b_kv, b_draft, k) solve for speculative decode.

    For each (b_kv, b_draft, k): the modeled acceptance α(b_draft) gives
    the expected delivered tokens per round τ = Σ αⁱ; the per-round
    overheads (``k`` drafts at ``f_max``, one uplink, ``k + 1`` cache
    reads, the expected rollback) come off (T0, E0) at their
    per-delivered-token share, and Algorithm 1 runs on the rest with the
    verify forward's workload scaled by 1/τ (one weight pass a round).
    The score is the joint distortion gap per expected delivered token;
    the least wins.  (T0, E0) are per-delivered-token budgets.  Returns
    None when every point is infeasible.
    """
    best: Optional[SpeculativeSolution] = None
    for b_kv in kv_ladder:
        for b_draft in draft_ladder:
            alpha = acceptance_rate(b_draft, lam, gamma)
            for k in lookahead:
                tau = expected_tokens_per_round(alpha, k)
                t_oh = (draft_delay(b_draft, k, p)
                        + (k + 1) * kv_delay(b_kv, p)
                        + rollback_delay(b_kv, max(k + 1 - tau, 0.0), p))
                e_oh = (draft_energy(b_draft, k, p)
                        + (k + 1) * kv_energy(b_kv, p)
                        + rollback_energy(b_kv, max(k + 1 - tau, 0.0), p))
                if b_emb is not None:
                    t_oh += float(transport_delay(b_emb, p))
                    e_oh += float(transport_energy(b_emb, p))
                t_net = t0 - t_oh / tau
                e_net = e0 - e_oh / tau
                if t_net <= 0.0 or e_net <= 0.0:
                    continue
                scale = 1.0 / tau
                p_v = dataclasses.replace(
                    p, n_flop_agent=p.n_flop_agent * scale,
                    n_flop_server=p.n_flop_server * scale)
                inner = solve_sca(lam, p_v, t_net, e_net, b_max)
                if inner is None:
                    continue
                kv_gap = distortion_gap(b_kv, lam_kv)
                joint = inner.objective + kv_weight * kv_gap
                delay = speculative_round_delay(
                    inner.b_hat, inner.f, inner.f_server, b_draft, k,
                    tau, p, b_emb=b_emb, b_kv=b_kv) / tau
                energy = speculative_round_energy(
                    inner.b_hat, inner.f, inner.f_server, b_draft, k,
                    tau, p, b_emb=b_emb, b_kv=b_kv) / tau
                dec = DecodeSolution(
                    b_kv=int(b_kv), inner=inner, objective=joint,
                    kv_gap=kv_gap, delay=delay, energy=energy)
                cand = SpeculativeSolution(
                    b_draft=int(b_draft), k=int(k), alpha=alpha,
                    tokens_per_round=tau, inner=dec,
                    objective=joint / tau, delay=delay, energy=energy)
                if best is None or cand.objective < best.objective:
                    best = cand
    return best
