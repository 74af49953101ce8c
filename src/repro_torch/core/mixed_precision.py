"""Layer-wise mixed-precision bit allocation
(``repro/core/mixed_precision.py``).

The uniform codesign of ``codesign.py`` fits one global λ and assigns one
b̂ to the whole agent partition.  The paper's bounds are finer grained:
D^U of Prop. 4.2 is a function of a per-layer rate λ^(l), and the chain
bound of Prop. 3.1 weighs layer l's parameter distortion by a sensitivity
A^(l).  This module uses both:

  * :func:`decoder_layer_stats` — λ^(l)
    (``rate_distortion.exponential_mle``) and A^(l)
    (``distortion.chain_bound_coefficients``) over the agent layers of a
    layer-stacked DecoderLM parameter tree; tensor statistics in float32
    on the tree's device;
  * :func:`allocate_bits` — minimize Σ_l A^(l) · D^U(b_l - 1; λ_l) over
    b_l ∈ {1..B_max} under the (T0, E0) feasibility of (P1), by greedy
    marginal-gain descent under the total-bit budget the frequency
    subproblem implies (exact for this separable convex objective), and
    its decode (``b_kv``) and speculative (``b_draft``, ``k``) extensions;
  * :func:`plan_from_bits` — the :class:`QuantPlan` the engines serve.

The agent layers are FLOP-homogeneous, so delay and energy depend on an
allocation only through its mean bit-width: (T0, E0) maps to the largest
feasible mean B* (bisection), and the problem becomes "spend ⌊B*·L⌋ bits
over L layers".  The decision math is float64 on the host.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.lm import tree_leaves
from .codesign import (_d_upper, acceptance_rate, distortion_gap,
                       expected_tokens_per_round, min_energy_under_deadline,
                       net_budgets)
from .cost_model import (SystemParams, draft_delay, draft_energy, kv_delay,
                         kv_energy, rollback_delay, rollback_energy,
                         speculative_round_delay, speculative_round_energy,
                         total_delay, total_energy, transport_delay,
                         transport_energy)
from .distortion import chain_bound_coefficients, induced_l1_norm
from .quantization import QuantConfig, QuantPlan, quantize_dequantize
from .rate_distortion import exponential_mle

__all__ = [
    "LayerStats",
    "MixedSolution",
    "agent_layer_matrices",
    "layer_lambdas",
    "layer_sensitivities",
    "decoder_layer_stats",
    "max_mean_bits",
    "best_uniform_bits",
    "allocation_objective",
    "uniform_objective",
    "allocate_bits",
    "MixedDecodeSolution",
    "allocate_bits_decode",
    "MixedSpeculativeSolution",
    "allocate_bits_speculative",
    "plan_from_bits",
]


# ---------------------------------------------------------------------------
# Per-layer statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Per-agent-layer rate-distortion statistics.

    ``lam[l]`` is the Exponential MLE rate of layer l's weight magnitudes;
    ``sens[l]`` its chain-bound sensitivity A^(l), normalized so that
    min(sens) == 1 (only ratios matter to the allocation).
    """

    lam: tuple
    sens: tuple

    def __post_init__(self):
        object.__setattr__(self, "lam", tuple(float(x) for x in self.lam))
        object.__setattr__(self, "sens", tuple(float(x) for x in self.sens))
        if len(self.lam) != len(self.sens):
            raise ValueError("lam and sens must have equal length")
        if not self.lam:
            raise ValueError("need at least one layer")

    @property
    def n_layers(self) -> int:
        return len(self.lam)

    def key(self) -> tuple:
        """Hashable cache key (rounded so float jitter can't split it)."""
        return (tuple(round(x, 10) for x in self.lam),
                tuple(round(x, 10) for x in self.sens))


def agent_layer_matrices(params, split: int) -> list:
    """Per-layer 2-D weight matrices of the agent partition.

    Every floating leaf of ``params["layers"]`` with ndim >= 3, in the
    reference's leaf order (sorted keys), contributes its slice of each
    layer l < split, as ``[out, in*]`` (the port's matrices are
    ``[in, out]``, so the reference's transpose applies)."""
    out = [[] for _ in range(split)]
    for leaf in tree_leaves(params["layers"]):
        if not (leaf.ndim >= 3 and torch.is_floating_point(leaf)):
            continue
        for l in range(min(split, leaf.shape[0])):
            w = leaf[l]
            out[l].append(w.reshape(-1, w.shape[-1]).T)
    if any(not mats for mats in out):
        raise ValueError(f"no stacked weight leaves for some of the "
                         f"{split} agent layers")
    return out


def layer_lambdas(layer_mats: Sequence[Sequence[torch.Tensor]]) -> np.ndarray:
    """λ^(l): the Exponential MLE over all of layer l's weight magnitudes."""
    return np.asarray(
        [float(exponential_mle(torch.cat([m.reshape(-1) for m in mats])))
         for mats in layer_mats], np.float64)


def layer_sensitivities(layer_mats: Sequence[Sequence[torch.Tensor]],
                        ref_bits: int = 8) -> np.ndarray:
    """Chain-bound coefficients A^(l) of Prop. 3.1 over the agent layers.

    Each layer is represented by its matrix of largest induced-L1 norm
    (the first on a tie), and τ^(l) is that matrix's realized induced-L1
    error under the eager per-channel uniform quantizer at ``ref_bits``
    (true division, as the reference runs it).  The full-precision server
    layers multiply every A^(l) by one common factor and are left out."""
    reps = []
    for mats in layer_mats:
        norms = [float(induced_l1_norm(m)) for m in mats]
        reps.append(mats[int(np.argmax(norms))])
    cfg = QuantConfig(bits=ref_bits, scheme="uniform",
                      granularity="per-channel")
    taus = [induced_l1_norm(w - quantize_dequantize(w, cfg)) for w in reps]
    coeffs = np.asarray([float(c) for c in
                         chain_bound_coefficients(reps, taus)], np.float64)
    return coeffs / max(float(coeffs.min()), 1e-300)


def decoder_layer_stats(params, split: int, ref_bits: int = 8) -> LayerStats:
    """λ^(l) and A^(l) for the agent partition of a stacked-layers model."""
    with torch.no_grad():
        mats = agent_layer_matrices(params, split)
        return LayerStats(lam=tuple(layer_lambdas(mats)),
                          sens=tuple(layer_sensitivities(mats, ref_bits)))


# ---------------------------------------------------------------------------
# Feasibility: the (T0, E0) region as a mean-bit budget
# ---------------------------------------------------------------------------

def _mean_bits_feasible(mean_b: float, p: SystemParams, t0: float,
                        e0: float) -> bool:
    e_min, _, _ = min_energy_under_deadline(mean_b / p.b_full, p, t0)
    return e_min <= e0 * (1.0 + 1e-9)


def max_mean_bits(p: SystemParams, t0: float, e0: float,
                  b_max: int = 16,
                  b_emb: Optional[float] = None) -> Optional[float]:
    """Largest mean agent bit-width meeting (T0, E0), or None when mean 1
    is infeasible (bisection: feasibility is monotone in the mean).
    ``b_emb`` deducts the uplink's share of the budgets first."""
    t0, e0 = net_budgets(p, t0, e0, b_emb)
    if t0 <= 0.0 or e0 <= 0.0:
        return None
    if not _mean_bits_feasible(1.0, p, t0, e0):
        return None
    if _mean_bits_feasible(float(b_max), p, t0, e0):
        return float(b_max)
    lo, hi = 1.0, float(b_max)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _mean_bits_feasible(mid, p, t0, e0):
            lo = mid
        else:
            hi = mid
    return lo


def best_uniform_bits(p: SystemParams, t0: float, e0: float,
                      b_max: int = 16,
                      b_emb: Optional[float] = None) -> Optional[int]:
    """Largest feasible uniform b̂ (what ``solve_oracle`` assigns)."""
    b_star = max_mean_bits(p, t0, e0, b_max, b_emb=b_emb)
    return None if b_star is None else int(math.floor(b_star + 1e-9))


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------

def allocation_objective(stats: LayerStats, bits: Sequence[int]) -> float:
    """Σ_l A^(l) · D^U(b_l - 1; λ_l): the plan's distortion bound."""
    return float(sum(a * _d_upper(b - 1.0, lam)
                     for a, lam, b in zip(stats.sens, stats.lam, bits)))


def uniform_objective(stats: LayerStats, b_hat: int) -> float:
    """The same bound under a uniform b̂."""
    return allocation_objective(stats, [b_hat] * stats.n_layers)


@dataclasses.dataclass(frozen=True)
class MixedSolution:
    """One per-layer bit allocation and its frequency assignment."""

    bits: tuple                 # per agent layer, len == stats.n_layers
    f: float                    # device frequency realizing feasibility
    f_server: float
    objective: float            # Σ A^(l) D^U(b_l - 1; λ_l)
    uniform_b: int              # best uniform b̂ under the same (T0, E0)
    uniform_objective: float    # the bound that uniform b̂ achieves
    mean_bits: float
    delay: float                # realized T at mean_bits
    energy: float               # realized E at mean_bits
    feasible: bool = True

    @property
    def b_hat(self) -> int:
        """Integer summary bit-width (display and report fields)."""
        return int(round(self.mean_bits))


def allocate_bits(stats: LayerStats, p: SystemParams, t0: float, e0: float,
                  b_max: int = 16,
                  b_emb: Optional[float] = None) -> Optional[MixedSolution]:
    """Greedy bit allocation under the (P1) constraints.

    Every layer starts at 1 bit (None when even that is infeasible, as
    ``solve_sca``), then the budget is spent one bit at a time on the
    layer with the largest marginal decrease A^(l)·[D^U(b_l-1) - D^U(b_l)]
    (a heap of (-gain, layer): ties go to the lower layer).  ``b_emb``
    makes the frontier link-aware, as in ``codesign.solve_sca``."""
    b_star = max_mean_bits(p, t0, e0, b_max, b_emb=b_emb)
    if b_star is None:
        return None
    n = stats.n_layers
    budget = int(math.floor(b_star * n + 1e-9))   # total bits to spend
    bits = [1] * n
    budget -= n

    def gain(l: int, b: int) -> float:
        return stats.sens[l] * (_d_upper(b - 1.0, stats.lam[l])
                                - _d_upper(float(b), stats.lam[l]))

    heap = [(-gain(l, 1), l) for l in range(n)]
    heapq.heapify(heap)
    while budget > 0 and heap:
        _, l = heapq.heappop(heap)
        if bits[l] >= b_max:
            continue
        bits[l] += 1
        budget -= 1
        if bits[l] < b_max:
            heapq.heappush(heap, (-gain(l, bits[l]), l))

    mean_b = sum(bits) / n
    t0_net, _ = net_budgets(p, t0, e0, b_emb)
    _, f, fs = min_energy_under_deadline(mean_b / p.b_full, p, t0_net)
    u_b = int(math.floor(b_star + 1e-9))
    return MixedSolution(
        bits=tuple(bits), f=f, f_server=fs,
        objective=allocation_objective(stats, bits),
        uniform_b=u_b, uniform_objective=uniform_objective(stats, u_b),
        mean_bits=mean_b,
        delay=float(total_delay(mean_b, f, fs, p, b_emb=b_emb)),
        energy=float(total_energy(mean_b, f, fs, p, b_emb=b_emb)))


@dataclasses.dataclass(frozen=True)
class MixedDecodeSolution:
    """Per-layer weight allocation plus the stored KV-cache bit-width:
    ``inner`` is solved against the budgets left after the cache read at
    ``b_kv``, ``objective`` is the joint bound."""

    b_kv: int
    inner: MixedSolution
    objective: float            # inner.objective + kv_weight · gap(b_kv)
    kv_gap: float
    delay: float                # realized T including the cache read
    energy: float

    @property
    def bits(self) -> tuple:
        return self.inner.bits

    @property
    def f(self) -> float:
        return self.inner.f

    @property
    def f_server(self) -> float:
        return self.inner.f_server

    @property
    def mean_bits(self) -> float:
        return self.inner.mean_bits


def allocate_bits_decode(stats: LayerStats, lam_kv: float, p: SystemParams,
                         t0: float, e0: float, b_max: int = 16,
                         b_emb: Optional[float] = None,
                         kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                         kv_weight: float = 1.0
                         ) -> Optional[MixedDecodeSolution]:
    """Joint per-layer weight bits and KV-cache bit-width: enumerate the
    cache container ladder (``codesign.solve_decode``'s reduction), run
    the greedy allocator on what each rung leaves of (T0, E0), and keep
    the rung of least joint bound.  None when every rung is infeasible."""
    best: Optional[MixedDecodeSolution] = None
    for b_kv in kv_ladder:
        t0_net, e0_net = net_budgets(p, t0, e0, None, b_kv=b_kv)
        if t0_net <= 0.0 or e0_net <= 0.0:
            continue
        inner = allocate_bits(stats, p, t0_net, e0_net, b_max, b_emb=b_emb)
        if inner is None:
            continue
        kv_gap = distortion_gap(b_kv, lam_kv)
        cand = MixedDecodeSolution(
            b_kv=int(b_kv), inner=inner,
            objective=inner.objective + kv_weight * kv_gap,
            kv_gap=kv_gap,
            delay=inner.delay + float(kv_delay(b_kv, p)),
            energy=inner.energy + float(kv_energy(b_kv, p)))
        if best is None or cand.objective < best.objective:
            best = cand
    return best


@dataclasses.dataclass(frozen=True)
class MixedSpeculativeSolution:
    """Per-layer allocation, cache width and draft schedule (b_draft, k):
    ``inner`` is the decode-level allocation against per-delivered-token
    budgets, ``objective`` the joint bound over the expected tokens per
    round τ."""

    b_draft: int
    k: int
    alpha: float                # modeled acceptance rate
    tokens_per_round: float     # τ = E[delivered tokens / round]
    inner: MixedDecodeSolution
    objective: float            # (inner bound + kv gap) / τ
    delay: float                # per-token expected delay (round / τ)
    energy: float

    @property
    def bits(self) -> tuple:
        return self.inner.bits

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
    def mean_bits(self) -> float:
        return self.inner.mean_bits


def allocate_bits_speculative(stats: LayerStats, lam_kv: float,
                              p: SystemParams, t0: float, e0: float,
                              b_max: int = 16,
                              b_emb: Optional[float] = None,
                              kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                              kv_weight: float = 1.0,
                              draft_ladder: "tuple[int, ...]" = (2, 4, 8),
                              lookahead: "tuple[int, ...]" = (2, 4, 8),
                              ) -> Optional[MixedSpeculativeSolution]:
    """Joint per-layer bits, cache width and draft schedule.

    For every (b_kv, b_draft, k): the round's overhead (the draft chain at
    f_max, k + 1 cache streams, the expected rollback, one uplink) is
    spread over the τ expected delivered tokens and netted off (T0, E0),
    the forward's workload is scaled by 1/τ (one verify pass a round), and
    the greedy allocator runs on what is left.  None when every point is
    infeasible."""
    lam_mean = sum(stats.lam) / max(stats.n_layers, 1)
    best: Optional[MixedSpeculativeSolution] = None
    for b_kv in kv_ladder:
        for b_draft in draft_ladder:
            alpha = acceptance_rate(b_draft, lam_mean)
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
                inner = allocate_bits(stats, p_v, t_net, e_net, b_max)
                if inner is None:
                    continue
                kv_gap = distortion_gap(b_kv, lam_kv)
                joint = inner.objective + kv_weight * kv_gap
                delay = speculative_round_delay(
                    inner.mean_bits, inner.f, inner.f_server, b_draft, k,
                    tau, p, b_emb=b_emb, b_kv=b_kv) / tau
                energy = speculative_round_energy(
                    inner.mean_bits, inner.f, inner.f_server, b_draft, k,
                    tau, p, b_emb=b_emb, b_kv=b_kv) / tau
                dec = MixedDecodeSolution(
                    b_kv=int(b_kv), inner=inner, objective=joint,
                    kv_gap=kv_gap, delay=float(delay), energy=float(energy))
                cand = MixedSpeculativeSolution(
                    b_draft=int(b_draft), k=int(k), alpha=alpha,
                    tokens_per_round=tau, inner=dec,
                    objective=joint / tau,
                    delay=float(delay), energy=float(energy))
                if best is None or cand.objective < best.objective:
                    best = cand
    return best


def plan_from_bits(bits: Sequence[int], *, scheme: str = "uniform",
                   granularity: str = "per-channel",
                   group_size: int = 128,
                   default_bits: int = 16) -> QuantPlan:
    """An allocation as the plan the quantizers and engines consume; the
    layers beyond it (the server partition) resolve to ``default_bits``."""
    return QuantPlan.from_layer_bits(
        bits, scheme=scheme, granularity=granularity,
        group_size=group_size, default_bits=default_bits)
