"""Rate-distortion analysis of weight quantization (paper §IV;
``repro/core/rate_distortion.py``).

Weight magnitudes are modeled i.i.d. Exponential(lam) (paper eq. (3)).
Under the L1 distortion ``d(theta, theta_hat) = |theta - theta_hat|``:

  * Proposition 4.1 (Shannon-type lower bound):
        R(D) >= -log2(2 lam D)          <=>  D^L(R) = 1 / (lam 2^{R+1})
  * Proposition 4.2 (Laplacian test-channel upper bound):
        R(D) <= log2(1/(lam D) + lam D/(lam D + 1))
        <=>  D^U(R) = (1/(2 lam)) (sqrt(1 + 4/(2^R - 1)) - 1)

plus a numerical Blahut-Arimoto estimate of the true D(R), which must sit
between the two bounds (paper Fig. 4).  The closed forms take floats or
tensors and return float32 tensors with the reference's arithmetic: what
it computes on Python floats (before its first ``jnp`` call) stays Python
float64 here, the rest is float32.  Blahut-Arimoto runs every Lagrange
multiplier of its sweep at once, as one batched torch loop on the chosen
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "exponential_mle",
    "exponential_entropy",
    "rate_lower_bound",
    "rate_upper_bound",
    "distortion_lower_bound",
    "distortion_upper_bound",
    "codesign_objective",
    "BlahutArimotoResult",
    "blahut_arimoto_distortion_rate",
]

_TINY = torch.finfo(torch.float32).tiny


def _f32(x) -> torch.Tensor:
    """A float32 tensor of ``x`` (a Python number or a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Source statistics
# ---------------------------------------------------------------------------

def exponential_mle(magnitudes: torch.Tensor) -> torch.Tensor:
    """MLE of the Exponential rate, ``1 / mean(|theta|)`` over every
    element, guarded to stay finite for an all-zero input."""
    m = torch.mean(torch.abs(magnitudes.to(torch.float32)))
    return 1.0 / torch.clamp(m, min=_TINY)


def exponential_entropy(lam) -> torch.Tensor:
    """Differential entropy h(Theta) = log2(e / lam) (paper eq. (21))."""
    return torch.log2(_f32(math.e / lam))


# ---------------------------------------------------------------------------
# Analytic bounds (Propositions 4.1 and 4.2)
# ---------------------------------------------------------------------------

def rate_lower_bound(distortion, lam) -> torch.Tensor:
    """R^L(D) = -log2(2 lam D)  (paper eq. (23))."""
    return -torch.log2(_f32(2.0 * lam * distortion))


def distortion_lower_bound(rate, lam) -> torch.Tensor:
    """D^L(R) = 1 / (lam 2^{R+1})  (paper eq. (24))."""
    return 1.0 / (lam * torch.exp2(_f32(rate + 1.0)))


def rate_upper_bound(distortion, lam) -> torch.Tensor:
    """R^U(D) = log2( 1/(lam D) + lam D / (lam D + 1) )  (paper eq. (25))."""
    ld = lam * distortion
    return torch.log2(_f32(1.0 / ld + ld / (ld + 1.0)))


def distortion_upper_bound(rate, lam) -> torch.Tensor:
    """D^U(R) = (1/(2 lam)) (sqrt(1 + 4/(2^R - 1)) - 1)  (paper eq. (26)).

    The denominator is clamped at float32's smallest normal, so rate -> 0+
    gives a large but finite distortion, as in the reference."""
    denom = torch.clamp(torch.exp2(_f32(rate)) - 1.0, min=_TINY)
    return (torch.sqrt(1.0 + 4.0 / denom) - 1.0) / (2.0 * lam)


def codesign_objective(bitwidth, lam) -> torch.Tensor:
    """The (P1)/(P2) objective D^U(b-1) - D^L(b-1): one bit of a b-bit
    code goes to the sign, so the magnitude source gets rate b - 1."""
    r = bitwidth - 1.0
    return distortion_upper_bound(r, lam) - distortion_lower_bound(r, lam)


# ---------------------------------------------------------------------------
# Blahut-Arimoto numerical D(R) (paper Fig. 4 reference curve)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlahutArimotoResult:
    """One (rate, distortion) sweep point per Lagrange multiplier."""

    rates: np.ndarray        # bits per symbol
    distortions: np.ndarray  # mean |theta - theta_hat|
    betas: np.ndarray        # Lagrange multipliers used for the sweep


def _ba_all_betas(p_x: torch.Tensor, dmat: torch.Tensor,
                  betas: torch.Tensor, n_iters: int):
    """The classic Blahut-Arimoto iteration for every multiplier at once.

    ``p_x`` [S] is the source pmf, ``dmat`` [S, Shat] the distortion
    matrix, ``betas`` [NB]; each multiplier's arithmetic is the
    reference's ``_ba_fixed_beta``.  Returns (rates_bits, distortions),
    each [NB].  A marginal entry that underflows to 0 gives ``log q =
    -inf`` and, where its joint mass is 0, a NaN rate, as in the
    reference: nothing is clamped that the reference does not clamp.
    """
    shat = dmat.shape[1]
    bd = betas[:, None, None] * dmat[None]                 # [NB, S, Shat]
    q = torch.full((betas.shape[0], shat), 1.0 / shat, dtype=torch.float32,
                   device=dmat.device)

    def channel(q):
        log_w = torch.log(q)[:, None, :] - bd
        return log_w - torch.logsumexp(log_w, dim=2, keepdim=True)

    for _ in range(n_iters):
        q_new = torch.matmul(p_x, torch.exp(channel(q)))   # [NB, Shat]
        q = q_new / torch.sum(q_new, dim=1, keepdim=True)
    log_w = channel(q)
    w = torch.exp(log_w)
    joint = p_x[None, :, None] * w
    distortion = torch.sum(joint * dmat[None], dim=(1, 2))
    q_marg = torch.clamp(torch.matmul(p_x, w), min=1e-30)
    mi = torch.sum(joint * (log_w - torch.log(q_marg)[:, None, :]),
                   dim=(1, 2)) / math.log(2.0)
    return mi, distortion


def blahut_arimoto_distortion_rate(
    lam: float,
    *,
    n_source: int = 256,
    n_repro: int = 256,
    theta_max_quantiles: float = 0.9999,
    betas: "np.ndarray | None" = None,
    n_iters: int = 300,
    device=None,
) -> BlahutArimotoResult:
    """Numerically estimate D(R) for Exponential(lam) under |.| distortion.

    The continuous source is discretized on a grid up to the
    ``theta_max_quantiles`` quantile (in float64 numpy, then cast to
    float32, as the reference builds it), the reproduction alphabet spans
    the same range, and the discrete problem is solved by Blahut-Arimoto
    per multiplier beta; sweeping beta traces out D(R).  Runs on the CUDA
    card unless ``device="cpu"`` is asked for.
    """
    dev = resolve_device(device)
    if betas is None:
        betas = np.geomspace(0.05 * lam, 2000.0 * lam, 48)
    theta_max = -np.log1p(-theta_max_quantiles) / lam  # exponential quantile
    src = np.linspace(0.0, theta_max, n_source)
    pdf = lam * np.exp(-lam * src)
    p_x = pdf / pdf.sum()
    repro = np.linspace(0.0, theta_max, n_repro)
    dmat = np.abs(src[:, None] - repro[None, :])

    with torch.no_grad():
        rates, dists = _ba_all_betas(
            torch.as_tensor(p_x, dtype=torch.float32, device=dev),
            torch.as_tensor(dmat, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(betas, np.float32), device=dev),
            n_iters)
    return BlahutArimotoResult(
        rates=rates.cpu().numpy().astype(np.float64),
        distortions=dists.cpu().numpy().astype(np.float64),
        betas=np.asarray(betas))
