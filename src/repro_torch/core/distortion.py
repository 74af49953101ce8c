"""Quantization-induced output distortion (paper §III;
``repro/core/distortion.py``).

  * Proposition 3.1, the layered chain upper bound for FC DNNs:
        ||f(x,W) - f(x,W_hat)||_1 <= sum_l A^(l) ||W^(l) - W_hat^(l)||_1
    with A^(l) = prod_{j<l} ||W^(j)||_1 * prod_{k>l} (||W^(k)||_1 + tau^(k)),
    the matrix norm being the induced L1 norm (max column abs sum);
  * the surrogate parameter distortion d(W, W_hat) = ||W - W_hat||_1
    (eq. 15), elementwise L1 over a whole parameter tree;
  * the first-order Taylor surrogate for general models (eq. 16-17) with
    an empirical gradient-norm constant H;
  * the measured output distortion that Fig. 3 plots.

A parameter tree is a tensor, a list or tuple of trees, or a dict of trees
(visited in sorted-key order, the reference's pytree order).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from ..models.lm import tree_leaves

__all__ = [
    "induced_l1_norm",
    "elementwise_l1",
    "param_distortion",
    "chain_bound_coefficients",
    "fc_chain_bound",
    "measured_output_distortion",
    "taylor_surrogate_bound",
    "estimate_grad_norm_H",
]


def induced_l1_norm(w: torch.Tensor) -> torch.Tensor:
    """Induced (operator) L1 norm: the largest column abs-sum, so that
    ||W x||_1 <= ||W||_1 ||x||_1.  W is [out, in]; a tensor of more dims
    is read as [out, in*]."""
    if w.ndim != 2:
        w = w.reshape(w.shape[0], -1)
    return torch.max(torch.sum(torch.abs(w), dim=0))


def elementwise_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum |a - b|: the entrywise L1 of the surrogate metric."""
    return torch.sum(torch.abs(a - b))


def param_distortion(params: Any, params_hat: Any) -> torch.Tensor:
    """d(W, W_hat) = ||W - W_hat||_1 over a whole tree (paper eq. 15)."""
    terms = [elementwise_l1(a, b)
             for a, b in zip(tree_leaves(params), tree_leaves(params_hat))]
    return torch.sum(torch.stack(terms)) if terms \
        else torch.tensor(0.0, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Proposition 3.1 for FC DNNs
# ---------------------------------------------------------------------------

def chain_bound_coefficients(weights: Sequence[torch.Tensor],
                             taus: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
    """A^(l) of Prop. 3.1 (eq. 14) for the layers in order.

    ``weights`` are the unquantized matrices W^(1..L) ([out, in]), ``taus``
    the per-layer error bounds of Assumption 3 (induced L1)."""
    n = len(weights)
    norms = [induced_l1_norm(w) for w in weights]
    one = torch.tensor(1.0, dtype=torch.float32, device=norms[0].device)
    coeffs = []
    for l in range(n):
        pre = torch.prod(torch.stack(norms[:l])) if l > 0 else one
        post = torch.prod(torch.stack(
            [norms[k] + taus[k] for k in range(l + 1, n)])) \
            if l < n - 1 else one
        coeffs.append(pre * post)
    return coeffs


def fc_chain_bound(weights: Sequence[torch.Tensor],
                   weights_hat: Sequence[torch.Tensor]) -> torch.Tensor:
    """Right-hand side of Prop. 3.1 for a concrete quantization, with
    tau^(l) the realized induced-L1 error of layer l (Assumption 3 with
    equality)."""
    taus = [induced_l1_norm(w - wh) for w, wh in zip(weights, weights_hat)]
    coeffs = chain_bound_coefficients(weights, taus)
    return torch.sum(torch.stack([c * t for c, t in zip(coeffs, taus)]))


def measured_output_distortion(apply_fn: Callable[[Any, torch.Tensor],
                                                  torch.Tensor],
                               params: Any, params_hat: Any,
                               x: torch.Tensor) -> torch.Tensor:
    """||f(x,W) - f(x,W_hat)||_1 averaged over the batch (Fig. 3)."""
    d = torch.abs(apply_fn(params, x) - apply_fn(params_hat, x))
    return torch.sum(d) / (d.shape[0] if d.ndim > 1 else 1)


# ---------------------------------------------------------------------------
# General-model Taylor surrogate (Remark 3.2)
# ---------------------------------------------------------------------------

def estimate_grad_norm_H(apply_fn: Callable[[Any, torch.Tensor],
                                            torch.Tensor],
                         params: Any, xs: torch.Tensor) -> torch.Tensor:
    """Empirical H >= ||grad_W f(x, W)||_1: the largest, over the inputs
    ``xs``, of the L1 norm of the gradient of sum(f(x, W)) with respect to
    every parameter (per-example gradients through ``torch.func``)."""
    def scalar_out(p, x):
        return torch.sum(apply_fn(p, x[None, ...]))

    def one(x):
        g = torch.func.grad(scalar_out)(params, x)
        return torch.sum(torch.stack([torch.sum(torch.abs(a))
                                      for a in tree_leaves(g)]))

    return torch.max(torch.func.vmap(one)(xs))


def taylor_surrogate_bound(H: torch.Tensor, params: Any,
                           params_hat: Any) -> torch.Tensor:
    """Eq. (17): ||f(x,W_hat) - f(x,W)||_1 <~ H ||W - W_hat||_1."""
    return H * param_distortion(params, params_hat)
