"""FCDNN-16 (paper §VI-A; ``repro/models/fcdnn.py``): a fully connected
autoencoder with ReLU and 16 hidden layers, encoder dims
[64,128,256,512,256,128,64,32] and the symmetric decoder.

The model Proposition 3.1 is validated on (paper Fig. 3, left).  Weights
are a plain list of [out, in] matrices (the proof's convention: y = W x,
induced-L1 norms over columns), no biases, sigma = ReLU with sigma(0) = 0
(Assumption 2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..configs.fcdnn16 import DECODER_DIMS, ENCODER_DIMS, INPUT_DIM


def layer_dims(input_dim: int = INPUT_DIM) -> List[int]:
    """The 17 widths [in, 64, ..., 32, ..., 64, out]: 16 weight matrices
    (the reference's ``layer_dims``, whose docstring counts 17)."""
    return [input_dim, *ENCODER_DIMS, *DECODER_DIMS[1:], input_dim]


def init_fcdnn(generator: torch.Generator,
               dims: Optional[Sequence[int]] = None,
               scale: float = 0.5) -> List[torch.Tensor]:
    """He-style normal init scaled down (the chain bound is a product of
    induced norms; a wild init makes it vacuous), drawn from
    ``generator`` on its device."""
    dims = list(dims) if dims is not None else layer_dims()
    return [torch.randn((d_out, d_in), generator=generator,
                        device=generator.device)
            * (scale * (2.0 / d_in) ** 0.5)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def apply_fcdnn(weights: Sequence[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """f(x, W) = W^L relu(W^{L-1} relu(... W^1 x)).  x: [B, D_in]."""
    h = x
    for i, w in enumerate(weights):
        h = h @ w.T
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def mse_loss(weights: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Autoencoder reconstruction loss (the paper trains on MNIST MSE)."""
    return torch.mean(torch.square(apply_fcdnn(weights, x) - x))
