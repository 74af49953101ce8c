"""Public wrappers around the quantized kernels (``repro/kernels/ops.py``).

Leading dims of an activation flatten into the kernel's M axis, so
``[B, S, K]`` (B requests packed by a batched engine) and ``[S, K]`` reach
the same kernel with rows computed independently.

Unlike the reference, nothing is padded: the JAX wrappers pad M to
``row_bucket`` only to share traces, and fall back to the jnp reference
for K/N off the 128-grid.  The CUDA kernels mask every ragged edge
themselves and take every shape the reference accepts, so on a CUDA
tensor these wrappers always launch a kernel (or raise); on a CPU tensor
they run the plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from .qmm import qmm, qmm_int4
from .quantize import group_quantize_many


def quantized_matmul(x: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(codes [K, N], scales [K//G, N]) -> [..., N]."""
    lead, k, n = x.shape[:-1], x.shape[-1], codes.shape[1]
    return qmm(x.reshape(-1, k), codes, scales).reshape(*lead, n)


def quantized_matmul_int4(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(packed [K/2, N], scales) -> [..., N]."""
    lead, k, n = x.shape[:-1], x.shape[-1], packed.shape[1]
    return qmm_int4(x.reshape(-1, k), packed, scales).reshape(*lead, n)


def group_layout(k: int, group_size: int) -> int:
    """The group size the quantizer uses for a K-row weight.

    The reference's choice (``ops.group_quantize``): ``group_size`` when it
    tiles K; else one group of ``min(group_size, k)`` rows when that tiles
    K; else per-element groups (size 1).  Codes and scales then match the
    reference's layout for every shape.
    """
    g = min(group_size, k)
    return g if k % g == 0 else 1


def group_quantize(w: torch.Tensor, *, group_size: int = 128, bits: int = 8):
    """Group quantizer with the reference's group-layout choice."""
    return group_quantize_many([w], [group_layout(w.shape[0], group_size)],
                               [bits])[0]


# ---------------------------------------------------------------------------
# Serving-side weight record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """One device-resident quantized weight matrix (int8 or packed int4).

    ``bits`` is the quantization bit-width (1..8); codes of <= 4 bits are
    nibble-packed two per byte along K, wider codes stay int8.
    """

    codes: torch.Tensor         # int8 [K, N] or packed [K/2, N]
    scales: torch.Tensor        # f32 [K//G, N]
    bits: int                   # quantization bits, 1..8
    k: int                      # logical contraction dim

    def __matmul__(self, other):
        raise TypeError("use .apply(x)")

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits <= 4:
            return quantized_matmul_int4(x, self.codes, self.scales)
        return quantized_matmul(x, self.codes, self.scales)

    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * 4)


def quantize_linear(w: torch.Tensor, *, bits: int = 8,
                    group_size: int = 128) -> QuantizedLinear:
    """Quantize one [K, N] weight for device residency (the one-matrix
    case of :func:`quantize_linears`)."""
    return quantize_linears([w], [bits], group_size=group_size)[0]


def quantize_linears(ws, bits, *, group_size: int = 128):
    """Quantize [K, N] weights ``ws[i]`` at ``bits[i]`` for device residency.

    bits <= 4 quantizes at ``bits``-bit levels with two codes packed per
    byte along K (served by the int4 kernel); 5..8 stays int8-resident.
    Groups follow :func:`group_layout`.  On the card every matrix on the
    quantizer's vector route (all of a dense model's) goes out in one
    launch, packed codes written by the kernel itself.
    """
    for b in bits:
        if not 1 <= b <= 8:
            raise ValueError(f"kernel residency needs bits in 1..8, got {b}")
    qs = group_quantize_many(
        ws, [group_layout(w.shape[0], group_size) for w in ws], bits,
        pack=True)
    return [QuantizedLinear(codes=codes, scales=scales, bits=b, k=w.shape[0])
            for w, b, (codes, scales) in zip(ws, bits, qs)]
