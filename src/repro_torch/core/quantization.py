"""Model quantizers (paper §II-A, §VI-A) — the subset the serving slice uses.

Port of ``repro/core/quantization.py``: :class:`QuantConfig` and
:class:`QuantPlan` (per-layer bit plans), the fake quantizers
(:func:`quantize_dequantize` over the uniform and pot-log codebooks, at
per-tensor, per-channel or per-group granularity) and :func:`wire_bytes`.
The integer-code storage path lives in ``kernels/ops.py``
(``quantize_linear``); :func:`qat_quantize` is the training loop's
straight-through quantizer.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

Scheme = Literal["uniform", "pot-log"]
Granularity = Literal["per-tensor", "per-channel", "per-group"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How to quantize one tensor (or a whole tree)."""

    bits: int = 8                       # total bits incl. sign (paper's b_hat)
    scheme: Scheme = "uniform"
    granularity: Granularity = "per-channel"
    group_size: int = 128               # for per-group
    min_ndim: int = 2

    def __post_init__(self):
        if self.bits < 1:
            raise ValueError(f"bits must be >= 1, got {self.bits}")
        if self.scheme not in ("uniform", "pot-log"):
            raise ValueError(f"unknown scheme {self.scheme!r}")

    @property
    def magnitude_levels(self) -> int:
        """Number of magnitude codepoints: 2^(bits-1) (sign kept separately)."""
        return 2 ** (self.bits - 1)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Per-layer (per-subtree) bit-allocation plan.

    ``entries`` is an ordered map of path prefixes to bit-widths, e.g.
    ``(("layers/0", 4), ("layers/1", 8))``.  A path resolves to the bits of
    its longest matching prefix ('/'-boundary aware), else
    ``default_bits``.  A plan with no entries is the uniform case.
    """

    entries: tuple = ()                 # ((path_prefix, bits), ...)
    default_bits: int = 16
    scheme: Scheme = "uniform"
    granularity: Granularity = "per-channel"
    group_size: int = 128
    min_ndim: int = 2

    def __post_init__(self):
        ent = tuple((str(p), int(b)) for p, b in self.entries)
        object.__setattr__(self, "entries", ent)
        for p, b in ent:
            if b < 1:
                raise ValueError(f"bits must be >= 1 for {p!r}, got {b}")
        if self.default_bits < 1:
            raise ValueError(f"default_bits must be >= 1, "
                             f"got {self.default_bits}")

    @staticmethod
    def uniform(bits: int, **kw) -> "QuantPlan":
        """The degenerate single-bit-width plan (no entries)."""
        return QuantPlan(entries=(), default_bits=bits, **kw)

    @staticmethod
    def from_layer_bits(bits, prefix: str = "layers", **kw) -> "QuantPlan":
        """Plan keyed ``<prefix>/<i> -> bits[i]`` (the allocator's output)."""
        ent = tuple((f"{prefix}/{i}", int(b)) for i, b in enumerate(bits))
        return QuantPlan(entries=ent, **kw)

    def resolve_bits(self, path: str) -> int:
        """Bits of the longest entry prefix matching ``path``."""
        best, best_len = self.default_bits, -1
        for prefix, bits in self.entries:
            if (path == prefix or path.startswith(prefix + "/")) \
                    and len(prefix) > best_len:
                best, best_len = bits, len(prefix)
        return best

    def config_for(self, path: str) -> QuantConfig:
        return QuantConfig(bits=self.resolve_bits(path), scheme=self.scheme,
                           granularity=self.granularity,
                           group_size=self.group_size,
                           min_ndim=self.min_ndim)

    def layer_bits(self, i: int, prefix: str = "layers") -> int:
        return self.resolve_bits(f"{prefix}/{i}")

    def config_for_layer(self, i: int, prefix: str = "layers") -> QuantConfig:
        return self.config_for(f"{prefix}/{i}")

    def layer_bit_list(self, n_layers: int,
                       prefix: str = "layers") -> tuple:
        return tuple(self.layer_bits(i, prefix) for i in range(n_layers))

    def uniform_layer_bits(self, n_layers: int, prefix: str = "layers"):
        """The single bit-width all of layers [0, n) resolve to, or None."""
        bs = set(self.layer_bit_list(n_layers, prefix))
        return bs.pop() if len(bs) == 1 else None

    def mean_bits(self, n_layers: int, prefix: str = "layers") -> float:
        bl = self.layer_bit_list(n_layers, prefix)
        return sum(bl) / max(len(bl), 1)

    def key(self) -> tuple:
        """Hashable, order-stable cache key (weight caches key on this)."""
        return ("plan", self.entries, self.default_bits, self.scheme,
                self.granularity, self.group_size, self.min_ndim)


# ---------------------------------------------------------------------------
# Scale computation
# ---------------------------------------------------------------------------

def _absmax(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Reduction producing the scale denominator, shaped for broadcasting."""
    if cfg.granularity == "per-tensor":
        return torch.amax(torch.abs(x))
    if cfg.granularity == "per-channel" or (
            cfg.granularity == "per-group" and x.shape[0] % cfg.group_size):
        # reduce all axes but the last (output-feature axis of [in, out]);
        # per-group falls back here when the contraction axis doesn't tile
        dims = tuple(range(x.ndim - 1))
        return torch.amax(torch.abs(x), dim=dims, keepdim=True)
    if cfg.granularity == "per-group":
        g = cfg.group_size
        xg = x.reshape((x.shape[0] // g, g) + tuple(x.shape[1:]))
        return torch.repeat_interleave(torch.amax(torch.abs(xg), dim=1), g,
                                       dim=0)
    raise ValueError(cfg.granularity)


def uniform_step_size(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform-quantizer step Delta = absmax / (2^(bits-1) - 1)."""
    levels = max(2 ** (bits - 1) - 1, 1)
    return absmax / levels


def _uniform_qdq(x: torch.Tensor, cfg: QuantConfig, *,
                 compiled: bool = False) -> torch.Tensor:
    """``compiled`` forms the step as ``amax * fl(1/levels)``, the product
    XLA compiles the reference's ``amax / levels`` into inside a jitted
    graph (its train step); otherwise the eager reference's true
    division."""
    amax = _absmax(x, cfg)
    if cfg.bits == 1:
        # sign-only code: reconstruct magnitude at its conditional mean proxy
        return torch.sign(x) * torch.broadcast_to(amax / 2.0, x.shape)
    if compiled:
        levels = max(2 ** (cfg.bits - 1) - 1, 1)
        step = amax * float(np.float32(1.0) / np.float32(levels))
    else:
        step = uniform_step_size(amax, cfg.bits)
    step = torch.where(step <= 0, torch.ones_like(step), step)
    levels = 2 ** (cfg.bits - 1) - 1
    q = torch.clamp(torch.round(torch.abs(x) / step), 0, levels)
    return torch.sign(x) * q * step


def _potlog_qdq(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Power-of-two logarithmic codebook: {0} U {amax 2^{-k}, k=0..n-2}."""
    amax = _absmax(x, cfg)
    amax = torch.where(amax <= 0, torch.ones_like(amax), amax)
    n = cfg.magnitude_levels
    if n <= 1:
        return torch.sign(x) * torch.broadcast_to(amax / 2.0, x.shape)
    mag = torch.abs(x)
    safe = torch.clamp(mag, min=torch.finfo(x.dtype).tiny)
    k = torch.clamp(torch.round(torch.log2(amax / safe)), 0, n - 2)
    recon = amax * torch.exp2(-k)
    smallest = amax * (2.0 ** (-(n - 2)))
    recon = torch.where(mag < smallest / 2.0, torch.zeros_like(recon), recon)
    return torch.sign(x) * recon


def quantize_dequantize(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Fake-quantization (quantize then immediately dequantize)."""
    if cfg.scheme == "uniform":
        return _uniform_qdq(x, cfg)
    return _potlog_qdq(x, cfg)


class _QatQuantize(torch.autograd.Function):
    """Fake quantization forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, x, cfg):
        if cfg.scheme == "uniform":
            return _uniform_qdq(x, cfg, compiled=True)
        return _potlog_qdq(x, cfg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def qat_quantize(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Fake-quant with identity (straight-through) gradients: the training
    loop's agent partition sees quantized weights in the forward while
    gradients pass through unchanged.

    The reference only runs this inside its jitted train step, so the
    uniform step is formed as there, ``amax * fl(1/levels)``, and the
    forward is bitwise the jitted reference's (:func:`quantize_dequantize`
    keeps the eager reference's true division).
    """
    return _QatQuantize.apply(x, cfg)


def wire_bytes(n_codes: int, bits: int) -> int:
    """Bytes to ship ``n_codes`` integer codes at ``bits`` (scales excluded).

    Realizable containers only: nibble-packed (two codes per byte) for
    bits <= 4, int8 for 5..8, int16 above.
    """
    if bits <= 4:
        return (n_codes + 1) // 2
    if bits <= 8:
        return n_codes
    return 2 * n_codes
