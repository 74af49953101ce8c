"""Model quantizers (paper §II-A, §VI-A).

Port of ``repro/core/quantization.py``.  The paper's scheme keeps the sign
bit and quantizes the magnitude with ``b_hat - 1`` bits, on a uniform or
a power-of-two logarithmic codebook, at per-tensor, per-channel (last
axis) or per-group (contraction axis) granularity.  Two execution styles:

  * :func:`quantize_dequantize` -- "fake quant" for distortion analysis
    and QAT (:func:`qat_quantize`, straight-through gradients);
  * :func:`quantize` / :func:`dequantize` -- integer codes + scales
    (:class:`QuantizedTensor`), the storage format of the tree quantizers
    (:func:`quantize_tree`, :func:`quantize_tree_stacked`): a model whose
    layers read a weight through ``.to(x.dtype)`` then runs int8-resident,
    dequantizing each weight as it reads it.

:class:`QuantPlan` holds per-layer bits; the kernel path's own integer
containers are in ``kernels/ops.py`` (``quantize_linear``).  Everything
here runs eagerly, as the reference's does, so the uniform step is the
true division ``absmax / levels``; only :func:`qat_quantize` takes the
product its jitted caller compiles.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Literal

import numpy as np
import torch

__all__ = [
    "QuantConfig",
    "QuantPlan",
    "QuantizedTensor",
    "as_plan",
    "tree_path_str",
    "quantize_dequantize",
    "quantize",
    "dequantize",
    "quantize_tree",
    "fake_quantize_tree",
    "quantize_tree_stacked",
    "qat_quantize",
    "uniform_step_size",
    "max_quant_error",
    "pack_int4",
    "unpack_int4",
    "wire_bytes",
]

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


def tree_path_str(key_path) -> str:
    """Canonical '/'-joined path of a leaf: the dict keys and list indices
    leading to it.  ``{"layers": {"attn": {"wq": ...}}}`` ->
    ``"layers/attn/wq"``, the string :class:`QuantPlan` entries match."""
    return "/".join(str(k) for k in key_path)


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

    def plan_hash(self) -> str:
        """Short stable hex digest of :meth:`key` (logs / JSON reports)."""
        return hashlib.sha1(repr(self.key()).encode()).hexdigest()[:12]


def as_plan(cfg) -> QuantPlan:
    """Lift a single :class:`QuantConfig` to the degenerate uniform plan."""
    if isinstance(cfg, QuantPlan):
        return cfg
    return QuantPlan.uniform(cfg.bits, scheme=cfg.scheme,
                             granularity=cfg.granularity,
                             group_size=cfg.group_size, min_ndim=cfg.min_ndim)


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
    """Uniform-quantizer step Delta = absmax / (2^(bits-1) - 1), the true
    division on every device.  (The divisor is a tensor on ``absmax``'s
    device: torch's CUDA kernel multiplies by the float32 reciprocal of a
    Python-scalar divisor, which rounds some steps one ulp away from the
    CPU's and the eager reference's quotient.)"""
    levels = max(2 ** (bits - 1) - 1, 1)
    return absmax / torch.full_like(absmax, levels)


def max_quant_error(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """tau bound of Assumption 3: worst-case per-element |w - w_hat|.

    Uniform: Delta/2.  PoT-log rounds the exponent, so a magnitude just
    above the k/(k+1) boundary rounds up to amax 2^-k: tau = (1 - 2^-1/2)
    amax (k = 0 dominates), or the underflow-to-zero floor when it is
    larger; a sign-only codebook (one level) errs by up to amax."""
    amax = _absmax(x, cfg)
    if cfg.scheme == "uniform":
        return torch.amax(uniform_step_size(amax, cfg.bits)) / 2.0
    n = cfg.magnitude_levels
    if n <= 1:
        return torch.amax(amax)
    round_up = (1.0 - 2.0 ** -0.5) * torch.amax(amax)
    floor = torch.amax(amax) * 2.0 ** (-(n - 1))
    return torch.maximum(round_up, floor)


def _uniform_qdq(x: torch.Tensor, cfg: QuantConfig, *,
                 compiled: bool = False,
                 amax: "torch.Tensor | None" = None) -> torch.Tensor:
    """``compiled`` forms the step as ``amax * fl(1/levels)``, the product
    XLA compiles the reference's ``amax / levels`` into inside a jitted
    graph (its train step, the uplink's ``while_loop``); otherwise the
    eager reference's true division.  ``amax`` (shaped to broadcast
    against ``x``) replaces the granularity's own reduction."""
    if amax is None:
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
    # sign(x) * q * step with jnp.sign's signed zero: -0.0 stays -0.0
    # (torch.sign(-0.0) is +0.0); the magnitude is q * step either way
    return torch.copysign(q * step, x)


def _potlog_qdq(x: torch.Tensor, cfg: QuantConfig,
                amax: "torch.Tensor | None" = None) -> torch.Tensor:
    """Power-of-two logarithmic codebook: {0} U {amax 2^{-k}, k=0..n-2}.
    ``amax`` as in :func:`_uniform_qdq`."""
    if amax is None:
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


@dataclasses.dataclass(frozen=True, eq=False)
class QuantizedTensor:
    """Integer codes + scale, the storage format for quantized weights.

    ``codes`` is int8 for bits <= 8 (int4 values live in [-7, 7]; use
    :func:`pack_int4` for the 2-per-byte wire format) and int16 for
    9..16 bits, the containers :func:`wire_bytes` bills for.  A leaf of
    :func:`quantize_tree_stacked` carries one scale per layer on the
    leading axis of ``scale`` too, and indexing or :meth:`unbind` slices
    codes and scales together, so a model's layer loop reads layer i as
    the ``QuantizedTensor`` of that layer.
    """

    codes: torch.Tensor       # int8 (<= 8 bits) / int16, original shape
    scale: torch.Tensor       # broadcastable to codes.shape (per layer)
    bits: int
    scheme: Scheme

    @property
    def shape(self):
        return self.codes.shape

    @property
    def ndim(self):
        return self.codes.ndim

    @property
    def dtype(self):
        return self.codes.dtype

    def to(self, dtype) -> torch.Tensor:
        """Dequantize on read: the model's layers read every weight as
        ``w.to(x.dtype)`` before its product, so a ``QuantizedTensor``
        leaf keeps the weight int8-resident and dequantizes it there."""
        return dequantize(self, dtype)

    def astype(self, dtype) -> torch.Tensor:
        """The reference's name for :meth:`to`."""
        return dequantize(self, dtype)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)

    def nbytes_effective(self) -> int:
        """Realizable wire/storage bytes of the codes + f32 scales: two
        codes a byte at <= 4 bits (:func:`pack_int4`), one at 5..8, two
        above (:func:`wire_bytes`), not the ``(n*bits+7)//8`` ideal."""
        return wire_bytes(self.codes.numel(), self.bits) \
            + self.scale.numel() * 4

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Slice the leading axis.  The scale is sliced with the codes
        where it carries that axis (a stacked leaf's per-layer scales, a
        per-group scale), taken at its broadcast row where that axis has
        size 1, and kept where it has none (a per-tensor scalar)."""
        if not isinstance(idx, (int, slice)):
            raise TypeError("a QuantizedTensor is indexed on its leading "
                            "axis by an int or a slice")
        sc = self.scale
        if sc.ndim and sc.shape[0] == self.codes.shape[0]:
            sc = sc[idx]
        elif sc.ndim == self.codes.ndim and isinstance(idx, int):
            sc = sc[0]
        return QuantizedTensor(self.codes[idx], sc, self.bits, self.scheme)

    def unbind(self, dim: int = 0) -> tuple:
        """The leading axis's slices (``torch.unbind``'s form)."""
        if dim != 0:
            raise ValueError("a QuantizedTensor unbinds its leading axis")
        return tuple(self[i] for i in range(self.codes.shape[0]))


def quantize(x: torch.Tensor, cfg: QuantConfig) -> QuantizedTensor:
    """Real quantization to integer codes (uniform scheme): round half to
    even of ``x / step``, clipped to +-levels."""
    if cfg.scheme != "uniform":
        raise NotImplementedError(
            "integer-code storage implemented for the uniform scheme; "
            "pot-log uses quantize_dequantize (codes are exponents).")
    if cfg.bits > 16:
        raise ValueError(f"no integer container for bits={cfg.bits} (>16)")
    amax = _absmax(x, cfg)
    step = uniform_step_size(amax, cfg.bits)
    step = torch.where(step <= 0, torch.ones_like(step), step)
    levels = max(2 ** (cfg.bits - 1) - 1, 1)
    # the container must hold +-levels: int8 through 8 bits, int16 above
    # (an int8 cast at 9..16 bits would wrap the codes)
    dtype = torch.int8 if cfg.bits <= 8 else torch.int16
    q = torch.clamp(torch.round(x / step), -levels, levels).to(dtype)
    return QuantizedTensor(codes=q, scale=step.to(torch.float32),
                           bits=cfg.bits, scheme=cfg.scheme)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.codes.to(dtype) * qt.scale.to(dtype)).to(dtype)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8-held int4 codes (two per byte) along the last axis.  (The
    kernels' container, ``kernels/ref.pack_int4_ref``, packs along K,
    the first axis: another layout.)"""
    if codes.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even to pack int4")
    lo = codes[..., 0::2] & 0x0F
    hi = (codes[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extends 4-bit two's complement)."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F

    def sext(v):
        return torch.where(v >= 8, v - 16, v)
    out = torch.stack([sext(lo), sext(hi)], dim=-1)
    return out.reshape(tuple(packed.shape[:-1])
                       + (packed.shape[-1] * 2,)).to(torch.int8)


# ---------------------------------------------------------------------------
# Tree level: nested dicts and lists of tensors
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf of nested dicts, lists and
    tuples, ``path`` being the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _should_quantize(path, leaf, cfg: QuantConfig) -> bool:
    del path
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= cfg.min_ndim \
        and leaf.is_floating_point()


def fake_quantize_tree(params: Any, cfg) -> Any:
    """Quantize-dequantize every eligible leaf of a parameter tree.

    ``cfg`` is a :class:`QuantConfig` (uniform bits) or a
    :class:`QuantPlan` (per-leaf bits by longest-prefix match of the
    leaf's dict path).  A layer-stacked leaf's path carries no layer id,
    so a plan keyed ``layers/<i>`` does not match here: use
    :func:`quantize_tree_stacked` or ``runtime.qat.fake_quantize_agent``,
    which index the leading axis."""
    plan = as_plan(cfg)

    def f(path, leaf):
        lc = plan.config_for(tree_path_str(path))
        if _should_quantize(path, leaf, lc):
            return quantize_dequantize(leaf, lc)
        return leaf
    return _map_with_path(f, params)


def quantize_tree(params: Any, cfg) -> Any:
    """Integer-quantize every eligible leaf; others pass through unchanged.
    A uniform plan is bitwise the single-config call; plan prefixes match
    dict paths (see :func:`fake_quantize_tree`)."""
    plan = as_plan(cfg)

    def f(path, leaf):
        lc = plan.config_for(tree_path_str(path))
        if _should_quantize(path, leaf, lc):
            return quantize(leaf, lc)
        return leaf
    return _map_with_path(f, params)


def quantize_tree_stacked(params: Any, cfg,
                          min_stacked_ndim: int = 3) -> Any:
    """:func:`quantize_tree` with scales per layer: each layer of a
    stacked leaf (leading axis) is quantized on its own, as the
    reference's ``vmap`` of :func:`quantize` does, so per-channel scales
    are per layer.  Only >= 3-D leaves (stacked weight matrices) are
    quantized; stacked norm gains and biases stay float.

    With a :class:`QuantPlan`, layer i quantizes at ``plan.layer_bits(i)``
    (keys ``layers/<i>`` index the leading axis).  Dequantization is
    ``codes * scale`` whatever the bits, so the layers stack into one
    :class:`QuantizedTensor` whose container fits the widest layer (int8
    unless a layer needs int16) and whose ``bits`` is the max, the width
    byte accounting must assume."""
    plan = as_plan(cfg)
    base = plan.config_for("")   # shared scheme/granularity/min_ndim

    def f(path, leaf):
        if not _should_quantize(path, leaf, base):
            return leaf
        if leaf.ndim < min_stacked_ndim:
            return leaf
        bits = plan.layer_bit_list(leaf.shape[0])
        qts = [quantize(w, dataclasses.replace(base, bits=b))
               for w, b in zip(leaf.unbind(0), bits)]
        cdtype = torch.int8 if max(bits) <= 8 else torch.int16
        return QuantizedTensor(
            codes=torch.stack([q.codes.to(cdtype) for q in qts]),
            scale=torch.stack([q.scale for q in qts]),
            bits=max(bits), scheme=base.scheme)
    return _map_with_path(f, params)


class _QatQuantize(torch.autograd.Function):
    """Fake quantization forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, x, cfg, amax):
        if cfg.scheme == "uniform":
            return _uniform_qdq(x, cfg, compiled=True, amax=amax)
        return _potlog_qdq(x, cfg, amax=amax)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def qat_quantize(x: torch.Tensor, cfg: QuantConfig,
                 amax: "torch.Tensor | None" = None) -> torch.Tensor:
    """Fake-quant with identity (straight-through) gradients: the training
    loop's agent partition sees quantized weights in the forward while
    gradients pass through unchanged.

    The reference only runs this inside its jitted train step, so the
    uniform step is formed as there, ``amax * fl(1/levels)``, and the
    forward is bitwise the jitted reference's (:func:`quantize_dequantize`
    keeps the eager reference's true division).  ``amax`` (shaped as the
    granularity's reduction) replaces that reduction: a shard's, reduced
    over the ranks that hold the rest of the weight.
    """
    return _QatQuantize.apply(x, cfg, amax)


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
