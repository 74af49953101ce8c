"""Fused group quantizer: the CUDA kernel and its plain torch version.

Port of the TPU kernel ``group_quantize`` (``repro/kernels/quantize.py``).
For each (group of G contraction rows, column): ``scale = amax / levels``
(1.0 for an all-zero group) and ``codes = clip(round(w / scale), ±levels)``
with ``levels = 2^(bits-1) - 1``.  The kernel is
``csrc/group_quantize.cu``; the plain version is
``ref.group_quantize_ref``.  Codes and scales are bitwise the plain
version's (and the reference's).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.quantization import wire_bytes
from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    fn = build.library("group_quantize").group_quantize_f32
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def group_quantize(w: torch.Tensor, *, group_size: int = 128, bits: int = 8):
    """w [K, N] float -> (codes int8 [K, N], scales f32 [K//G, N]).

    On a CUDA tensor this launches the kernel (any G dividing K, any N);
    on a CPU tensor it runs the plain version.  Nothing else is accepted.
    """
    if w.ndim != 2:
        raise ValueError(f"group_quantize needs a [K, N] matrix, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if group_size < 1 or k % group_size != 0:
        raise ValueError(f"group size {group_size} does not divide K={k}")
    if not 1 <= bits <= 8:
        raise ValueError(f"int8 codes hold 1..8 bits, got {bits}")
    if w.device.type == "cpu":
        return _ref.group_quantize_ref(w, group_size, bits)
    if w.device.type != "cuda":
        raise ValueError(f"group_quantize runs on cuda or cpu, got "
                         f"{w.device}")
    wf = w.to(torch.float32).contiguous()
    codes = torch.empty((k, n), dtype=torch.int8, device=w.device)
    scales = torch.empty((k // group_size, n), dtype=torch.float32,
                         device=w.device)
    if wf.numel():
        with torch.cuda.device(w.device):
            status = _entry()(wf.data_ptr(), codes.data_ptr(),
                              scales.data_ptr(), k, n, group_size, bits,
                              torch.cuda.current_stream().cuda_stream)
        build.check(status, "group_quantize")
        group_quantize.launches += 1
    return codes, scales


group_quantize.launches = 0


# ---------------------------------------------------------------------------
# KV-cache quantization (decode serving; ``repro/kernels/quantize.py``)
# ---------------------------------------------------------------------------
#
# One scale per head vector (absmax over the trailing head_dim axis), the
# weight quantizer's scale/round/clip rule.  Plain torch, as in the
# reference, which has no Pallas kernel for it: the decode step quantizes
# one [B, 1, KV, dh] entry per layer, too little work to earn a launch.

def kv_levels(bits: int) -> int:
    """Symmetric code magnitude at ``bits`` (7 for int4, 127 for int8)."""
    return 2 ** (bits - 1) - 1


def kv_quantize(x: torch.Tensor, bits: int):
    """x [..., head_dim] float -> (codes int8 [...], scales f32 [...]).

    Zero vectors quantize to scale 1.0 / codes 0.  The scale is formed as
    ``amax * fl(1/levels)``: the reference only ever runs this under
    ``jax.jit``, where XLA compiles its ``amax / levels`` into that
    product, so codes and scales match it bitwise.  ``x / scale`` stays a
    true division and rounding is half to even.  Codes of every
    ``bits < 16`` (4 included) live in an int8 container; only
    :func:`kv_cache_bytes` bills them nibble-packed.
    """
    levels = kv_levels(bits)
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    # a Python float that is exactly fl32(1/levels): no host-to-device copy
    inv = float(np.float32(1.0) / np.float32(levels))
    scale = torch.where(amax > 0, amax * inv, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -levels, levels)
    return q.to(torch.int8), scale


def kv_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse map: codes [..., dh], scales [...] -> float [..., dh]."""
    return (codes.to(torch.float32) * scales[..., None]).to(dtype)


def kv_cache_bytes(shape, bits: int, *, scale_bytes: int = 4) -> int:
    """Stored size of a quantized [..., head_dim] cache block: codes at the
    realizable container (int4 nibble-packed for <= 4 bits, int8 for
    5..8) plus one f32 scale per head vector; a >= 16-bit cache is billed
    raw at 2 bytes an entry, no scales."""
    n = 1
    for d in shape:
        n *= int(d)
    if bits >= 16:
        return 2 * n
    return wire_bytes(n, bits) + scale_bytes * (n // int(shape[-1]))
