"""Quantized-weight matmul: the CUDA kernels and their plain torch versions.

Ports of the TPU kernels ``qmm`` and ``qmm_int4`` (``repro/kernels/qmm.py``):
``x [M, K] @ (codes [K, N] * scales [K//G, N])`` with int8 codes, or with
codes packed two per byte along K (``packed [K/2, N]``, low nibble first,
two's complement).  Both kernels live in ``csrc/qmm.cu``: a tiled float32
GEMM that dequantizes the codes as it stages them, accumulating every
output in one ascending-k FMA chain, so a row's bits do not depend on M.

The kernels compute in float32; an activation of another dtype is cast to
float32 on the way in and the result back to its dtype, as the reference
does (``x.astype(f32) @ w`` then ``.astype(x.dtype)``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry(symbol: str):
    fn = getattr(build.library("qmm"), symbol)
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_args(x, w, scales, packed: bool, what: str) -> int:
    """Validate shapes; returns the group size G."""
    if x.ndim != 2 or w.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"{what}: needs 2-D x, codes and scales")
    k = x.shape[1]
    if packed and k % 2 != 0:
        raise ValueError(f"{what}: K={k} must be even")
    if w.shape[0] != (k // 2 if packed else k):
        raise ValueError(f"{what}: x has K={k} but the codes have "
                         f"{w.shape[0]} rows")
    if scales.shape[1] != w.shape[1] or scales.shape[0] < 1 \
            or k % scales.shape[0] != 0:
        raise ValueError(f"{what}: scales {tuple(scales.shape)} do not "
                         f"tile K={k} x N={w.shape[1]}")
    if w.dtype != torch.int8:
        raise ValueError(f"{what}: codes must be int8, got {w.dtype}")
    return k // scales.shape[0]


def _launch(symbol: str, x, w, scales, group: int, counter) -> torch.Tensor:
    devices = {x.device, w.device, scales.device}
    if len(devices) != 1:
        raise ValueError(f"{symbol}: operands on several devices {devices}")
    if x.device.type != "cuda":
        raise ValueError(f"{symbol}: runs on cuda or cpu, got {x.device}")
    m, k = x.shape
    n = w.shape[1]
    xf = x.to(torch.float32).contiguous()
    wc = w.contiguous()
    sc = scales.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            status = _entry(symbol)(
                xf.data_ptr(), wc.data_ptr(), sc.data_ptr(), out.data_ptr(),
                m, k, n, group, torch.cuda.current_stream().cuda_stream)
        build.check(status, symbol)
        counter.launches += 1
    return out.to(x.dtype)


def qmm(x: torch.Tensor, codes: torch.Tensor,
        scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(codes [K, N] int8, scales [K//G, N]) -> [M, N].

    Launches the CUDA kernel on a CUDA tensor (any M, K, N and any G that
    divides K) and runs the plain version on a CPU tensor.
    """
    group = _check_args(x, codes, scales, False, "qmm")
    if x.device.type == "cpu":
        return _ref.qmm_ref(x, codes, scales)
    return _launch("qmm_f32", x, codes, scales, group, qmm)


def qmm_int4(x: torch.Tensor, packed: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(packed [K/2, N] int4x2, scales [K//G, N])."""
    group = _check_args(x, packed, scales, True, "qmm_int4")
    if x.device.type == "cpu":
        return _ref.qmm_int4_ref(x, packed, scales)
    return _launch("qmm_int4_f32", x, packed, scales, group, qmm_int4)


qmm.launches = 0
qmm_int4.launches = 0
