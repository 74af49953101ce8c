"""Row-independent batched f32 GEMM: the CUDA kernel and its plain torch
version.

A port-own kernel (no TPU kernel stands behind it): the decode step's
projections and tied head, ``y [M, N] = x [M, K] @ w [K, N]`` for M <= 16
rows, where row m's bits depend neither on M nor on the other rows.  The
reference gets that from XLA's batched dot; cuBLAS picks its split of K
and its tiles by M.  The kernel is ``csrc/row_gemm.cu``: one launch per
product, each weight read once for all rows, each output one ``fmaf`` chain
per slice of k in a fixed order, the slices (:func:`schedule`) chosen from
(K, N) alone.  ``w`` is taken in place, either row-major [K, N] or as the
transposed view of a row-major [N, K] matrix (the tied embedding's
``tok.T``).  The plain version is ``ref.row_gemm_ref``, one product per row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_M = 16                  # rows the kernel holds in registers
TILE_N = 128                # columns of a block: csrc/row_gemm.cu kTileN
WARPS = 4                   # warps splitting a block's chunk: kWarps
MIN_PER_WARP = 16           # k positions a warp takes at least
TARGET_BLOCKS = 264         # two blocks per SM of an H100 (132 SMs)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("row_gemm").row_gemm_f32
    fn.argtypes = [_P] * 5 + [_I] * 3 + [ctypes.c_longlong] + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def schedule(k: int, n: int):
    """(chunk, splits) of the row-major route for w [K, N]: ``splits``
    blocks along k of ``chunk`` positions each (a multiple of WARPS), about
    TARGET_BLOCKS blocks in all, each warp at least MIN_PER_WARP positions.
    A function of (K, N) alone: never of M, so a row's order of additions
    is the same at every M."""
    tiles = -(-n // TILE_N)
    most = max(1, -(-k // (WARPS * MIN_PER_WARP)))
    splits = min(max(1, -(-TARGET_BLOCKS // tiles)), most)
    chunk = -(-k // splits)
    chunk = -(-chunk // WARPS) * WARPS
    return chunk, -(-k // chunk)


def row_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in float32, each row its own product.

    Launches the CUDA kernel on CUDA tensors (once per call; float32,
    M <= MAX_M, ``w`` row-major with N % 4 == 0 or the transposed view of
    a row-major [N, K] with K % 4 == 0, 16-byte aligned) and runs the plain
    version on CPU tensors; anything else raises.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"needs x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _ref.row_gemm_ref(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"row_gemm runs on one cuda device or on the cpu, "
                         f"got {x.device} and {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"row_gemm takes float32, got {x.dtype} and "
                         f"{w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if m > MAX_M:
        raise ValueError(f"row_gemm holds at most {MAX_M} rows, got {m}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    xc = x.contiguous()
    if w.stride(1) == 1 and w.stride(0) >= n and n % 4 == 0:
        transposed, ld = 0, w.stride(0)
    elif w.stride(0) == 1 and w.stride(1) >= k and k % 4 == 0:
        transposed, ld = 1, w.stride(1)
    else:
        raise ValueError(f"w {tuple(w.shape)} with strides {w.stride()} is "
                         "neither row-major with N % 4 == 0 nor the "
                         "transposed view of a row-major [N, K] with "
                         "K % 4 == 0")
    if ld % 4 or any(t.data_ptr() % 16 for t in (xc, w, out)):
        raise ValueError("row_gemm needs 16-byte aligned rows")
    chunk, splits = schedule(k, n) if not transposed else (0, 1)
    ws = torch.empty(splits * m * n if splits > 1 else 0,
                     dtype=torch.float32, device=x.device)
    counters = build.arrival_counters(x.device, -(-n // TILE_N))
    with torch.cuda.device(x.device):
        status = _entry()(
            xc.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr() if splits > 1 else None, counters.data_ptr(),
            m, k, n, ld, transposed, chunk, splits,
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "row_gemm")
    build.count(row_gemm)
    return out


row_gemm.launches = 0
