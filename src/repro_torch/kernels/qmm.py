"""Quantized-weight matmul: the CUDA kernels and their plain torch versions.

Ports of the TPU kernels ``qmm`` and ``qmm_int4`` (``repro/kernels/qmm.py``):
``x [M, K] @ (codes [K, N] * scales [K//G, N])`` with int8 codes, or with
codes packed two per byte along K (``packed [K/2, N]``, low nibble first,
two's complement).  Both live in ``csrc/qmm.cu``, with two routes that
:func:`route` picks from the shape alone:

* ``"wgmma"`` (G a multiple of 16, N of 16; every main-path shape): Hopper
  tensor cores.  The codes are exact in bf16 and x splits exactly into
  three bf16 pieces, so three bf16 ``wgmma`` per k-chunk accumulate each
  group's partial in f32, promoted by ``fmaf(partial, scale, total)``:
  f32-accurate, TMA-fed, K split over blocks in a fixed order
  (:func:`splits`).
* ``"simt"`` (any other G or N): a tiled f32 GEMM, one ascending-k FMA
  chain per output.

Neither route's arithmetic depends on M, so a row's bits do not either.
The kernels compute in float32; an activation of another dtype is cast to
float32 on the way in and the result back to its dtype, as the reference
does (``x.astype(f32) @ w`` then ``.astype(x.dtype)``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int

ROUTES = ("wgmma", "simt")
CHUNK = 16            # the bf16 wgmma's K: a group must be whole chunks
TILE_M, TILE_N = 64, 128  # the tensor-core kernel's output tile
MIN_SPLIT_K = 128     # contraction rows a split takes at least
MAX_SPLITS = 4
ROW_TILES = 4         # the serving batch (M = 256) the split count fills


def route(k: int, n: int, group: int) -> str:
    """The kernel a [K, N] weight (int8 or packed int4) with groups of
    ``group`` rows takes.

    ``"wgmma"`` when every group is whole 16-deep chunks and the rows of
    the codes (N bytes, packed or not) and of x (4K bytes) are 16-byte
    multiples, as TMA needs; ``"simt"`` otherwise.  M plays no part.
    """
    if group % CHUNK == 0 and k % group == 0 and n % 16 == 0:
        return "wgmma"
    return "simt"


def splits(k: int, n: int, group: int, sms: int) -> int:
    """How many blocks share the K range of one output tile on the
    tensor-core route: enough that ROW_TILES row tiles (the batched
    engine's M = 256) of the N tiles cover ``sms`` SMs, at most MAX_SPLITS,
    each split whole groups of at least MIN_SPLIT_K rows.  A function of
    (K, N, G) and the card, never of the M of a call (measured on an H100
    at the main path's shapes: more splits than this lose more to the
    reduction than they gain)."""
    n_tiles = -(-n // TILE_N)
    want = sms // (ROW_TILES * n_tiles)
    return max(1, min(want, k // group, k // MIN_SPLIT_K, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The bound C entry point, looked up and typed once: (x, codes,
    scales, out[, ws, counters], m, k, n, group[, splits], stream)."""
    fn = getattr(build.library("qmm"), symbol)
    wgmma = "wgmma" in symbol
    fn.argtypes = [_P] * (6 if wgmma else 4) + [_I] * (5 if wgmma else 4) \
        + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte-aligned address (TMA's need); a copy only
    when it is not already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _device_checks(what: str, x, w, scales) -> None:
    """Raise where the kernel cannot take the operands' devices (the op's
    real and fake versions both run it)."""
    devices = {x.device, w.device, scales.device}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices "
                         f"{devices}")
    if x.device.type not in build.CARD_DEVICES:
        raise ValueError(f"{what}: runs on cuda or cpu, got "
                         f"{x.device}")


def _launch(fn, packed: bool, x, w, scales, group: int) -> torch.Tensor:
    _device_checks(fn.__name__, x, w, scales)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.to(x.dtype)
    xf = _aligned(x.to(torch.float32))
    wc = _aligned(w)
    sc = _aligned(scales.to(torch.float32))
    way = route(k, n, group)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if way == "wgmma":
            s = splits(k, n, group, _sm_count(x.device.index))
            ws = cnt = None
            if s > 1:
                ws = torch.empty((s, m, n), dtype=torch.float32,
                                 device=x.device)
                cnt = build.arrival_counters(
                    x.device, -(-m // TILE_M) * -(-n // TILE_N))
            symbol = "qmm_int4_wgmma_f32" if packed else "qmm_wgmma_f32"
            status = _entry(symbol)(
                xf.data_ptr(), wc.data_ptr(), sc.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if cnt is None else cnt.data_ptr(),
                m, k, n, group, s, stream)
        else:
            symbol = "qmm_int4_f32" if packed else "qmm_f32"
            status = _entry(symbol)(
                xf.data_ptr(), wc.data_ptr(), sc.data_ptr(), out.data_ptr(),
                m, k, n, group, stream)
    build.check(status, symbol)
    build.count(fn, way)
    return out.to(x.dtype)


def qmm(x: torch.Tensor, codes: torch.Tensor,
        scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(codes [K, N] int8, scales [K//G, N]) -> [M, N].

    Launches a CUDA kernel on a CUDA tensor (any M, K, N and any G that
    divides K; :func:`route` picks which) and runs the plain version on a
    CPU tensor; the custom op ``repro_torch::qmm``.
    """
    _check_args(x, codes, scales, False, "qmm")
    return qmm_op(x, codes, scales)


def qmm_int4(x: torch.Tensor, packed: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(packed [K/2, N] int4x2, scales [K//G, N]); the
    custom op ``repro_torch::qmm_int4``."""
    _check_args(x, packed, scales, True, "qmm_int4")
    return qmm_int4_op(x, packed, scales)


def _qmm_impl(x, codes, scales):
    if x.device.type == "cpu":
        return _ref.qmm_ref(x, codes, scales)
    return _launch(qmm, False, x, codes, scales,
                   x.shape[1] // scales.shape[0])


def _qmm_int4_impl(x, packed, scales):
    if x.device.type == "cpu":
        return _ref.qmm_int4_ref(x, packed, scales)
    return _launch(qmm_int4, True, x, packed, scales,
                   x.shape[1] // scales.shape[0])


def _fake(what):
    def fake(x, w, scales):
        if x.device.type != "cpu" or w.device != x.device \
                or scales.device != x.device:
            _device_checks(what, x, w, scales)
        return x.new_empty((x.shape[0], w.shape[1]))
    return fake


def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2 M K N: the product the kernel computes (its three bf16 passes
    are how, not what)."""
    m, k = x_shape
    return 2 * m * k * w_shape[1]


_SCHEMA = "(Tensor x, Tensor codes, Tensor scales) -> Tensor"
qmm_op = build.kernel_op("qmm", _SCHEMA, _qmm_impl, _fake("qmm"), _flops)
qmm_int4_op = build.kernel_op("qmm_int4", _SCHEMA, _qmm_int4_impl,
                              _fake("qmm_int4"), _flops)


def reset_route_launches() -> None:
    for fn in (qmm, qmm_int4):
        fn.route_launches = dict.fromkeys(ROUTES, 0)


qmm.launches = 0
qmm_int4.launches = 0
reset_route_launches()
