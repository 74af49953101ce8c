"""Row-independent float32 GEMM on the tensor cores: the CUDA kernel and its
plain torch version.

A port-own kernel (no TPU kernel stands behind it): the co-inference
split forward's products, ``y [M, N] = x [M, K] @ w`` for any M, where row
m's bits depend neither on M nor on the other rows, so a request served in
a padded batch equals the request served alone.  The reference gets that
from XLA's dots; cuBLAS picks its tiles and its split of K by M.  The
kernel is ``csrc/tc_gemm.cu``: three TF32 ``wgmma`` passes on a hi/lo
split of both operands (float32-level products, as the flash kernel's),
64-row tiles, a column tile and a split of K chosen by :func:`route` from
(K, N) alone, the K walk in a fixed order and the split's parts added in
a fixed order.  ``w`` is taken in place, either row-major [K, N] or as the
transposed view of a row-major [N, K] matrix (the tied embedding's
``tok.T``).  The plain version is ``ref.tc_gemm_ref`` (``torch.matmul``),
so every CPU number is what ``torch.matmul`` gives.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int

TILE_M = 64             # rows of a block: csrc/tc_gemm.cu kTileM
TILE_K = 32             # k of a staged tile: kTileK
WIDE_N = 2048           # from this N on, 128-column tiles (else 64)
MAX_SPLITS = 8          # parts of K a tile may take: kMaxSplits
SPLIT_ROWS = 448        # k rows a part takes at least
FILL_TILES = 56         # column tiles x parts a split of K stays within
MAX_COL_TILES = 65535   # the grid's y limit


class Route(NamedTuple):
    """The kernel's schedule for w [K, N]: ``block_n`` columns a block,
    K in ``splits`` parts of ``chunk`` rows (a multiple of TILE_K; the
    last may be shorter), each part a block of its own, the parts added in
    order by a second launch when ``splits`` > 1."""
    block_n: int
    splits: int
    chunk: int


@functools.lru_cache(maxsize=None)
def route(k: int, n: int) -> Route:
    """The schedule for a product with K rows of w and N columns: a pure
    function of (K, N), never of M, so a row's order of additions is the
    same at every M.  Wide products (N >= WIDE_N) take 128-column tiles.
    Where few column tiles leave the card idle at a small M, K is split
    into parts of at least SPLIT_ROWS rows, as many as keep column tiles x
    parts within FILL_TILES (qwen2-0.5b's down projection, K = 4,864,
    N = 896: four parts of 1,216; its q and o projections two of 448).  Raises for a shape the kernel cannot take
    (K % 4 != 0, an empty product, more column tiles than the grid
    holds)."""
    if k < 1 or n < 1:
        raise ValueError(f"tc_gemm routes K, N >= 1, got K={k}, N={n}")
    if k % 4:
        raise ValueError(f"tc_gemm needs K % 4 == 0 (16-byte rows of x), "
                         f"got K={k}")
    block_n = 128 if n >= WIDE_N else 64
    tiles = -(-n // block_n)
    if tiles > MAX_COL_TILES:
        raise ValueError(f"N={n} needs {tiles} column tiles; the grid "
                         f"holds {MAX_COL_TILES}")
    splits = max(1, min(MAX_SPLITS, k // SPLIT_ROWS, FILL_TILES // tiles))
    chunk = -(-(-(-k // splits)) // TILE_K) * TILE_K
    return Route(block_n, -(-k // chunk), chunk)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("tc_gemm").tc_gemm_f32
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                   _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _layout(w: torch.Tensor, k: int):
    """(transposed, leading stride) of w, or raise."""
    n = w.shape[1]
    if w.stride(1) == 1 and w.stride(0) >= n and n % 4 == 0 \
            and w.stride(0) % 4 == 0:
        return 0, w.stride(0)
    if w.stride(0) == 1 and w.stride(1) >= k and w.stride(1) % 4 == 0:
        return 1, w.stride(1)
    raise ValueError(f"w {tuple(w.shape)} with strides {w.stride()} is "
                     "neither row-major with N % 4 == 0 nor the transposed "
                     "view of a row-major [N, K], each with a leading "
                     "stride % 4 == 0")


def _check(x: torch.Tensor, w: torch.Tensor) -> str:
    """Validate the operands; returns their device type."""
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"needs x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return "cpu"
    if x.device.type not in build.CARD_DEVICES or w.device != x.device:
        raise ValueError(f"tc_gemm runs on one cuda device or on the cpu, "
                         f"got {sorted({str(x.device), str(w.device)})}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"tc_gemm takes float32, got {x.dtype} and "
                         f"{w.dtype}")
    return "cuda"


def _launch_checks(x, w, address) -> Optional[tuple]:
    """Raise where a launch cannot take the operands; returns (layout,
    route) or None when no launch is needed.  ``address(t)`` is a tensor's
    byte address mod 16 (the data pointer on the card, the storage offset
    in bytes under fake tensors)."""
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return None
    layout = _layout(w, k)
    r = route(k, n)
    if address(x) % 16 or address(w) % 16:
        raise ValueError("tc_gemm needs 16-byte aligned operands")
    return layout, r


def _launch(x, w):
    """One launch of the kernel for ``x @ w`` on the card; returns y."""
    with torch.cuda.device(x.device):
        return _launch_on(x, w)


def _launch_on(x, w):
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    xc = x.contiguous()
    (transposed, ld), r = _launch_checks(xc, w, lambda t: t.data_ptr())
    work = torch.empty((r.splits, m, n), dtype=torch.float32,
                       device=x.device) if r.splits > 1 else None
    status = _entry()(
        xc.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), m, k, n, ld,
        transposed, r.block_n, r.splits, r.chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "tc_gemm")
    build.count(tc_gemm)
    return y


def tc_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in float32, each row its own.

    Launches the CUDA kernel on CUDA tensors (float32, any M, K % 4 == 0,
    ``w`` row-major with N % 4 == 0 or the transposed view of a row-major
    [N, K], 16-byte aligned): ``tc_gemm_kernel`` once a call, counted in
    ``tc_gemm.launches``, and where :func:`route` splits K one
    ``tc_gemm_combine`` after it, not counted.  Runs the plain version
    (``torch.matmul``) on CPU tensors; anything else raises.  The custom
    op ``repro_torch::tc_gemm``.
    """
    _check(x, w)
    return tc_gemm_op(x, w)


def _impl(x, w):
    if x.device.type == "cpu":
        return _ref.tc_gemm_ref(x, w)
    return _launch(x, w)


def _fake(x, w):
    if x.device.type != "cpu":
        _check(x, w)
        _launch_checks(x.contiguous(), w,
                       lambda t: t.storage_offset() * t.element_size())
    return x.new_empty((x.shape[0], w.shape[1]),
                       dtype=torch.promote_types(x.dtype, w.dtype))


def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2 M K N."""
    m, k = x_shape
    return 2 * m * k * w_shape[1]


tc_gemm_op = build.kernel_op("tc_gemm", "(Tensor x, Tensor w) -> Tensor",
                             _impl, _fake, _flops)


tc_gemm.launches = 0
