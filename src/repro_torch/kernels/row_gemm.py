"""Row-independent batched f32 GEMM: the CUDA kernel and its plain torch
version.

A port-own kernel (no TPU kernel stands behind it): the decode step's
projections and tied head, ``y [M, N] = x [M, K] @ w [K, N]`` for any M,
where row m's bits depend neither on M nor on the other rows.  The
reference gets that from XLA's batched dot; cuBLAS picks its split of K
and its tiles by M.  The kernel is ``csrc/row_gemm.cu``: the weights
staged in shared memory by bulk copies, each read once for every row of
the launch, each output a fixed set of ``fmaf`` chains added in a fixed
order, the split of K (:func:`schedule`, a thread-block cluster per
column tile) and the head's tile (:func:`head_columns`) chosen from
(K, N) alone.  :func:`row_gemm_group` computes several products of one x
(q | k | v, gate | up) in one launch, each bitwise its own launch, with
an optional bias added after the sum.  The head runs as one wave of
persistent blocks, each streaming its column tiles through a ring
(:func:`head_stages`).  ``w`` is taken in place, either
row-major [K, N] or (:func:`row_gemm` only) as the transposed view of a
row-major [N, K] matrix (the tied embedding's ``tok.T``).  The plain
versions are ``ref.row_gemm_ref`` (one product per row) and
``ref.row_gemm_group_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int

SLICE = 16              # rows a slice computes: csrc/row_gemm.cu kSlice
THREADS = 128           # threads of a row-major block: kThreads
NK_THREADS = 256        # threads of a head block: kNkThreads
TILE_N = 64             # row-major route: columns of a block, kTileN
PARTS = 8               # k-parts of a block: kParts
PIECE = 32              # rows of a ring stage (4 per part): kPiece
MAX_PRODUCTS = 4        # products of one grouped launch: kMaxProducts
MAX_CLUSTER = 8         # blocks of a cluster (the portable limit)
MIN_ROWS = 128          # k rows a block takes at least
MAX_STAGES = 4          # ring stages of a block (8 KB each)
RING_BYTES = 163840     # a row-major block's ring, at most
HEAD_TILE_BYTES = 49152  # the head's column tile, at most
HEAD_RING_BYTES = 98304  # the head's ring of tiles, at most
MAX_SMEM_BYTES = 232448  # shared memory a block may use on an H100


class Schedule(NamedTuple):
    """The row-major route's split of K: ``cluster`` blocks (one
    thread-block cluster) share a column tile, each ``chunk`` rows of k
    (a multiple of 4), staged in ``pieces`` stages of PIECE rows through a
    ring of ``stages`` slots."""
    cluster: int
    chunk: int
    pieces: int
    stages: int


def schedule(k: int, n: int) -> Schedule:
    """The row-major route's schedule for w [K, N]: K split into at most
    MAX_CLUSTER chunks of at least MIN_ROWS rows.  A function of K alone
    (N is taken for the signature's sake): never of M, so a row's order of
    additions is the same at every M, and the products of one grouped
    launch (which share K) share one cluster shape.

    The ring takes as many stages (up to MAX_STAGES) as leave a block at
    a full SLICE of rows within MAX_SMEM_BYTES beside its x slice: every
    stage up to K = 16,384, fewer for longer chunks (granite-34b's down
    projection, K = 24,576, chunks of 3,072 rows: 3 stages).  The stages
    move data only: a row's additions are the same at any ring depth."""
    del n
    cluster = min(MAX_CLUSTER, max(1, -(-k // MIN_ROWS)))
    chunk = -(-k // cluster)
    chunk = -(-chunk // 4) * 4
    cluster = -(-k // chunk)
    pieces = -(-chunk // PIECE)
    most = max(1, min(MAX_STAGES, RING_BYTES // (4 * PIECE * TILE_N)))
    stages = min(pieces, most)
    while stages > 1 and _kn_smem(SLICE, chunk, stages) > MAX_SMEM_BYTES:
        stages -= 1
    return Schedule(cluster, chunk, pieces, stages)


def _kn_smem(mb: int, chunk: int, stages: int) -> int:
    """Dynamic shared memory of a row-major block: the ring, the slice's x
    over the chunk (the parts' sums reuse it), the tile's total, one
    mbarrier a stage."""
    return 4 * (stages * PIECE * TILE_N + max(mb * chunk, PARTS * mb * TILE_N)
                + mb * TILE_N) + 8 * stages


def head_ld(k: int) -> int:
    """The head's row stride in shared memory: K padded to 4 (mod 32)
    floats (csrc/row_gemm.cu's ldk)."""
    return k + (36 - k % 32) % 32


def head_columns(k: int) -> int:
    """Columns of t a block of the transposed route stages: the largest
    power of two up to 32 whose padded rows fit HEAD_TILE_BYTES (at least
    1).  A function of K alone."""
    cols = 32
    while cols > 1 and cols * head_ld(k) * 4 > HEAD_TILE_BYTES:
        cols //= 2
    return cols


def head_stages(k: int) -> int:
    """Tiles in the head's ring: as many as fit HEAD_RING_BYTES, 1 to 8.
    A function of K alone (it moves data, never arithmetic)."""
    tile = head_columns(k) * head_ld(k) * 4
    return max(1, min(8, HEAD_RING_BYTES // tile))


def row_block(m: int) -> int:
    """MB, the rows a thread holds in registers: min(M, SLICE) rounded up
    to a power of two (it changes which rows are computed, not how)."""
    mb = 1
    while mb < min(m, SLICE):
        mb *= 2
    return mb


def smem_bytes(m: int, k: int, n: int, transposed: bool) -> int:
    """Dynamic shared memory of one block: the ring of weight tiles, the
    slice's x (row-major route; the parts' sums reuse it), the parts' sums
    (head), the tile's total, one mbarrier a stage."""
    mb = row_block(m)
    if transposed:
        st = head_stages(k)
        return 4 * (st * head_columns(k) * head_ld(k) + NK_THREADS * mb) \
            + 8 * st
    s = schedule(k, n)
    return _kn_smem(mb, s.chunk, s.stages)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("row_gemm").row_gemm_f32
    fn.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def _layout(w: torch.Tensor, k: int):
    """(transposed, leading stride) of w, or raise."""
    n = w.shape[1]
    if w.stride(1) == 1 and w.stride(0) >= n and n % 4 == 0:
        return 0, w.stride(0)
    if w.stride(0) == 1 and w.stride(1) >= k and k % 4 == 0:
        return 1, w.stride(1)
    raise ValueError(f"w {tuple(w.shape)} with strides {w.stride()} is "
                     "neither row-major with N % 4 == 0 nor the transposed "
                     "view of a row-major [N, K] with K % 4 == 0")


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor],
           biases: Sequence[Optional[torch.Tensor]]) -> str:
    """Validate the operands; returns their device type."""
    if x.ndim != 2 or not ws or any(
            w.ndim != 2 or w.shape[0] != x.shape[1] for w in ws):
        raise ValueError(f"needs x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and "
                         f"{[tuple(w.shape) for w in ws]}")
    for w, b in zip(ws, biases):
        if b is not None and tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} for w "
                             f"{tuple(w.shape)}")
    tensors = [x, *ws, *(b for b in biases if b is not None)]
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    if x.device.type not in build.CARD_DEVICES or any(
            t.device != x.device for t in tensors):
        raise ValueError(f"row_gemm runs on one cuda device or on the cpu, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"row_gemm takes float32, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    return "cuda"


def _launch_checks(x, ws, address) -> Optional[tuple]:
    """Raise where one launch cannot take the operands; returns (layouts,
    shared memory) or None when no launch is needed.  ``address(t)`` is a
    tensor's byte address mod 16 (the data pointer on the card, the
    storage offset in bytes under fake tensors, whose storage the
    allocator would align as it aligns every allocation)."""
    m, k = x.shape
    if m == 0 or k == 0 or all(w.shape[1] == 0 for w in ws):
        return None
    layouts = [_layout(w, k) for w in ws]
    if len(ws) > 1 and any(tr for tr, _ in layouts):
        raise ValueError("a grouped launch takes row-major weights only")
    if any(n == 0 for n in (w.shape[1] for w in ws)):
        raise ValueError("a grouped launch takes products with N > 0")
    if any(ld % 4 for _, ld in layouts) or any(
            address(t) % 16 for t in (x, *ws)):
        raise ValueError("row_gemm needs 16-byte aligned rows")
    smem = smem_bytes(m, k, ws[0].shape[1], bool(layouts[0][0]))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K={k} needs {smem} bytes of shared memory per "
                         f"block; the card has {MAX_SMEM_BYTES}")
    return layouts, smem


def _launch(x, ws, biases):
    """One launch of the kernel for ``x @ w_i (+ b_i)``; returns the
    outputs."""
    m, k = x.shape
    outs = [torch.empty((m, w.shape[1]), dtype=torch.float32,
                        device=x.device) for w in ws]
    if m == 0 or all(w.shape[1] == 0 for w in ws):
        return outs
    if k == 0:
        return [o.zero_() if b is None else o.zero_() + b
                for o, b in zip(outs, biases)]
    xc = x.contiguous()
    bs = [None if b is None else b.contiguous() for b in biases]
    layouts, smem = _launch_checks(xc, ws, lambda t: t.data_ptr())
    if any(o.data_ptr() % 16 for o in outs):
        raise ValueError("row_gemm needs 16-byte aligned rows")
    transposed = layouts[0][0]
    s = schedule(k, ws[0].shape[1])
    count = len(ws)
    status = _entry()(
        xc.data_ptr(), m, k, count,
        (_P * count)(*(w.data_ptr() for w in ws)),
        (ctypes.c_longlong * count)(*(ld for _, ld in layouts)),
        (_P * count)(*(o.data_ptr() for o in outs)),
        (_P * count)(*(None if b is None else b.data_ptr() for b in bs)),
        (_I * count)(*(w.shape[1] for w in ws)),
        transposed, s.cluster, s.chunk,
        head_stages(k) if transposed else s.stages, head_columns(k), smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "row_gemm")
    build.count(row_gemm)
    return outs


def row_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in float32, each row its own product.

    Launches the CUDA kernel on CUDA tensors (once per call; float32, any
    M, ``w`` row-major with N % 4 == 0 or the transposed view of a
    row-major [N, K] with K % 4 == 0, 16-byte aligned) and runs the plain
    version on CPU tensors; anything else raises.  The custom op
    ``repro_torch::row_gemm``.
    """
    _check(x, [w], [None])
    return row_gemm_op(x, w)


def row_gemm_group(x: torch.Tensor, ws: Sequence[torch.Tensor],
                   biases: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> list:
    """``[x @ w_i (+ b_i)]`` for up to MAX_PRODUCTS row-major weights of
    one x, in one launch on CUDA tensors: each output bitwise what
    :func:`row_gemm` gives for its product alone, followed by one float32
    add of its bias.  On CPU tensors, the plain version; anything else
    raises.  Counts one launch of :func:`row_gemm`.  The custom op
    ``repro_torch::row_gemm_group``."""
    ws = list(ws)
    biases = [None] * len(ws) if biases is None else list(biases)
    if len(biases) != len(ws) or not 1 <= len(ws) <= MAX_PRODUCTS:
        raise ValueError(f"1 to {MAX_PRODUCTS} products with one bias "
                         f"each, got {len(ws)} and {len(biases)}")
    _check(x, ws, biases)
    return row_gemm_group_op(x, ws, biases)


def _impl(x, w):
    if x.device.type == "cpu":
        return _ref.row_gemm_ref(x, w)
    with torch.cuda.device(x.device):
        return _launch(x, [w], [None])[0]


def _group_impl(x, ws, biases):
    if x.device.type == "cpu":
        return _ref.row_gemm_group_ref(x, ws, biases)
    with torch.cuda.device(x.device):
        return _launch(x, ws, biases)


def _fake_outs(x, ws, biases):
    if x.device.type != "cpu":
        _check(x, ws, biases)
        _launch_checks(x.contiguous(), ws,
                       lambda t: t.storage_offset() * t.element_size())
    return [x.new_empty((x.shape[0], w.shape[1]),
                        dtype=torch.promote_types(x.dtype, w.dtype))
            for w in ws]


def _flops(x_shape, w_shapes, *args, out_shape=None, **kwargs) -> int:
    """2 M K N summed over the products."""
    m, k = x_shape
    if isinstance(w_shapes[0], int):
        w_shapes = [w_shapes]
    return sum(2 * m * k * n for _, n in w_shapes)


row_gemm_op = build.kernel_op(
    "row_gemm", "(Tensor x, Tensor w) -> Tensor", _impl,
    lambda x, w: _fake_outs(x, [w], [None])[0], _flops)
row_gemm_group_op = build.kernel_op(
    "row_gemm_group", "(Tensor x, Tensor[] ws, Tensor?[] biases) -> Tensor[]",
    _group_impl, _fake_outs, _flops)


row_gemm.launches = 0
