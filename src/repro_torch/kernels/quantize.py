"""Fused group quantizer: the CUDA kernel and its plain torch version.

Port of the TPU kernel ``group_quantize`` (``repro/kernels/quantize.py``).
For each (group of G contraction rows, column): ``scale = amax / levels``
(1.0 for an all-zero group) and ``codes = clip(round(w / scale), ±levels)``
with ``levels = 2^(bits-1) - 1``.  The kernel is
``csrc/group_quantize.cu``, with two routes that :func:`route` picks from
the shape alone:

* ``"vector"`` (N a multiple of 4, G a multiple of 16 up to 256; every
  main-path shape): one launch quantizes a whole list of matrices
  (:func:`group_quantize_many`, at most :data:`MAX_DESCS` a launch), each
  cut into [G, 128] tiles, one block a tile (:func:`schedule`); codes of
  <= 4 bits can come back nibble-packed straight from the kernel;
* ``"simt"`` (any other shape): the first kernel, one thread per (group,
  column), one launch per matrix.

The plain version is ``ref.group_quantize_ref`` (and ``ref.pack_int4_ref``);
:func:`emulate_vector` replays the vector route's tile schedule in plain
torch.  Codes and scales are bitwise the plain version's (and the
reference's).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.quantization import wire_bytes
from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int

ROUTES = ("vector", "simt")
TILE_N = 128          # columns of a vector-route tile (32 lanes x 4)
WARPS = 8             # row slices of a tile: G / 8 consecutive rows each
MAX_GROUP = 256       # rows a tile holds in registers (32 per thread)
MAX_DESCS = 64        # matrices per vector launch (its kernel parameters)


def route(k: int, n: int, group: int) -> str:
    """The kernel a [K, N] weight with groups of ``group`` rows takes:
    ``"vector"`` when N is a multiple of 4 (16-byte rows) and G a multiple
    of 16 no larger than MAX_GROUP, ``"simt"`` otherwise."""
    if n % 4 == 0 and group % 16 == 0 and 0 < group <= MAX_GROUP \
            and k % group == 0:
        return "vector"
    return "simt"


def schedule(shapes: Sequence[Tuple[int, int, int]]) -> Tuple[List[int], int]:
    """The vector launch's blocks for matrices of (K, N, G): the first block
    of each and the total.  A matrix takes (K / G) x ceil(N / TILE_N)
    blocks, group-major; block ``first + g * ceil(N / TILE_N) + t`` owns
    rows [g G, (g + 1) G) and columns [t TILE_N, (t + 1) TILE_N)."""
    firsts, total = [], 0
    for k, n, g in shapes:
        firsts.append(total)
        total += (k // g) * -(-n // TILE_N)
    return firsts, total


def _slots(groups) -> int:
    """Register slots per thread: a power of two >= every G / WARPS."""
    need = max(g // WARPS for g in groups)
    r = 2
    while r < need:
        r *= 2
    return r


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The bound C entry point, looked up and typed once."""
    fn = getattr(build.library("group_quantize"), symbol)
    if symbol == "group_quantize_vec_f32":
        fn.argtypes = [_P, _I, _I, _I, _P]
    else:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(w: torch.Tensor, group: int, bits: int) -> None:
    if w.ndim != 2:
        raise ValueError(f"group_quantize needs a [K, N] matrix, got "
                         f"{tuple(w.shape)}")
    k = w.shape[0]
    if group < 1 or k % group != 0:
        raise ValueError(f"group size {group} does not divide K={k}")
    if not 1 <= bits <= 8:
        raise ValueError(f"int8 codes hold 1..8 bits, got {bits}")


def group_quantize(w: torch.Tensor, *, group_size: int = 128, bits: int = 8,
                   pack: bool = False):
    """w [K, N] float -> (codes int8 [K, N], scales f32 [K//G, N]).

    With ``pack`` and ``bits <= 4`` the codes come back nibble-packed
    [K/2, N] (``ref.pack_int4_ref``'s layout).  The one-matrix case of
    :func:`group_quantize_many`: on a CUDA tensor one launch of the route
    the shape takes (any G dividing K, any N), on a CPU tensor the plain
    version.  Nothing else is accepted.
    """
    return group_quantize_many([w], [group_size], [bits], pack=pack)[0]


def group_quantize_many(ws: Sequence[torch.Tensor], groups: Sequence[int],
                        bits: Sequence[int], *, pack: bool = False):
    """Quantize every matrix ``ws[i]`` at ``groups[i]`` and ``bits[i]``;
    returns [(codes, scales)] in order (packed as in
    :func:`group_quantize`).

    On CUDA tensors the matrices on the vector route go out in one launch
    (per MAX_DESCS), each other matrix in a SIMT launch of its own; on CPU
    tensors the plain version runs.
    """
    if not len(ws) == len(groups) == len(bits):
        raise ValueError("group_quantize_many: ws, groups and bits differ "
                         "in length")
    for w, g, b in zip(ws, groups, bits):
        _check(w, g, b)
    devices = {w.device for w in ws}
    if len(devices) > 1:
        raise ValueError(f"group_quantize_many: matrices on several devices "
                         f"{devices}")
    if not ws:
        return []
    flat = group_quantize_op(list(ws), list(groups), list(bits), pack)
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(ws))]


def _impl(ws, groups, bits, pack):
    """:func:`group_quantize_many` as an op: [codes_0, scales_0, codes_1,
    ...]."""
    dev = ws[0].device
    if dev.type == "cpu":
        out = []
        for w, g, b in zip(ws, groups, bits):
            codes, scales = _ref.group_quantize_ref(w, g, b)
            out += [_ref.pack_int4_ref(codes) if pack and b <= 4
                    else codes, scales]
        return out
    if dev.type != "cuda":
        raise ValueError(f"group_quantize runs on cuda or cpu, got {dev}")
    out: List = [None] * len(ws)
    vec = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, (w, g, b) in enumerate(zip(ws, groups, bits)):
            k, n = w.shape
            wf = w.to(torch.float32).contiguous()
            if wf.data_ptr() % 16:
                wf = wf.clone()
            scales = torch.empty((k // g, n), dtype=torch.float32, device=dev)
            packed = pack and b <= 4
            if route(k, n, g) == "vector":
                codes = torch.empty((k // 2 if packed else k, n),
                                    dtype=torch.int8, device=dev)
                vec.append((i, wf, codes, scales, g, b, packed))
                continue
            codes = torch.empty((k, n), dtype=torch.int8, device=dev)
            if wf.numel():
                status = _entry("group_quantize_f32")(
                    wf.data_ptr(), codes.data_ptr(), scales.data_ptr(), k, n,
                    g, b, stream)
                build.check(status, "group_quantize_f32")
                build.count(group_quantize, "simt")
            out[i] = (_ref.pack_int4_ref(codes) if packed else codes, scales)
        for lo in range(0, len(vec), MAX_DESCS):
            chunk = [v for v in vec[lo:lo + MAX_DESCS] if v[1].numel()]
            for i, _, codes, scales, *_ in vec[lo:lo + MAX_DESCS]:
                out[i] = (codes, scales)
            if not chunk:
                continue
            firsts, blocks = schedule([(wf.shape[0], wf.shape[1], g)
                                       for _, wf, _, _, g, _, _ in chunk])
            table = np.array(
                [[wf.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                  wf.shape[0], wf.shape[1], g, 2 ** (b - 1) - 1,
                  int(packed), first]
                 for (_, wf, codes, scales, g, b, packed), first
                 in zip(chunk, firsts)], dtype=np.int64)
            status = _entry("group_quantize_vec_f32")(
                table.ctypes.data, len(chunk), blocks,
                _slots([c[4] for c in chunk]), stream)
            build.check(status, "group_quantize_vec_f32")
            build.count(group_quantize, "vector")
    return [t for pair in out for t in pair]


def _fake(ws, groups, bits, pack):
    dev = ws[0].device
    if dev.type != "cpu" and dev.type not in build.CARD_DEVICES:
        raise ValueError(f"group_quantize runs on cuda or cpu, got {dev}")
    out = []
    for w, g, b in zip(ws, groups, bits):
        k, n = w.shape
        out += [w.new_empty((k // 2 if pack and b <= 4 else k, n),
                            dtype=torch.int8),
                w.new_empty((k // g, n), dtype=torch.float32)]
    return out


def _flops(*args, out_shape=None, **kwargs) -> int:
    """No products: the quantizer's cost is its bytes."""
    return 0


group_quantize_op = build.kernel_op(
    "group_quantize",
    "(Tensor[] ws, int[] groups, int[] bits, bool pack) -> Tensor[]",
    _impl, _fake, _flops)


def emulate_vector(ws: Sequence[torch.Tensor], groups: Sequence[int],
                   bits: Sequence[int], *, pack: bool = False):
    """The vector route's arithmetic in plain torch, block by block of its
    :func:`schedule`: each of the WARPS row slices of a tile reduces its
    own rows' absmax, the slices' maxima meet, and every element is scaled,
    rounded and clipped (and, packed, paired with the next row) where the
    kernel does it.  Every output element must be written by exactly one
    block.  For the CPU tests; returns what :func:`group_quantize_many`
    returns."""
    for w, g, b in zip(ws, groups, bits):
        _check(w, g, b)
        if route(w.shape[0], w.shape[1], g) != "vector":
            raise ValueError(f"{tuple(w.shape)} at G={g} is not on the "
                             f"vector route")
    firsts, total = schedule([(w.shape[0], w.shape[1], g)
                              for w, g in zip(ws, groups)])
    outs, written = [], []
    for w, g, b in zip(ws, groups, bits):
        k, n = w.shape
        rows = k // 2 if pack and b <= 4 else k
        outs.append((torch.zeros((rows, n), dtype=torch.int8),
                     torch.zeros((k // g, n), dtype=torch.float32)))
        written.append(torch.zeros((rows, n), dtype=torch.int32))
    for blk in range(total):
        i = max(j for j, f in enumerate(firsts) if f <= blk)
        w, g, b = ws[i].to(torch.float32), groups[i], bits[i]
        n = w.shape[1]
        col_tiles = -(-n // TILE_N)
        grp, t = divmod(blk - firsts[i], col_tiles)
        c0, c1 = t * TILE_N, min((t + 1) * TILE_N, n)
        tile = w[grp * g:(grp + 1) * g, c0:c1]
        slices = tile.reshape(WARPS, g // WARPS, c1 - c0)
        amax = torch.amax(torch.amax(slices.abs(), dim=1), dim=0)
        levels = 2 ** (b - 1) - 1
        inv = float(np.float32(1.0) / np.float32(levels))
        scale = torch.where(amax > 0, amax * inv, 1.0)
        q = torch.clamp(torch.round(tile / scale), -levels, levels)
        codes, scales = outs[i]
        scales[grp, c0:c1] = scale
        if pack and b <= 4:
            r0 = grp * g // 2
            codes[r0:r0 + g // 2, c0:c1] = _ref.pack_int4_ref(
                q.to(torch.int8))
            written[i][r0:r0 + g // 2, c0:c1] += 1
        else:
            codes[grp * g:(grp + 1) * g, c0:c1] = q.to(torch.int8)
            written[i][grp * g:(grp + 1) * g, c0:c1] += 1
    for cnt in written:
        if not bool((cnt == 1).all()):
            raise AssertionError("the vector schedule does not write every "
                                 "code exactly once")
    return outs


group_quantize.launches = 0
group_quantize.route_launches = dict.fromkeys(ROUTES, 0)


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
