"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/kernels/`` at the repo
root, named by a digest of their source and flags, and are built at first
use: a fresh checkout builds everything the first time a kernel launches,
or up front through :func:`build_all`.  All sources compile in parallel,
one ``nvcc`` process each.

Flags: ``sm_90a`` (Hopper), ``-O3``, and deliberately no
``--use_fast_math``: the quantizer's ``amax / levels`` and ``w / scale``
must stay IEEE true divisions to match the reference's codes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("group_quantize", "qmm", "decode_attn", "flash_attn", "row_gemm",
           "tc_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}

#: the devices whose tensors take the kernels' path: the card, and
#: ``meta``, the dry-run's stand-in for it (shapes only: an op on a meta
#: tensor runs its fake version, which refuses what the kernel would)
CARD_DEVICES = ("cuda", "meta")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for this source."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES, *,
              verbose: bool = False) -> float:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together; returns the seconds taken.

    ``verbose`` adds ``-Xptxas -v`` and prints each compiler's output
    (registers, shared memory and spills per kernel).
    """
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log.rstrip()}")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)    # atomic: a concurrent loader never sees
    if failed:                  # a half-written library
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build_all((name,))
        _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return _loaded[name]


_counters: Dict[torch.device, torch.Tensor] = {}


def arrival_counters(device, n: int):
    """Zeroed int32 arrival counters, at least ``n``, kept per device.

    A kernel that combines partial results across blocks in one launch
    (qmm's split K, decode attention's chunks) counts its blocks in on
    them, and the last block to arrive resets its counter, so they are
    zero again after every launch.  The kernels that use them must not
    run concurrently on one device (the port launches on one stream).
    """
    have = _counters.get(device)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # the graph would keep the old buffer's address
            raise RuntimeError("arrival counters must be allocated before a "
                               "CUDA graph capture (run the call eagerly "
                               "first)")
        have = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = have
    return have


# while a CUDA graph captures: {counter key: launches it recorded}
_recorded: Optional[Dict[str, int]] = None


def count(fn, route: Optional[str] = None) -> None:
    """Count one launch of ``fn``'s kernel (on ``route``): on ``fn.launches``
    (and ``fn.route_launches[route]``) when the kernel runs now; while a
    CUDA graph captures (:func:`recording`), in that capture's record
    instead, since the kernel then runs at each of the graph's replays."""
    if _recorded is not None:
        for key in (fn.__name__,) + ((f"{fn.__name__}.{route}",)
                                     if route else ()):
            _recorded[key] = _recorded.get(key, 0) + 1
        return
    fn.launches += 1
    if route is not None:
        fn.route_launches[route] += 1


@contextlib.contextmanager
def recording():
    """Around a CUDA graph capture: yields the dict that collects the
    launches the capture records, ``{name: n, "name.route": n}``."""
    global _recorded
    if _recorded is not None:
        raise RuntimeError("captures do not nest")
    _recorded = {}
    try:
        yield _recorded
    finally:
        _recorded = None


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


# ---------------------------------------------------------------------------
# the kernels as torch.library ops
# ---------------------------------------------------------------------------

LIB = torch.library.Library("repro_torch", "DEF")


def kernel_op(name: str, schema: str, impl: Callable, fake: Callable,
              flops: Optional[Callable] = None):
    """Define the op ``repro_torch::<name><schema>`` and return its
    overload.  ``impl`` serves CPU and CUDA tensors (it branches on the
    device: the plain version or the launch); ``fake`` computes the
    outputs' shapes for fake and meta tensors, allocating and launching
    nothing, and raises wherever the kernel would; ``flops`` (a
    ``torch.utils.flop_counter`` formula over the arguments' shapes) is
    the op's FLOP count, None for an op opaque to the census.  Defined at
    the dispatcher's level (``Library.define`` and ``impl``) rather than
    through ``torch.library.custom_op``: a call costs a few microseconds
    of host time instead of about twenty."""
    LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        LIB.impl(name, impl, key)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    if flops is not None:
        register_flop_formula(packet)(flops)
    return packet.default
