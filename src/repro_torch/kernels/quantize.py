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

import torch

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
