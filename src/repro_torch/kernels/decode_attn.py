"""Decode attention over a quantized KV cache: the CUDA kernel and its plain
torch version.

Port of the TPU kernel ``quantized_decode_attention``
(``repro/kernels/decode_attn.py``): one query token per sequence attends
its int8-coded (or raw float) K/V cache, dequantized on the fly, with an
online softmax, a length mask and an optional sliding window.  The kernel
is ``csrc/decode_attn.cu``: the cache axis is split into chunks of
:data:`CHUNK` positions at fixed multiples of CHUNK, one block per live
(row, kv head, chunk), and the last block of a (row, kv head) combines
the chunks' softmax states in ascending order in the same launch
(:func:`chunks` is its schedule).  The plain version is
``ref.quantized_decode_attention_ref``, the reference's sequential tile
walk; ``ref.decode_attention_chunked_ref`` models the kernel's order of
arithmetic for the tests.  A row's output depends neither on B nor on
cache positions past its length.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from . import build
from . import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

CHUNK = 64            # cache positions per block: csrc/decode_attn.cu kChunk
# the kernel's shared memory per block must fit the card (227 KB on H100)
MAX_SMEM_BYTES = 232448


def chunks(t: int, length: int, window: int = 0) -> range:
    """The chunks of a row that the kernel walks, in its combine order:
    those holding a live position, in ``[max(length - window, 0),
    min(length, t))`` (no lower limit when ``window`` is 0).  Chunk c
    covers positions ``[c * CHUNK, (c + 1) * CHUNK)``; once ``t >=
    length`` the result depends on neither t nor anything of other rows.
    """
    hi = min(length, t)
    lo = max(length - window, 0) if window > 0 else 0
    if hi <= lo:
        return range(0)
    return range(lo // CHUNK, -(-hi // CHUNK))


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The bound C entry point, looked up and typed once."""
    fn = getattr(build.library("decode_attn"), symbol)
    fn.argtypes = [_P] * 9 + [_I] * 8 + [_F, _P]
    fn.restype = _I
    return fn


def smem_bytes(g: int, dh: int, t: int) -> int:
    """Shared memory of one block: q [G, dh], the dequantized K chunk
    [CHUNK, dh + 1] (padded against bank conflicts) and V chunk
    [CHUNK, dh], and the scores, then probabilities, [G, CHUNK].  The
    combine keeps its weights in the global workspace, so no term grows
    with the cache length ``t``."""
    del t
    return 4 * (g * dh + CHUNK * (dh + 1) + CHUNK * dh + g * CHUNK)


def quantized_decode_attention(q, k_codes, v_codes, k_scales, v_scales,
                               cache_len, *, window: int = 0,
                               block_t: int = 128) -> torch.Tensor:
    """Single-step attention straight over a quantized cache.

    q [B, 1, H, dh]; codes [B, T, KV, dh], int8 for b_kv < 16 or float32
    (the raw container, with unit scales); scales [B, T, KV] f32;
    ``cache_len`` an int or [B] (positions >= it are masked).  Returns
    [B, 1, H, dh] in q's dtype.  T must be a multiple of
    ``min(block_t, T)`` (cache buckets are 16 * 2^k, so it is).

    Launches the CUDA kernel on a CUDA tensor (once per call) and runs the
    plain version on a CPU tensor; nothing else is accepted.
    ``block_t`` sets the plain version's tile (the reference's); the
    kernel walks fixed chunks of CHUNK positions, so its bits do not
    depend on it.
    """
    if q.ndim != 4 or q.shape[1] != 1 or k_codes.ndim != 4:
        raise ValueError(f"needs q [B, 1, H, dh] and codes [B, T, KV, dh], "
                         f"got {tuple(q.shape)} and {tuple(k_codes.shape)}")
    b, _, h, dh = q.shape
    t, kv = k_codes.shape[1], k_codes.shape[2]
    if (k_codes.shape != v_codes.shape or k_codes.shape[0] != b
            or k_codes.shape[3] != dh
            or tuple(k_scales.shape) != (b, t, kv)
            or tuple(v_scales.shape) != (b, t, kv)):
        raise ValueError("q, codes and scales disagree on B, T, KV or dh")
    if kv < 1 or h % kv != 0:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if k_codes.dtype != v_codes.dtype or k_codes.dtype not in (
            torch.int8, torch.float32):
        raise ValueError(f"codes must both be int8 or float32, got "
                         f"{k_codes.dtype} and {v_codes.dtype}")
    bt = min(block_t, t)
    if bt < 1 or t % bt != 0:
        raise ValueError(f"cache length {t} is not a multiple of the tile "
                         f"{bt}")
    if q.device.type != "cpu" and q.device.type not in build.CARD_DEVICES:
        raise ValueError(f"quantized_decode_attention runs on cuda or cpu, "
                         f"got {q.device}")
    lens = cache_len if isinstance(cache_len, torch.Tensor) else None
    return decode_attention_op(q, k_codes, v_codes, k_scales, v_scales,
                               lens, 0 if lens is not None else
                               int(cache_len), window, block_t)


def _kernel_checks(q, k_codes, v_codes, k_scales, v_scales, lens) -> None:
    """Raise where the kernel cannot take CUDA operands (the op's real and
    fake versions both run it)."""
    if any(x.device != q.device for x in (k_codes, v_codes, k_scales,
                                          v_scales)):
        raise ValueError("operands on several devices")
    b, _, h, dh = q.shape
    t, kv = k_codes.shape[1], k_codes.shape[2]
    smem = smem_bytes(h // kv, dh, t)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"G={h // kv}, dh={dh} needs {smem} bytes of "
                         f"shared memory per block; the card has "
                         f"{MAX_SMEM_BYTES}")
    if b * kv > 65535:
        raise ValueError(f"B * KV = {b * kv} rows exceed the grid's 65535")
    if lens is not None and lens.device != q.device:
        raise ValueError("cache_len must be on q's device")


def _impl(q, k_codes, v_codes, k_scales, v_scales, lens, cache_len, window,
          block_t):
    """:func:`quantized_decode_attention` as an op: ``lens`` the lengths
    as a tensor, else the int ``cache_len``."""
    length = lens if lens is not None else cache_len
    if q.device.type == "cpu":
        return _ref.quantized_decode_attention_ref(
            q, k_codes, v_codes, k_scales, v_scales, length,
            window=window, block_t=block_t)
    _kernel_checks(q, k_codes, v_codes, k_scales, v_scales, lens)
    b, _, h, dh = q.shape
    t, kv = k_codes.shape[1], k_codes.shape[2]
    g = h // kv
    smem = smem_bytes(g, dh, t)
    if lens is None:
        lens = torch.full((b,), cache_len, device=q.device)
    else:
        lens = lens.reshape(-1).expand(b)
    lens = lens.to(torch.int32).contiguous()
    qf = q.to(torch.float32).contiguous()
    kc, vc = k_codes.contiguous(), v_codes.contiguous()
    ks = k_scales.to(torch.float32).contiguous()
    vs = v_scales.to(torch.float32).contiguous()
    out = torch.empty((b, 1, h, dh), dtype=torch.float32, device=q.device)
    if out.numel():
        n_chunks = -(-t // CHUNK)
        ws = torch.empty(b * kv * n_chunks * g * (dh + 2),
                         dtype=torch.float32, device=q.device)
        counters = build.arrival_counters(q.device, b * kv)
        # 16-byte loads: whole rows of 16 bytes at 16-byte addresses
        vec = int(dh * kc.element_size() % 16 == 0
                  and kc.data_ptr() % 16 == 0 and vc.data_ptr() % 16 == 0)
        symbol = ("decode_attn_i8" if kc.dtype == torch.int8
                  else "decode_attn_f32")
        with torch.cuda.device(q.device):
            status = _entry(symbol)(
                qf.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), counters.data_ptr(), smem, b, t, kv, g, dh,
                int(window), vec, dh ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        build.check(status, "quantized_decode_attention")
        build.count(quantized_decode_attention)
    return out.to(q.dtype)


def _fake(q, k_codes, v_codes, k_scales, v_scales, lens, cache_len, window,
          block_t):
    if q.device.type != "cpu":
        _kernel_checks(q, k_codes, v_codes, k_scales, v_scales, lens)
    return q.new_empty(q.shape)


def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """Both products of one query over every cached position, masked or
    not, as the reference's einsums count them: 2 x 2 B H T dh."""
    b, _, h, dh = q_shape
    return 4 * b * h * k_shape[1] * dh


decode_attention_op = build.kernel_op(
    "quantized_decode_attention",
    "(Tensor q, Tensor k_codes, Tensor v_codes, Tensor k_scales, "
    "Tensor v_scales, Tensor? lens, int cache_len, int window, "
    "int block_t) -> Tensor", _impl, _fake, _flops)


quantized_decode_attention.launches = 0
