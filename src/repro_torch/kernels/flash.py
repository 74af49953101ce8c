"""Flash attention: the CUDA kernel, its plain torch version, and the
differentiable wrapper.

Port of the TPU kernel ``flash_attention_fwd`` (``repro/kernels/flash.py``):
causal, sliding-window or bidirectional GQA attention with an online
softmax, fully masked kv tiles skipped.  The kernel is
``csrc/flash_attn.cu``: both products on the tensor cores as three TF32
passes (an error-compensated split of each f32 operand, f32 parity);
``ref.flash_split_emulation`` models its arithmetic for the tests.  The
plain version is ``ref.flash_attention_ref``.
:func:`flash_attention` is the reference's ``custom_vjp``: its forward is
:func:`flash_attention_fwd` and its backward recomputes through
``ref.ref_attention`` with autograd, as the reference's ``_fa_bwd`` does
(the JAX package has no backward kernel).
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

MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The bound C entry point, looked up and typed once."""
    fn = getattr(build.library("flash_attn"), symbol)
    fn.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
    fn.restype = _I
    return fn


def _copies_16(*xs) -> bool:
    """Whether the kernel may stage these f32 operands 16 bytes at a time:
    rows of a multiple of 4 elements at 16-byte-aligned addresses."""
    return all(x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
               and all(x.stride(i) % 4 == 0 for i in range(3)) for x in xs)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_k: int = 512,
                        kv_len=None) -> torch.Tensor:
    """q [B, H, S, dh]; k, v [B, KV, T, dh]; H = KV * G.  Returns
    [B, H, S, dh] in q's dtype (f32 or bf16; arithmetic in f32).

    ``kv_len`` (an int or [B]; default T) masks the keys at positions >=
    it, causal or not.  Operands may be strided views (the last axis
    contiguous): the model passes its [B, S, H, dh] activations
    transposed, without a copy, and the output has q's strides.

    Launches the CUDA kernel on a CUDA tensor and runs the plain version
    on a CPU tensor; nothing else is accepted.  ``block_q``/``block_k``
    set the plain version's tiles (the reference's); the kernel's tiles
    are a fixed 64 x 64, so its bits depend on neither.  Raises on a CUDA
    tensor the kernel cannot take (head_dim > MAX_HEAD_DIM, another dtype).
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"needs q [B, H, S, dh] and k, v [B, KV, T, dh], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError("q and k, v disagree on B or dh")
    if kv < 1 or h % kv != 0:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, block_q=block_q,
                                        block_k=block_k, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, got "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("operands on several devices")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    if kv_len is None:
        lens = None
    elif isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device:
            raise ValueError("kv_len must be on q's device")
        lens = kv_len.reshape(-1).expand(b).to(torch.int32).contiguous()
    else:
        lens = torch.full((b,), int(kv_len), dtype=torch.int32,
                          device=q.device)
    out = torch.empty_like(q)            # q's strides when q is dense
    if out.numel():
        strides = (ctypes.c_longlong * 12)(
            *(x.stride(i) for x in (q, k, v, out) for i in range(3)))
        f32 = q.dtype == torch.float32
        symbol = "flash_attn_f32" if f32 else "flash_attn_bf16"
        with torch.cuda.device(q.device):
            status = _entry(symbol)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lens is None else lens.data_ptr(),
                ctypes.addressof(strides), b, h, kv, s, t, dh, int(causal),
                int(window), dh ** -0.5, int(f32 and _copies_16(q, k, v)),
                torch.cuda.current_stream().cuda_stream)
        build.check(status, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_fwd`; backward recomputes
    the attention through ``ref.ref_attention`` and differentiates that
    (the reference's ``_fa_fwd``/``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = _ref.ref_attention(*leaves, ctx.causal, ctx.window)
        dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Differentiable fused attention, q [B, H, S, dh], k/v [B, KV, T, dh]
    (the reference's ``flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal, window)
