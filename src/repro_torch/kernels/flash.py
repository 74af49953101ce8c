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
from .bucketing import seq_bucket

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The bound C entry point, looked up and typed once."""
    fn = getattr(build.library("flash_attn"), symbol)
    fn.argtypes = [_P] * 6 + [_I] * 9 + [_F, _I, _P]
    fn.restype = _I
    return fn


def _copies_16(*xs) -> bool:
    """Whether the kernel may stage these f32 operands 16 bytes at a time:
    rows of a multiple of 4 elements at 16-byte-aligned addresses."""
    return all(x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
               and all(x.stride(i) % 4 == 0 for i in range(3)) for x in xs)


def _kernel_checks(q, k, v) -> None:
    """Raise where the kernel cannot take CUDA operands: several devices,
    another dtype, head_dim > MAX_HEAD_DIM.  The op's real and fake
    versions both run it, so an accounting under fake tensors refuses
    what the card would."""
    if k.device != q.device or v.device != q.device:
        raise ValueError("operands on several devices")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_k: int = 512,
                        kv_len=None, q_offset: int = 0) -> torch.Tensor:
    """q [B, H, S, dh]; k, v [B, KV, T, dh]; H = KV * G.  Returns
    [B, H, S, dh] in q's dtype (f32 or bf16; arithmetic in f32).

    ``kv_len`` (an int or [B]; default T) masks the keys at positions >=
    it, causal or not.  ``q_offset`` >= 0 places query row r at position
    ``q_offset + r`` for the causal and window masks: a sequence chunk's
    queries against the whole sequence's keys (sequence-parallel
    attention); 0 is the kernel as before it took an offset.  Operands
    may be strided views (the last axis contiguous): the model passes its
    [B, S, H, dh] activations transposed, without a copy, and the output
    has q's strides.

    Launches the CUDA kernel on a CUDA tensor and runs the plain version
    on a CPU tensor; nothing else is accepted.  ``block_q``/``block_k``
    set the plain version's tiles (the reference's); the kernel's tiles
    are a fixed 64 x 64, so its bits depend on neither.  Raises on a CUDA
    tensor the kernel cannot take (head_dim > MAX_HEAD_DIM, another dtype).
    The work is the custom op ``repro_torch::flash_attention_fwd``.
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
    if q.device.type != "cpu" and q.device.type not in build.CARD_DEVICES:
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, got "
                         f"{q.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    lens = kv_len if isinstance(kv_len, torch.Tensor) else None
    n = -1 if kv_len is None or lens is not None else int(kv_len)
    return flash_attention_op(q, k, v, lens, n, causal, window, block_q,
                              block_k, int(q_offset))


def _impl(q, k, v, lens, kv_len, causal, window, block_q, block_k,
          q_offset=0):
    """:func:`flash_attention_fwd` as an op: ``lens`` a [B] (or scalar)
    tensor of key lengths, else ``kv_len`` (-1: every key)."""
    length = lens if lens is not None else (None if kv_len < 0 else kv_len)
    if q.device.type == "cpu":
        # dense, as the fake version says (the plain version's output
        # can be a view of its padded tiles)
        return _ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, block_q=block_q,
            block_k=block_k, kv_len=length, q_offset=q_offset).contiguous()
    _kernel_checks(q, k, v)
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    if length is None:
        lens = None
    elif isinstance(length, torch.Tensor):
        if length.device != q.device:
            raise ValueError("kv_len must be on q's device")
        lens = length.reshape(-1).expand(b).to(torch.int32).contiguous()
    else:
        lens = torch.full((b,), length, dtype=torch.int32, device=q.device)
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
                int(window), int(q_offset), dh ** -0.5,
                int(f32 and _copies_16(q, k, v)),
                torch.cuda.current_stream().cuda_stream)
        build.check(status, "flash_attention_fwd")
        build.count(flash_attention_fwd)
    return out


def _fake(q, k, v, lens, kv_len, causal, window, block_q, block_k,
          q_offset=0):
    if q.device.type != "cpu":
        _kernel_checks(q, k, v)
        if lens is not None and lens.device != q.device:
            raise ValueError("kv_len must be on q's device")
        return torch.empty_like(q if q.stride(-1) == 1 else q.contiguous())
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """The dots the reference's census counts for this attention on its
    ``baseline`` path, ``layers.blockwise_attention``: both einsums of
    every (q block, kv block) pair of its scan, masked or not, over the
    sequence and keys padded to whole blocks of min(512, seq_bucket),
    2 x 2 B H S_pad T_pad dh.  A query chunk at an offset (sequence-
    parallel attention) bills its own rows against every key: the
    reference's census of the same step over a sequence-sharded
    residual counts its whole-key blocks alike."""
    b, h, s, dh = q_shape
    t = k_shape[2]
    sp = -(-s // min(512, seq_bucket(s))) * min(512, seq_bucket(s))
    tp = -(-t // min(512, seq_bucket(t))) * min(512, seq_bucket(t))
    return 4 * b * h * sp * tp * dh


flash_attention_op = build.kernel_op(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? lens, int kv_len, bool causal, "
    "int window, int block_q, int block_k, int q_offset=0) -> Tensor",
    _impl, _fake, _flops)


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_fwd`; backward recomputes
    the attention through ``ref.ref_attention`` and differentiates that
    (the reference's ``_fa_fwd``/``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = _ref.ref_attention(*leaves, ctx.causal, ctx.window,
                                     ctx.q_offset)
        dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Differentiable fused attention, q [B, H, S, dh], k/v [B, KV, T, dh]
    (the reference's ``flash_attention``); ``q_offset`` as in
    :func:`flash_attention_fwd`."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
