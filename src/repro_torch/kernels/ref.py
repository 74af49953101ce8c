"""Plain torch versions of the quantized kernels (``repro/kernels/ref.py``).

Shapes / conventions shared with ``qmm.py`` and ``quantize.py``:

  x       [M, K]            activations (f32 or bf16)
  codes   [K, N]  int8      quantized weights (int4 values live in [-7, 7])
  scales  [K // G, N] f32   per-(group, out-channel) scales, group size G
                            along the contraction axis
  out     [M, N]            x @ (codes * scales)

``quantized_decode_attention_ref`` is the plain version of the decode
attention kernel, on the reference's decode layouts; ``flash_attention_ref``
(at the end) that of the flash kernel, and ``ref_attention`` the oracle its
backward recomputes through; ``row_gemm_ref`` that of the row-independent
GEMM.

Every wrapper runs these on a CPU tensor; on the card they are what the
CUDA kernels are held against.  Division is true division and rounding is
``torch.round`` (half to even, like ``jnp.round``), so codes and scales
match the reference's exactly.
"""

from __future__ import annotations

import torch

from .bucketing import seq_bucket


def dequantize_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 codes + [K//G, N] scales -> [K, N] f32 weights."""
    k = codes.shape[0]
    g = k // scales.shape[0]
    s_full = torch.repeat_interleave(scales, g, dim=0)
    return codes.to(torch.float32) * s_full


def qmm_ref(x: torch.Tensor, codes: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """Dequantize, then matmul in f32; output in x's dtype."""
    w = dequantize_ref(codes, scales)
    return (x.to(torch.float32) @ w).to(x.dtype)


def row_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N], one product per row.

    BLAS libraries sum a one-row product in another order than a product
    of several rows (a gemv against a gemm on the CPU), so a row's bits
    would depend on M; one product per row keeps them the row's own.
    """
    if x.shape[0] == 0:
        return x.new_zeros((0, w.shape[1]))
    return torch.cat([x[i:i + 1] @ w for i in range(x.shape[0])])


def row_gemm_group_ref(x: torch.Tensor, ws, biases) -> list:
    """``[x @ w_i (+ b_i)]``: :func:`row_gemm_ref` per product, then one
    add of its bias (None for none), as ``layers.qkv_project`` adds it."""
    outs = [row_gemm_ref(x, w) for w in ws]
    return [y if b is None else y + b for y, b in zip(outs, biases)]


def group_quantize_ref(w: torch.Tensor, group_size: int, bits: int = 8):
    """w [K, N] float -> (codes int8 [K, N], scales f32 [K//G, N]).

    Symmetric: scale = absmax / (2^(bits-1) - 1) (1.0 for an all-zero
    group), codes = clip(round(w / scale), -levels, levels).

    The scale is formed as ``amax * fl(1 / levels)``: XLA compiles the
    reference's division by the constant ``levels`` into that product, so
    this is the arithmetic of the reference's ``ops.group_quantize`` (its
    Pallas kernel and its jitted fallback), and codes and scales match it
    bitwise.  ``w / scale`` stays a true division.
    """
    k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"group size {group_size} does not divide K={k}")
    levels = 2 ** (bits - 1) - 1
    wg = w.reshape(k // group_size, group_size, n).to(torch.float32)
    amax = torch.amax(torch.abs(wg), dim=1)                     # [K//G, N]
    inv = torch.reciprocal(torch.tensor(float(levels), dtype=torch.float32,
                                        device=w.device))
    scales = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    codes = torch.clamp(torch.round(wg / scales[:, None, :]), -levels, levels)
    return codes.reshape(k, n).to(torch.int8), scales


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """[K//2, N] packed (two 4-bit codes per byte along K) -> [K, N] int8.

    Byte r holds code[2r] in the low nibble and code[2r+1] in the high
    nibble, two's complement.
    """
    p = packed.to(torch.int32)
    lo = p & 0x0F
    hi = (p >> 4) & 0x0F
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def pack_int4_ref(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_int4_ref`: [K, N] int8 in [-7, 7] ->
    [K//2, N] packed bytes."""
    k, n = codes.shape
    if k % 2 != 0:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    c = codes.reshape(k // 2, 2, n).to(torch.int32)
    lo = c[:, 0] & 0x0F
    hi = (c[:, 1] & 0x0F) << 4
    # values 128..255 wrap to negative int8, as the reference's astype does
    return (lo | hi).to(torch.uint8).view(torch.int8)


def qmm_int4_ref(x: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """The int4-packed matmul: unpack along K, then :func:`qmm_ref`."""
    return qmm_ref(x, unpack_int4_ref(packed), scales)


def split_bf16(x: torch.Tensor):
    """f32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly (for
    |x| from ~1e-31 up): the split the tensor-core qmm kernel makes."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def qmm_split_emulation(x: torch.Tensor, codes: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """The tensor-core qmm kernel's order of arithmetic, in plain torch
    (for the tests; no caller on a path): per group, the three bf16
    pieces of x times the exact codes summed in f32, then
    ``total = fma(partial, scale, total)`` (the product and sum formed in
    float64 and rounded once to f32).  int8 codes [K, N]; f32 out."""
    k = codes.shape[0]
    g = k // scales.shape[0]
    c = codes.to(torch.float32)
    pieces = [p.to(torch.float32) for p in split_bf16(x)]
    total = torch.zeros(x.shape[0], codes.shape[1], dtype=torch.float32,
                        device=x.device)
    for i in range(scales.shape[0]):
        rows = slice(i * g, (i + 1) * g)
        partial = sum(p[:, rows] @ c[rows] for p in pieces)
        total = (partial.double() * scales[i].double()
                 + total.double()).to(torch.float32)
    return total


# ---------------------------------------------------------------------------
# Decode attention over a quantized KV cache (``repro/kernels/decode_attn.py``)
# ---------------------------------------------------------------------------

NEG_INF = -1e30   # finite: -inf would make exp(m - m_new) a NaN on a fully
                  # masked tile


def quantized_decode_attention_ref(q, k_codes, v_codes, k_scales, v_scales,
                                   cache_len, *, window: int = 0,
                                   block_t: int = 128):
    """One-token GQA attention straight over a quantized cache.

    q [B, 1, H, dh]; codes [B, T, KV, dh] (int8, or the raw float
    container with unit scales); scales [B, T, KV] f32; ``cache_len`` an
    int or [B].  Returns [B, 1, H, dh] in q's dtype.

    The reference's schedule: the H = KV * G query heads fold into B * KV
    rows of G queries each (vectorised here), and the kv tiles of
    ``bt = min(block_t, T)`` positions are walked in ascending order
    through the online-softmax update of ``_tile_update``: dequantize the
    tile, scores scaled by dh**-0.5, positions >= cache_len (or before
    cache_len - window when ``window > 0``) set to ``NEG_INF``, running
    max, ``p`` zeroed where masked, then ``l`` and ``acc`` rescaled by
    ``exp(m - m_new)``; the output is ``acc / max(l, 1e-30)``.  A fully
    masked tile leaves (m, l, acc) exactly as they were, so growing T
    with ``cache_len`` fixed changes no bit.

    Dot products are elementwise products summed over one axis, never
    batched matmuls, so a row's bits do not depend on B.
    """
    b, _, h, dh = q.shape
    t, kv = k_codes.shape[1], k_codes.shape[2]
    g = h // kv
    bt = min(block_t, t)
    if t % bt != 0:
        raise ValueError(f"cache length {t} is not a multiple of the tile "
                         f"{bt}")
    dev = q.device
    lens = torch.as_tensor(cache_len, device=dev).reshape(-1)
    lens = lens.expand(b).to(torch.int64)[:, None, None, None]  # [B,1,1,1]
    scale = dh ** -0.5
    qr = q.reshape(b, kv, g, 1, dh).to(torch.float32)
    m = torch.full((b, kv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, dh), dtype=torch.float32, device=dev)
    for j in range(t // bt):
        sl = slice(j * bt, (j + 1) * bt)
        # [B, bt, KV, dh] -> [B, KV, 1, bt, dh]
        k = (k_codes[:, sl].to(torch.float32)
             * k_scales[:, sl, :, None]).permute(0, 2, 1, 3)[:, :, None]
        v = (v_codes[:, sl].to(torch.float32)
             * v_scales[:, sl, :, None]).permute(0, 2, 1, 3)[:, :, None]
        s = torch.sum(qr * k, dim=-1) * scale                # [B,KV,G,bt]
        kpos = j * bt + torch.arange(bt, device=dev)
        valid = kpos < lens
        if window > 0:
            valid = valid & (kpos >= lens - window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * corr + torch.sum(p[..., None] * v, dim=-2)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def decode_attention_chunked_ref(q, k_codes, v_codes, k_scales, v_scales,
                                 cache_len, *, window: int = 0):
    """The decode kernel's order of arithmetic, in plain torch (for the
    tests; no caller on a path).

    Same inputs and output as :func:`quantized_decode_attention_ref`.
    Each row walks the live chunks of ``decode_attn.chunks`` (CHUNK
    positions at fixed multiples of CHUNK; positions outside the live
    range dequantized as 0): a chunk's state is ``_tile_update`` from the
    initial one (m = the chunk's max score, p = exp(s - m) or 0, l = sum
    p, acc = p . V); then the states combine in ascending chunk order,
    m* = max m_c, l = sum l_c exp(m_c - m*), acc = sum acc_c exp(m_c -
    m*), out = acc / max(l, 1e-30).  A row with no live position gets 0.
    Rows are computed one at a time on fixed-size chunks, so a row's bits
    depend neither on B nor on T once T >= its length.
    """
    from .decode_attn import CHUNK, chunks
    b, _, h, dh = q.shape
    t, kv = k_codes.shape[1], k_codes.shape[2]
    g = h // kv
    dev = q.device
    lens = torch.as_tensor(cache_len).reshape(-1).expand(b).tolist()
    scale = dh ** -0.5
    pos = torch.arange(CHUNK, device=dev)
    out = torch.zeros((b, kv, g, dh), dtype=torch.float32, device=dev)
    for i in range(b):
        n = int(lens[i])
        hi = min(n, t)
        lo = max(n - window, 0) if window > 0 else 0
        qr = q[i, 0].reshape(kv, g, 1, dh).to(torch.float32)
        states = []
        for c in chunks(t, n, window):
            t0 = c * CHUNK
            valid = (t0 + pos >= lo) & (t0 + pos < hi)            # [C]
            rows = slice(t0, min(t0 + CHUNK, t))
            kd = torch.zeros((CHUNK, kv, dh), device=dev)
            vd = torch.zeros((CHUNK, kv, dh), device=dev)
            kd[:rows.stop - t0] = (k_codes[i, rows].to(torch.float32)
                                   * k_scales[i, rows, :, None])
            vd[:rows.stop - t0] = (v_codes[i, rows].to(torch.float32)
                                   * v_scales[i, rows, :, None])
            kd = torch.where(valid[:, None, None], kd, 0.0)
            vd = torch.where(valid[:, None, None], vd, 0.0)
            kd, vd = kd.permute(1, 0, 2)[:, None], vd.permute(1, 0, 2)
            sc = torch.sum(qr * kd, dim=-1) * scale               # [KV,G,C]
            sc = torch.where(valid, sc, NEG_INF)
            m = torch.amax(sc, dim=-1, keepdim=True)
            p = torch.where(valid, torch.exp(sc - m), 0.0)
            states.append((m, torch.sum(p, dim=-1, keepdim=True),
                           torch.sum(p[..., None] * vd[:, None], dim=-2)))
        if not states:
            continue
        m_star = states[0][0]
        for m, _, _ in states[1:]:
            m_star = torch.maximum(m_star, m)
        l = torch.zeros_like(m_star)
        acc = torch.zeros((kv, g, dh), device=dev)
        for m, lc, ac in states:
            w = torch.exp(m - m_star)
            l = lc * w + l
            acc = ac * w + acc
        out[i] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash attention (``repro/kernels/flash.py``)
# ---------------------------------------------------------------------------

def _visible(qpos, kpos, kend, causal: bool, window: int):
    """Mask of the keys a query sees: ``kpos < kend`` (the true key
    length, per row), ``qpos >= kpos`` when causal, and
    ``qpos - kpos < window`` when ``window > 0``.  qpos [bq, 1],
    kpos [1, bk], kend [B, 1, 1, 1, 1] -> [B, 1, 1, bq, bk]."""
    mask = kpos < kend
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_k: int = 512,
                        kv_len=None, q_offset: int = 0):
    """Causal / windowed / bidirectional GQA attention in the reference's
    layout: q [B, H, S, dh], k/v [B, KV, T, dh], H = KV * G; returns
    [B, H, S, dh] in q's dtype.

    The reference's schedule (``_flash_fwd_kernel``): query tiles of
    ``bq`` rows against kv tiles of ``bk`` positions in ascending order,
    kv tiles strictly above the causal diagonal skipped; per tile the
    scores scaled by dh**-0.5, masked to ``NEG_INF``, the running max,
    ``p = where(mask, exp(s - m_new), 0)``, ``l`` and ``acc`` rescaled
    by ``exp(m - m_new)``; the output is ``acc / max(l, 1e-30)``.

    ``bq = min(block_q, seq_bucket(S))`` and likewise ``bk``: wherever
    the reference accepts a shape (S and T multiples of its blocks) these
    are its tiles, and a length that is not a multiple is padded to one
    inside its bucket, so right-padding never changes the partition.
    Keys at positions >= ``kv_len`` (an int or [B]; default T) never
    enter the softmax, causal or not, so padded keys are masked even in
    bidirectional attention.  Query row r sits at position ``q_offset +
    r`` for the causal and window masks (a sequence chunk's queries).

    Dot products are elementwise products summed over one axis, never
    batched matmuls, so a row's bits do not depend on B.
    """
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    bq = min(block_q, seq_bucket(s))
    bk = min(block_k, seq_bucket(t))
    nq, nk = -(-s // bq), -(-t // bk)
    kend = torch.full((b,), t, dtype=torch.int64, device=dev) \
        if kv_len is None else torch.clamp(
            torch.as_tensor(kv_len, device=dev).reshape(-1).expand(b)
            .to(torch.int64), max=t)
    kend = kend.reshape(b, 1, 1, 1, 1)
    scale = dh ** -0.5
    qp = torch.nn.functional.pad(q.to(torch.float32),
                                 (0, 0, 0, nq * bq - s))
    kp = torch.nn.functional.pad(k.to(torch.float32),
                                 (0, 0, 0, nk * bk - t))
    vp = torch.nn.functional.pad(v.to(torch.float32),
                                 (0, 0, 0, nk * bk - t))
    qp = qp.reshape(b, kv, g, nq * bq, dh)
    kp = kp[:, :, None]                                # [B, KV, 1, Tp, dh]
    vp = vp[:, :, None]
    outs = []
    for i in range(nq):
        qb = qp[:, :, :, i * bq:(i + 1) * bq]           # [B, KV, G, bq, dh]
        qpos = (q_offset + i * bq + torch.arange(bq, device=dev))[:, None]
        m = torch.full((b, kv, g, bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, bq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, bq, dh), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            if causal and j * bk > q_offset + i * bq + bq - 1:
                continue            # fully above the diagonal: a no-op
            kb = kp[:, :, :, j * bk:(j + 1) * bk]        # [B, KV, 1, bk, dh]
            vb = vp[:, :, :, j * bk:(j + 1) * bk]
            kpos = (j * bk + torch.arange(bk, device=dev))[None, :]
            mask = _visible(qpos, kpos, kend, causal, window)
            sc = torch.sum(qb[:, :, :, :, None] * kb[:, :, :, None],
                           dim=-1) * scale                # [B,KV,G,bq,bk]
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(sc - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * corr + torch.sum(p[..., None] * vb[:, :, :, None],
                                         dim=-2)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=3)[:, :, :, :s]
    return out.reshape(b, h, s, dh).to(q.dtype)


def ref_attention(q, k, v, causal: bool, window: int, q_offset: int = 0):
    """The reference's oracle ``_ref_attention`` in the [B, H, S, dh]
    layout: masked scores, a full softmax, p @ V; differentiable, and what
    the flash kernel's backward recomputes through.  Batched matmuls, as
    the reference's einsums: its temporaries are [B, H, S, T], so the
    backward fits long training sequences (the gradient is held to a
    tolerance, not to bits).  Query row r sits at position ``q_offset +
    r`` for the masks."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    qr = q.to(torch.float32).reshape(b, kv, g, s, dh)
    kr = k.to(torch.float32)[:, :, None]               # [B, KV, 1, T, dh]
    vr = v.to(torch.float32)[:, :, None]
    sc = torch.matmul(qr, kr.transpose(-1, -2)) * dh ** -0.5  # [B,KV,G,S,T]
    qpos = q_offset + torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(t, device=dev)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    p = torch.softmax(torch.where(mask, sc, -torch.inf), dim=-1)
    out = torch.matmul(p, vr)                          # [B, KV, G, S, dh]
    return out.reshape(b, h, s, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# The flash kernel's error-compensated TF32 products (``csrc/flash_attn.cu``)
# ---------------------------------------------------------------------------

MMA_K = 8          # the depth of one tf32 tensor-core product (m64n64k8)
FLASH_TILE = 64    # the kernel's query rows per block and kv tile


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits: round f32 to 10 stored mantissa
    bits, ties away from zero (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """f32 x -> (hi, lo) TF32 values, hi = tf32(x), lo = tf32(x - hi):
    hi + lo equals x to ~2^-22 relative."""
    x = x.to(torch.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, acc=None,
                  exact_a: bool = False,
                  exact_b: bool = False) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as the kernel forms it on the tensor
    cores: per MMA_K-deep step, lo_a hi_b, then hi_a lo_b, then hi_a hi_b
    added into one f32 accumulator (``acc``, default zero); lo lo is
    dropped.  An operand that is exact in TF32 (``exact_*``: bf16 inputs)
    is not split, and the passes with its lo part are skipped.  Each
    step's products are exact in f32; their sum rounds in f32 here, where
    the tensor cores add at their own internal precision."""
    ah, al = (a.to(torch.float32), None) if exact_a else split_tf32(a)
    bh, bl = (b.to(torch.float32), None) if exact_b else split_tf32(b)
    k = a.shape[-1]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device) if acc is None else acc
    for k0 in range(0, k, MMA_K):
        ks = slice(k0, k0 + MMA_K)
        if al is not None:
            out = out + al[..., ks] @ bh[..., ks, :]
        if bl is not None:
            out = out + ah[..., ks] @ bl[..., ks, :]
        out = out + ah[..., ks] @ bh[..., ks, :]
    return out


def flash_split_emulation(q, k, v, *, causal: bool = True, window: int = 0,
                          kv_len=None, q_offset: int = 0):
    """The flash kernel's schedule and order of arithmetic, in plain torch
    (for the tests; no caller on a path).  Same layout and masks as
    :func:`flash_attention_ref`.

    Query tiles and kv tiles of FLASH_TILE, only kv tiles holding a key
    visible to some row of the query tile walked; per tile S =
    :func:`tf32x3_matmul` (q, k^T) * dh**-0.5, NEG_INF where masked, the
    reference's online softmax in f32 (m_new, p = exp(s - m_new) or 0,
    corr, l = l * corr + sum p), then acc = acc * corr + pv with pv =
    :func:`tf32x3_matmul` (p, v) formed fresh for the tile; the output is
    acc / max(l, 1e-30).  bf16 inputs are exact in TF32: one pass for
    q k^T, two for p v.
    """
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    exact = q.dtype == torch.bfloat16
    ft = FLASH_TILE
    kend = torch.full((b,), t, dtype=torch.int64, device=dev) \
        if kv_len is None else torch.clamp(
            torch.as_tensor(kv_len, device=dev).reshape(-1).expand(b)
            .to(torch.int64), min=0, max=t)
    kend_b = kend.reshape(b, 1, 1, 1, 1)
    nq, nk = -(-s // ft), -(-t // ft)
    qp = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, nq * ft - s))
    kp = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, nk * ft - t))
    vp = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, nk * ft - t))
    qp = qp.reshape(b, kv, g, nq * ft, dh)
    kp, vp = kp[:, :, None], vp[:, :, None]            # [B, KV, 1, Tp, dh]
    scale = dh ** -0.5
    outs = []
    for i in range(nq):
        q0 = i * ft
        qb = qp[:, :, :, q0:q0 + ft]
        qpos = (q_offset + q0 + torch.arange(ft, device=dev))[:, None]
        m = torch.full((b, kv, g, ft, 1), NEG_INF, device=dev)
        l = torch.zeros((b, kv, g, ft, 1), device=dev)
        acc = torch.zeros((b, kv, g, ft, dh), device=dev)
        # the tiles the kernel walks: as csrc/flash_attn.cu, per row of B
        q_last = min(q0 + ft, s) - 1 + q_offset
        hi = torch.clamp(kend, max=q_last + 1) if causal else kend
        lo = max(q0 + q_offset - window + 1, 0) if window > 0 else 0
        for j in range(lo // ft, nk):
            walk = (hi > lo) & (j * ft < hi)                         # [B]
            if not bool(walk.any()):
                continue
            kb = kp[:, :, :, j * ft:(j + 1) * ft]
            vb = vp[:, :, :, j * ft:(j + 1) * ft]
            kpos = (j * ft + torch.arange(ft, device=dev))[None, :]
            mask = _visible(qpos, kpos, kend_b, causal, window)
            sc = tf32x3_matmul(qb, kb.transpose(-1, -2), exact_a=exact,
                               exact_b=exact) * scale
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(sc - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
            pv = tf32x3_matmul(p, vb.expand(-1, -1, g, -1, -1),
                               exact_b=exact)
            acc_new = acc * corr + pv
            w = walk.reshape(b, 1, 1, 1, 1)
            m = torch.where(w, m_new, m)
            l = torch.where(w, l_new, l)
            acc = torch.where(w, acc_new, acc)
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=3)[:, :, :, :s]
    return out.reshape(b, h, s, dh).to(q.dtype)
