"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (and no JAX) run them with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Shapes cover what the reference accepts beyond the serving path: any G
dividing K (1, 64, 128, 256, and one group of K < 128 rows), odd N, and
int4 with K % 256 != 0; group_quantize takes both of its routes (the
vector route's grouped launch over many matrices, past one launch's
table, packed nibbles equal to pack_int4_ref; SIMT at G = 1 and odd N);
the qmm cases take both of its routes (the
tensor cores at ragged M, N and K tiles and groups ending inside a stage;
SIMT at G = 1 and odd N), each checked by its route's launch counter.
Codes and scales must be equal; matmuls agree at rtol = atol = 1e-4, the
tolerance of tests/test_kernels.py, and a row's bits are the same alone,
at M = 64 and at M = 256.  Decode
attention agrees with its plain version within 1e-5 x max|out| (f32 sums
in another order: the kernel's chunks combine in another order than the
plain version's sequential walk), at lengths on and beside its chunk
boundaries, under windows at T = 4096 and at cache lengths past the
shared-memory cap it once had (granite's heads at T = 32,768, qwen2's at
524,288), and is bitwise row-independent, padding-invisible and the same
on a second launch.  The row-independent GEMM takes any M (17, 32 and
128 rows each bitwise alone) and its grouped launch equals the separate
launches plus the bias add, bitwise.
Flash attention (tensor-core products) agrees at rtol = atol = 2e-5
(tests/test_flash.py's tolerance) in f32 and within one bf16 ulp in
bf16, at lengths around its 16-row MMA tile and 64-row block, bitwise
row-independent and padding-invisible; its gradient agrees with the
plain oracle's at 2e-4.  Shapes a kernel cannot take raise, with no
launch.  The compiled forward (one CUDA graph per bucket, smoke config)
returns the eager engine's bits at the same bucket, records its
launches per replay, serves the batched engine without a miss after
warm-up, and a forward that cannot be captured raises.  A mixed-bits
table (1-8 bits, packed where <= 4) is one group_quantize launch, and a
mixed plan's forward runs qmm and qmm_int4 together, against the same
engine on the CPU.  A decode step at pos = T writes at T - 1 with no
device assert, rows as they are alone; one speculative round from the
captured draft and verify steps equals the closures run eagerly (and a
fixed n_draft + 1 verify steps), and the speculative engine from graphs
equals the batch-1 oracle with no capture after warm-up; the decode
engine at 32 slots equals the batch-1 oracle.  Two engines with
different weights over one compile cache each replay their own graphs; a
one-agent fleet from graphs equals its batched engine bitwise; a decode
slot's snapshot resumes bitwise through the batch-1 graphs; a checkpoint
of card tensors round-trips onto the card.  ``row_gemm`` takes granite-
34b's K = 24,576 past 8 rows; a prefill, step, draft or verify capture
leaves its block bitwise as it was while saving only what its warm-up
writes; an MoE decode step (dispatch at 16 experts) replays its eager
bits from a graph.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import ref
from repro_torch.kernels.quantize import kv_quantize

# the module (the package's name ``qmm`` is the wrapper function)
tqmm = importlib.import_module("repro_torch.kernels.qmm")
tquant = importlib.import_module("repro_torch.kernels.quantize")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(seed, shape, dev):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to(dev)


@pytest.mark.parametrize("k,n,g,bits", [
    (896, 4864, 128, 8), (4864, 896, 128, 4), (256, 127, 64, 8),
    (512, 129, 256, 4), (96, 33, 96, 8), (192, 128, 1, 8), (130, 7, 1, 4),
])
def test_group_quantize_equals_plain(dev, k, n, g, bits):
    w = _normal(k + n, (k, n), dev)
    w[:g] = 0.0                                  # an all-zero group
    way = tquant.route(k, n, g)
    before = dict(tk.group_quantize.route_launches)
    codes, scales = tk.group_quantize(w, group_size=g, bits=bits)
    torch.cuda.synchronize()
    assert tk.group_quantize.route_launches[way] == before[way] + 1
    codes_p, scales_p = ref.group_quantize_ref(w, g, bits)
    assert torch.equal(codes, codes_p) and torch.equal(scales, scales_p)
    if bits <= 4 and k % 2 == 0:
        packed, scales = tk.group_quantize(w, group_size=g, bits=bits,
                                           pack=True)
        assert torch.equal(packed, ref.pack_int4_ref(codes_p))
        assert torch.equal(scales, scales_p)


# (k, n, g) on the vector route: the main path's shapes, a ragged column
# tile, every register-slot count (G / 8 = 2 .. 32), a one-group matrix
GROUPED = [(896, 896, 128), (896, 128, 128), (896, 4864, 128),
           (4864, 896, 128), (640, 132, 64), (64, 256, 16), (96, 36, 32),
           (512, 64, 256), (256, 1028, 128)]


@pytest.mark.parametrize("bits,pack", [(8, False), (4, False), (4, True),
                                       (2, True)])
def test_group_quantize_many_is_one_launch(dev, bits, pack):
    """The vector route quantizes many matrices in one launch, each equal
    to its own call and to the plain version (nibbles packed by the
    kernel equal to pack_int4_ref); SIMT matrices among them launch alone."""
    ws = [_normal(k * n + g, (k, n), dev) for k, n, g in GROUPED]
    ws[0][:128] = 0.0
    gs = [g for _, _, g in GROUPED]
    simt = _normal(7, (192, 127), dev)
    before = dict(tk.group_quantize.route_launches)
    got = tquant.group_quantize_many(ws + [simt], gs + [1],
                                     [bits] * (len(ws) + 1), pack=pack)
    torch.cuda.synchronize()
    after = tk.group_quantize.route_launches
    assert after["vector"] == before["vector"] + 1
    assert after["simt"] == before["simt"] + 1
    for (w, g), (codes, scales) in zip(zip(ws + [simt], gs + [1]), got):
        codes_p, scales_p = ref.group_quantize_ref(w, g, bits)
        if pack:
            codes_p = ref.pack_int4_ref(codes_p)
        assert torch.equal(codes, codes_p), (tuple(w.shape), g)
        assert torch.equal(scales, scales_p), (tuple(w.shape), g)
        alone = tk.group_quantize(w, group_size=g, bits=bits, pack=pack)
        assert torch.equal(alone[0], codes) and torch.equal(alone[1], scales)


def test_group_quantize_mixed_bits_table_is_one_launch(dev):
    """One vector launch over a table whose matrices differ in bits (a
    mixed-precision configure: 1-8 bits, packed where <= 4), each equal to
    the plain version; at 1 bit (levels 0) codes 0 and scales +inf, as the
    reference's container gives (ROADMAP C.7(c))."""
    bits = [2, 3, 5, 6, 7, 8, 1, 4, 3]
    ws = [_normal(k * n + g + 1, (k, n), dev) for k, n, g in GROUPED]
    gs = [g for _, _, g in GROUPED]
    before = dict(tk.group_quantize.route_launches)
    got = tquant.group_quantize_many(ws, gs, bits, pack=True)
    torch.cuda.synchronize()
    after = tk.group_quantize.route_launches
    assert after["vector"] == before["vector"] + 1
    assert after["simt"] == before["simt"]
    for w, g, b, (codes, scales) in zip(ws, gs, bits, got):
        codes_p, scales_p = ref.group_quantize_ref(w, g, b)
        if b <= 4:
            codes_p = ref.pack_int4_ref(codes_p)
        assert torch.equal(codes, codes_p), (tuple(w.shape), g, b)
        assert torch.equal(scales, scales_p), (tuple(w.shape), g, b)
        if b == 1:
            assert not codes.any() and torch.isposinf(scales).all()


def test_group_quantize_many_splits_past_the_table(dev):
    """More matrices than one launch's table: MAX_DESCS a launch."""
    n = tquant.MAX_DESCS + 6
    ws = [_normal(i, (128, 128), dev) for i in range(n)]
    before = tk.group_quantize.route_launches["vector"]
    got = tquant.group_quantize_many(ws, [128] * n, [8] * n)
    torch.cuda.synchronize()
    assert tk.group_quantize.route_launches["vector"] == before + 2
    for w, (codes, scales) in zip(ws, got):
        codes_p, scales_p = ref.group_quantize_ref(w, 128, 8)
        assert torch.equal(codes, codes_p) and torch.equal(scales, scales_p)


QMM_SHAPES = [  # (m, k, n, g)
    (1, 896, 4864, 128), (256, 4864, 896, 128), (7, 96, 127, 96),
    (130, 640, 129, 64), (33, 512, 256, 256), (5, 200, 31, 1),
    # the tensor-core route at ragged M, a ragged K tile (K % 64 != 0) and
    # groups that end inside a stage, a ragged N tile (N % 64 != 0)
    (1, 896, 896, 128), (63, 896, 128, 128), (65, 4864, 128, 128),
    (257, 896, 4864, 128), (64, 96, 64, 32), (9, 96, 48, 48),
    (3, 4864, 128, 128), (70, 160, 80, 16),
]


@pytest.mark.parametrize("m,k,n,g", QMM_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_equals_plain(dev, m, k, n, g, bits):
    # weights at the model's init scale, so outputs are O(1) as in serving
    x, w = _normal(m, (m, k), dev), _normal(k, (k, n), dev) * k ** -0.5
    codes, scales = ref.group_quantize_ref(w, g, bits)
    fn, plain = (tk.qmm, ref.qmm_ref) if bits == 8 else \
        (tk.qmm_int4, ref.qmm_int4_ref)
    if bits == 4:
        codes = ref.pack_int4_ref(codes)
    way = tqmm.route(k, n, g)
    before, routed = fn.launches, fn.route_launches[way]
    out = fn(x, codes, scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.route_launches[way] == routed + 1, way
    torch.testing.assert_close(out, plain(x, codes, scales), rtol=1e-4,
                               atol=1e-4)
    # row independence: each row alone is bitwise the batched row
    for i in {0, m // 2, m - 1}:
        assert torch.equal(fn(x[i:i + 1], codes, scales)[0], out[i])


@pytest.mark.parametrize("k,n", [(4864, 896), (896, 4864)])  # down, gate
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_rows_bitwise_across_m(dev, k, n, bits):
    """Every row's bits are the same alone, at the sequential engine's
    M = 64 and at the batched engine's M = 256."""
    x = _normal(7, (256, k), dev)
    codes, scales = ref.group_quantize_ref(
        _normal(k + n, (k, n), dev) * k ** -0.5, 128, bits)
    fn = tk.qmm if bits == 8 else tk.qmm_int4
    if bits == 4:
        codes = ref.pack_int4_ref(codes)
    assert tqmm.route(k, n, 128) == "wgmma"
    full = fn(x, codes, scales)
    for i in range(4):
        assert torch.equal(fn(x[64 * i:64 * (i + 1)], codes, scales),
                           full[64 * i:64 * (i + 1)]), f"M=64 tile {i}"
    for i in range(256):
        assert torch.equal(fn(x[i:i + 1], codes, scales)[0], full[i]), \
            f"row {i} alone"


def test_bf16_activation_keeps_its_dtype(dev):
    x = _normal(1, (4, 256), dev).to(torch.bfloat16)
    codes, scales = ref.group_quantize_ref(_normal(2, (256, 128), dev), 128)
    out = tk.qmm(x, codes, scales)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.qmm_ref(x, codes, scales),
                               rtol=2e-2, atol=2e-2)


def _decode_case(dev, b, t, b_kv, seed, lens, h=14, kv=2, dh=64):
    q = _normal(seed, (b, 1, h, dh), dev)
    k = _normal(seed + 1, (b, t, kv, dh), dev)
    v = _normal(seed + 2, (b, t, kv, dh), dev)
    if b_kv < 16:
        (kc, ks), (vc, vs) = kv_quantize(k, b_kv), kv_quantize(v, b_kv)
    else:
        kc, vc = k, v
        ks = vs = torch.ones(k.shape[:-1], device=dev)
    return q, kc, vc, ks, vs, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("t,window", [(128, 0), (1024, 0), (1024, 100),
                                      (4096, 0)])
def test_decode_attention_equals_plain(dev, b_kv, t, window):
    lens = [0, 1, t // 2 + 3, t]
    args = _decode_case(dev, 4, t, b_kv, seed=t + b_kv, lens=lens)
    before = tk.quantized_decode_attention.launches
    out = tk.quantized_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 1
    want = ref.quantized_decode_attention_ref(*args, window=window)
    tol = 1e-5 * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()                  # cache_len 0
    # row independence: each row alone is bitwise the batched row
    for i in range(4):
        alone = tk.quantized_decode_attention(
            *(a[i:i + 1] for a in args), window=window)
        assert torch.equal(alone[0], out[i]), f"row {i}"


@pytest.mark.parametrize("b_kv", [4, 16])
def test_decode_attention_padding_is_invisible(dev, b_kv):
    q, kc, vc, ks, vs, lens = _decode_case(dev, 2, 1024, b_kv, seed=3,
                                           lens=[700, 1024])
    out = tk.quantized_decode_attention(q, kc, vc, ks, vs, lens)
    pad = (0, 0, 0, 0, 0, 1024)
    grown = tk.quantized_decode_attention(
        q, torch.nn.functional.pad(kc, pad), torch.nn.functional.pad(vc, pad),
        torch.nn.functional.pad(ks, pad[2:]),
        torch.nn.functional.pad(vs, pad[2:]), lens)
    assert torch.equal(out, grown)


from repro_torch.kernels import decode_attn as tdecode  # noqa: E402

C = tdecode.CHUNK


def _decode_close(out, want):
    assert float((out - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("t", [256, 1024])
def test_decode_attention_at_chunk_edges(dev, b_kv, t):
    """Lengths on and beside the chunk boundaries, each row alone bitwise
    the batched row, and T -> 2T with the lengths fixed bitwise."""
    lens = [0, 1, C - 1, C, C + 1, t]
    args = _decode_case(dev, len(lens), t, b_kv, seed=t + 7 * b_kv,
                        lens=lens)
    before = tk.quantized_decode_attention.launches
    out = tk.quantized_decode_attention(*args)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 1
    _decode_close(out, ref.quantized_decode_attention_ref(*args))
    assert (out[0] == 0).all()                  # cache_len 0
    for i in range(len(lens)):
        alone = tk.quantized_decode_attention(*(a[i:i + 1] for a in args))
        assert torch.equal(alone[0], out[i]), f"row {i} (len {lens[i]})"
    q, kc, vc, ks, vs, ln = args
    pad = (0, 0, 0, 0, 0, t)
    grown = tk.quantized_decode_attention(
        q, torch.nn.functional.pad(kc, pad), torch.nn.functional.pad(vc, pad),
        torch.nn.functional.pad(ks, pad[2:]),
        torch.nn.functional.pad(vs, pad[2:]), ln)
    assert torch.equal(grown, out)


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("window", [100, 1000])
def test_decode_attention_long_cache_windowed(dev, b_kv, window):
    t = 4096
    lens = [0, 99, 1000, 2049, t]
    args = _decode_case(dev, len(lens), t, b_kv, seed=window + b_kv,
                        lens=lens)
    out = tk.quantized_decode_attention(*args, window=window)
    _decode_close(out, ref.quantized_decode_attention_ref(*args,
                                                          window=window))
    for i in range(len(lens)):
        alone = tk.quantized_decode_attention(*(a[i:i + 1] for a in args),
                                              window=window)
        assert torch.equal(alone[0], out[i]), f"row {i}"
    q, kc, vc, ks, vs, ln = args
    pad = (0, 0, 0, 0, 0, t)
    grown = tk.quantized_decode_attention(
        q, torch.nn.functional.pad(kc, pad), torch.nn.functional.pad(vc, pad),
        torch.nn.functional.pad(ks, pad[2:]),
        torch.nn.functional.pad(vs, pad[2:]), ln, window=window)
    assert torch.equal(grown, out)


@pytest.mark.parametrize("b_kv,dh", [(8, 24), (16, 6)])
def test_decode_attention_rows_off_16_bytes(dev, b_kv, dh):
    """Cache rows that are not whole 16-byte loads (int8 dh = 24, f32
    dh = 6) take the kernel's element-wise staging."""
    lens = [0, C + 3, 200]
    args = _decode_case(dev, len(lens), 256, b_kv, seed=dh, lens=lens, h=4,
                        kv=2, dh=dh)
    before = tk.quantized_decode_attention.launches
    out = tk.quantized_decode_attention(*args, window=150)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 1
    _decode_close(out, ref.quantized_decode_attention_ref(*args,
                                                          window=150))
    for i in range(len(lens)):
        alone = tk.quantized_decode_attention(*(a[i:i + 1] for a in args),
                                              window=150)
        assert torch.equal(alone[0], out[i]), f"row {i}"


def test_decode_attention_twice_is_bitwise(dev):
    """The arrival counters are left zero: a second launch on the same
    inputs combines the same chunks and gives the same bits."""
    args = _decode_case(dev, 4, 1024, 8, seed=21, lens=[1024, 800, 532, 300])
    before = tk.quantized_decode_attention.launches
    first = tk.quantized_decode_attention(*args)
    second = tk.quantized_decode_attention(*args)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 2
    assert torch.equal(first, second)


def _decode_long(dev, b, t, h, kv, dh, lens, seed):
    """A long int8 cache made on the card (seeded), at b_kv = 8."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
    k = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    (kc, ks) = kv_quantize(k, 8)
    del k
    v = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    (vc, vs) = kv_quantize(v, 8)
    del v
    return q, kc, vc, ks, vs, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


@pytest.mark.parametrize("b,t,h,kv,dh,lens", [
    (2, 32768, 48, 1, 128, [32768, 20001]),    # granite-34b's heads
    (1, 524288, 14, 2, 64, [524288 - 77])])    # qwen2-0.5b at LONG_500K
def test_decode_attention_past_the_old_cap(dev, b, t, h, kv, dh, lens):
    """Cache lengths the shared-memory combine could not take (T above
    21,632 at G = 48, dh = 128; above ~224K at qwen2's heads) run within
    1e-5 x max|out| of the plain version, rows alone bitwise."""
    assert tdecode.smem_bytes(h // kv, dh, t) <= tdecode.MAX_SMEM_BYTES
    args = _decode_long(dev, b, t, h, kv, dh, lens, seed=t)
    out = tk.quantized_decode_attention(*args)
    want = ref.quantized_decode_attention_ref(*args, block_t=4096)
    torch.cuda.synchronize()
    _decode_close(out, want)
    if b > 1:
        for i in range(b):
            alone = tk.quantized_decode_attention(*(a[i:i + 1]
                                                    for a in args))
            assert torch.equal(alone[0], out[i]), f"row {i}"


def test_decode_attention_raises_where_the_kernel_cannot_run(dev):
    """A head size whose chunk does not fit in shared memory raises on the
    card, with no launch and no plain fallback."""
    args = _decode_case(dev, 1, 64, 8, seed=5, lens=[64], h=2, kv=1,
                        dh=1024)
    assert tdecode.smem_bytes(2, 1024, 64) > tdecode.MAX_SMEM_BYTES
    before = tk.quantized_decode_attention.launches
    with pytest.raises(ValueError, match="shared"):
        tk.quantized_decode_attention(*args)
    assert tk.quantized_decode_attention.launches == before


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain at qwen2-0.5b's heads (H = 14 over
# KV = 2, dh = 64), f32 within rtol = atol = 2e-5 (tests/test_flash.py's
# tolerance); bf16 outputs within one bf16 rounding step of the plain one
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash as tflash  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402


def _flash_case(dev, b, s, h=14, kv=2, dh=64, dtype=torch.float32, seed=0):
    q = _normal(seed, (b, s, h, dh), dev).to(dtype)
    k = _normal(seed + 1, (b, s, kv, dh), dev).to(dtype)
    v = _normal(seed + 2, (b, s, kv, dh), dev).to(dtype)
    # the model's [B, S, H, dh] activations, seen as [B, H, S, dh]
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


FLASH_CASES = [  # (b, s, causal, window, dh, kv_len)
    (4, 64, True, 0, 64, None), (1, 100, True, 0, 64, None),
    (2, 512, True, 0, 64, None), (1, 1024, True, 0, 64, None),
    (2, 300, True, 128, 64, None), (2, 200, False, 0, 64, [200, 77]),
    (1, 384, True, 0, 128, None), (2, 130, False, 0, 32, None),
]


@pytest.mark.parametrize("b,s,causal,window,dh,kv_len", FLASH_CASES)
def test_flash_equals_plain(dev, b, s, causal, window, dh, kv_len):
    q, k, v = _flash_case(dev, b, s, dh=dh, seed=s + dh)
    lens = None if kv_len is None else torch.tensor(kv_len, device=dev)
    before = tflash.flash_attention_fwd.launches
    out = tflash.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     kv_len=lens)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    assert out.stride() == q.stride()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=lens)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    for i in range(b):           # each row alone is bitwise the batched row
        alone = tflash.flash_attention_fwd(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
            window=window, kv_len=None if lens is None else lens[i:i + 1])
        assert torch.equal(alone[0], out[i]), f"row {i}"


def test_flash_bf16_within_one_rounding(dev):
    # both round f32 results that agree to ~1e-6 into bf16, so they may
    # land on neighbouring bf16 values: one ulp, at most 2^-7 relative
    q, k, v = _flash_case(dev, 2, 256, dtype=torch.bfloat16, seed=5)
    out = tflash.flash_attention_fwd(q, k, v)
    assert out.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v).float()
    d = (out.float() - want).abs()
    assert bool((d <= want.abs() * 2.0 ** -7 + 2e-5).all())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padding_is_invisible(dev, causal):
    q, k, v = _flash_case(dev, 1, 128, seed=9)
    s = 100
    lens = None if causal else torch.tensor([s], device=dev)
    short = tflash.flash_attention_fwd(q[:, :, :s], k[:, :, :s], v[:, :, :s],
                                       causal=causal)
    padded = tflash.flash_attention_fwd(q, k, v, causal=causal, kv_len=lens)
    assert torch.equal(padded[:, :, :s], short)


def test_flash_grad_equals_plain(dev):
    q, k, v = (x.contiguous().requires_grad_(True)
               for x in _flash_case(dev, 1, 128, h=4, kv=2, dh=32, seed=11))
    g = tflash.flash_attention(q, k, v, True, 0)
    grads = torch.autograd.grad((g ** 2).sum(), (q, k, v))
    r = ref.ref_attention(q, k, v, True, 0)
    want = torch.autograd.grad((r ** 2).sum(), (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_blockwise_attention_dispatches_to_the_kernel(dev):
    q, k, v = (x.transpose(1, 2) for x in _flash_case(dev, 2, 100, seed=13))
    before = tflash.flash_attention_fwd.launches
    out = tL.blockwise_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    want = tL.blockwise_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-5)


def test_blockwise_attention_raises_where_the_kernel_cannot_run(dev):
    """A head size the kernel does not take raises on the card: the model's
    call site never falls back to a plain attention there."""
    q, k, v = (x.transpose(1, 2)
               for x in _flash_case(dev, 1, 64, h=2, kv=1, dh=160, seed=14))
    before = tflash.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim"):
        tL.blockwise_attention(q, k, v, causal=True)
    assert tflash.flash_attention_fwd.launches == before


def test_flash_raises_where_the_kernel_cannot_run(dev):
    q, k, v = _flash_case(dev, 1, 64, h=2, kv=1, dh=160, seed=15)
    before = tflash.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_fwd(*(x[..., :64].half() for x in (q, k, v)))
    assert tflash.flash_attention_fwd.launches == before


def test_flash_f32_rows_off_16_bytes(dev):
    """dh = 30: f32 rows that are not whole 16-byte copies take the
    kernel's plain-load staging, with the same products."""
    q, k, v = _flash_case(dev, 2, 100, h=4, kv=2, dh=30, seed=16)
    assert not tflash._copies_16(q, k, v)
    out = tflash.flash_attention_fwd(q, k, v, window=40)
    torch.testing.assert_close(
        out, ref.flash_attention_ref(q, k, v, window=40), rtol=2e-5,
        atol=2e-5)
    for i in range(2):
        alone = tflash.flash_attention_fwd(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], window=40)
        assert torch.equal(alone[0], out[i]), f"row {i}"


@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 65, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_at_tile_edges(dev, s, dtype, dh):
    """Lengths on and beside the MMA's 16 rows and the 64-row tile, f32
    and bf16, causal, windowed and bidirectional with ragged kv_len: within
    the tolerance, each row alone bitwise the batched row, and the
    sequence right-padded to 128 bitwise on its real positions."""
    q, k, v = _flash_case(dev, 2, 128, dh=dh, dtype=dtype, seed=s + dh)
    lens = torch.tensor([s, max(s // 2, 1)], device=dev)
    for causal, window, kv_len in ((True, 0, None), (True, 24, None),
                                   (False, 0, lens)):
        short = [x[:, :, :s] for x in (q, k, v)]
        out = tflash.flash_attention_fwd(*short, causal=causal,
                                         window=window, kv_len=kv_len)
        want = ref.flash_attention_ref(*short, causal=causal, window=window,
                                       kv_len=kv_len)
        what = f"S={s} causal={causal} window={window} kv_len={kv_len}"
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5,
                                       msg=what)
        else:
            d = (out.float() - want.float()).abs()
            assert bool((d <= want.float().abs() * 2.0 ** -7
                         + 2e-5).all()), what
        for i in range(2):
            alone = tflash.flash_attention_fwd(
                *(x[i:i + 1] for x in short), causal=causal, window=window,
                kv_len=None if kv_len is None else kv_len[i:i + 1])
            assert torch.equal(alone[0], out[i]), f"{what}: row {i}"
        padded = tflash.flash_attention_fwd(
            q, k, v, causal=causal, window=window,
            kv_len=kv_len if kv_len is not None
            else (None if causal else s))
        assert torch.equal(padded[:, :, :s], out), f"{what}: padding"


# ---------------------------------------------------------------------------
# the compiled forward: one CUDA graph per (plan, bucket)
# ---------------------------------------------------------------------------

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.cost_model import SystemParams  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.runtime import (BatchedCoInferenceEngine,  # noqa: E402
                                 CoInferenceEngine, QosClass,
                                 greedy_decode_reference)

SMOKE_SYSP = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)


@pytest.fixture(scope="module")
def smoke_lm():
    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _ragged(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks


@pytest.mark.parametrize("path,target,b_emb", [
    ("kernel", 8, 8), ("kernel", 4, 8), ("kernel", 8, 4), ("fake", 6, 8)])
def test_compiled_forward_equals_eager_at_the_bucket(dev, smoke_lm, path,
                                                     target, b_emb):
    """A replayed graph returns the eager engine's bits for the same
    bucket-padded batch, and its capture records every kernel launch of
    one forward (counted per replay, not on the wrappers)."""
    model, params = smoke_lm
    lens = [6, 13, 16, 23]
    toks = _ragged(model.cfg.vocab_size, lens)
    eager = CoInferenceEngine(model, params, SMOKE_SYSP, path=path,
                              b_emb=b_emb, device=dev)
    comp = CoInferenceEngine(model, params, SMOKE_SYSP, path=path,
                             b_emb=b_emb, compiled=True, device=dev)
    eager.configure(target)
    comp.configure(target)
    bp, sp = comp.bucket_shape(*toks.shape)
    padded = np.zeros((bp, sp), np.int32)
    padded[:4, :23] = toks
    want, _ = eager.serve_batch({"tokens": padded},
                                lengths=lens + [0] * (bp - 4))
    before = tk.launch_counts()
    for _ in range(2):                           # replays reuse the graph
        got, _ = comp.serve_batch({"tokens": toks}, lengths=lens)
        torch.cuda.synchronize()
        for i, n in enumerate(lens):
            assert torch.equal(got[i, :n], want[i, :n]), (i, n)
    (cf,) = comp.compile_cache._exe.values()
    assert cf.graph is not None and cf.replays == 2
    assert cf.launches.get("flash_attention_fwd") == model.cfg.n_layers
    if path == "kernel":
        name = "qmm_int4" if target <= 4 else "qmm"
        assert cf.launches[name] == 7 * model.cfg.split_layer
    # the warm-up run before the capture launched for real, once
    assert tk.launch_counts()["flash_attention_fwd"] \
        == before["flash_attention_fwd"] + model.cfg.n_layers


def test_batched_compiled_on_card(dev, smoke_lm):
    """Warm-up captures every (class, bucket); serving then never misses,
    each response equals the eager engine at the same bucket, and each
    request served alone (unpadded, eager) agrees within 1e-2 of the
    logits' scale."""
    model, params = smoke_lm
    classes = [QosClass("realtime", t0=1.10, e0=0.9),
               QosClass("batch", t0=2.50, e0=4.0)]
    eng = BatchedCoInferenceEngine(model, params, SMOKE_SYSP,
                                   classes=classes, max_batch=4,
                                   path="kernel", compiled=True, device=dev)
    assert eng.warmup(64) == len(eng.engine.compile_cache) >= 3
    misses = eng.engine.compile_cache.misses
    eager = CoInferenceEngine(model, params, SMOKE_SYSP, path="kernel",
                              cache_weights=True, device=dev)
    rng = np.random.default_rng(5)
    sent = {}
    for i in range(10):
        t = rng.integers(0, model.cfg.vocab_size,
                         size=int(rng.integers(5, 64)))
        sent[eng.submit(t, classes[i % 2].name)] = (t, classes[i % 2].name)
    batches = []
    while eng.pending():
        batches.append(eng.step())
    assert eng.engine.compile_cache.misses == misses
    for rs in batches:
        qos = sent[rs[0].request_id][1]
        sol = eng.solution_for(qos)
        eager.configure(sol.b_hat, sol.f, sol.f_server)
        s_max = max(len(sent[r.request_id][0]) for r in rs)
        bp, sp = eng.engine.bucket_shape(len(rs), s_max)
        padded = np.zeros((bp, sp), np.int32)
        lens = [0] * bp
        for i, r in enumerate(rs):
            t = sent[r.request_id][0]
            padded[i, :t.size] = t
            lens[i] = t.size
        want, _ = eager.serve_batch({"tokens": padded}, lengths=lens)
        for i, r in enumerate(rs):
            assert torch.equal(r.logits, want[i, :lens[i]])
            alone, _ = eager.serve_batch({"tokens": padded[i:i + 1,
                                                           :lens[i]]})
            # the server's cuBLAS GEMMs pick kernels by M, and a ~1e-6
            # difference at the b_emb = 8 uplink's rounding edge moves an
            # element a whole step: chip_smoke.py's E2E_TOL
            scale = float(alone[0].abs().max())
            assert float((r.logits - alone[0]).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("bits", [(5, 3), (2, 7), (12, 4)])
def test_mixed_plan_forward_kernels_vs_plain(dev, smoke_lm, bits):
    """A two-layer mixed plan served through qmm and qmm_int4 in one
    forward (a > 8-bit layer keeps fake-quantized matrices) against the
    same engine on the CPU, where every wrapper runs its plain version:
    the boundary activation within 1e-4 of its scale, the logits within
    1e-2 of theirs (the b_emb = 8 uplink's rounding edge)."""
    import dataclasses
    from repro_torch.core.quantization import QuantPlan
    model, params = smoke_lm
    model = DecoderLM(dataclasses.replace(model.cfg, split_layer=2))
    plan = QuantPlan.from_layer_bits(bits)
    toks = _ragged(model.cfg.vocab_size, [16, 16])
    outs = {}
    for d in (dev, torch.device("cpu")):
        eng = CoInferenceEngine(model, params, SMOKE_SYSP, path="kernel",
                                device=d)
        tk.reset_launch_counts()
        eng.configure(plan)
        assert eng.agent_path == "kernel-mixed[%d/%d]" % bits
        emb, _ = eng.agent_stage({"tokens": toks})
        logits, stats = eng.serve_batch({"tokens": toks})
        assert stats.plan_bits == bits
        outs[d.type] = (emb.cpu(), logits.cpu(), tk.launch_counts(),
                        dict(tk.group_quantize.route_launches))
    (emb, logits, counts, gq), (emb_p, logits_p, plain, _) = \
        outs["cuda"], outs["cpu"]
    # one vector launch for the configure (d_ff's K = 160 takes G = 1:
    # those matrices go SIMT, one launch each)
    assert gq["vector"] == 1
    assert counts["qmm"] == 2 * 7 * sum(4 < b <= 8 for b in bits)
    assert counts["qmm_int4"] == 2 * 7 * sum(b <= 4 for b in bits)
    assert plain["qmm"] == plain["qmm_int4"] == 0
    scale = float(emb_p.abs().max())
    assert float((emb - emb_p).abs().max()) <= 1e-4 * scale
    assert torch.isfinite(logits).all()
    assert float((logits - logits_p).abs().max()) <= \
        1e-2 * float(logits_p.abs().max())


def test_capture_failure_raises(dev, smoke_lm):
    """A forward that reads a value back to the host cannot be captured:
    the engine raises and does not serve eagerly instead."""
    model, params = smoke_lm

    class SyncLM(DecoderLM):
        def attend(self, q, k, v):
            float(q.abs().max())                # a device-to-host read
            return super().attend(q, k, v)

    eng = CoInferenceEngine(SyncLM(model.cfg), params, SMOKE_SYSP,
                            path="kernel", compiled=True, device=dev)
    with pytest.raises(RuntimeError):
        eng.serve_batch({"tokens": _ragged(model.cfg.vocab_size, [8])})
    assert len(eng.compile_cache) == 0


# ---------------------------------------------------------------------------
# the row-independent GEMM and the captured decode engine
# ---------------------------------------------------------------------------

trg = importlib.import_module("repro_torch.kernels.row_gemm")

# (K, N, w layout) of the decode step's products at qwen2-0.5b's full
# width: wq/wo, wk/wv, gate/up, down, and the tied head (tok.T)
ROW_GEMM_SHAPES = [(896, 896, "kn"), (896, 128, "kn"), (896, 4864, "kn"),
                   (4864, 896, "kn"), (896, 151936, "nk")]


def _row_gemm_w(k, n, layout, dev, seed=0):
    if layout == "kn":
        return _normal(seed, (k, n), dev)
    return _normal(seed, (n, k), dev).T          # the transposed view


@pytest.mark.parametrize("k,n,layout", ROW_GEMM_SHAPES)
def test_row_gemm_equals_plain_rows_alone(dev, k, n, layout):
    """Within 1e-5 x max|y| of the plain per-row products (f32 sums in
    another order), every row bitwise the row computed alone at M = 1, 3,
    4 and 16, one launch per call, a second launch bitwise the first."""
    w = _row_gemm_w(k, n, layout, dev)
    x = _normal(1, (16, k), dev)
    for m in (1, 3, 4, 16):
        before = tk.row_gemm.launches
        y = tk.row_gemm(x[:m], w)
        torch.cuda.synchronize()
        assert tk.row_gemm.launches == before + 1
        want = ref.row_gemm_ref(x[:m], w)
        assert float((y - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        for i in range(m):
            assert torch.equal(y[i], tk.row_gemm(x[i:i + 1], w)[0])
        assert torch.equal(y, tk.row_gemm(x[:m], w))


def test_row_gemm_in_a_graph(dev):
    """Captured with both routes (the split-K combine included), a replay
    returns the eager launch's bits."""
    ws = [_row_gemm_w(4864, 896, "kn", dev), _row_gemm_w(896, 1000, "nk",
                                                         dev)]
    x = torch.zeros((4, 4864), device=dev)
    x2 = torch.zeros((4, 896), device=dev)
    run = lambda: (tk.row_gemm(x, ws[0]), tk.row_gemm(x2, ws[1]))  # noqa
    from repro_torch.runtime.fastpath import CapturedCall
    call = CapturedCall(run, dev)
    assert call.launches == {"row_gemm": 2}
    x.copy_(_normal(3, (4, 4864), dev))
    x2.copy_(_normal(4, (4, 896), dev))
    got = [t.clone() for t in call()]
    for g, w, xi in zip(got, ws, (x, x2)):
        assert torch.equal(g, tk.row_gemm(xi, w))


@pytest.mark.parametrize("k,n,layout", ROW_GEMM_SHAPES)
def test_row_gemm_any_m(dev, k, n, layout):
    """M past one 16-row slice (17, 32, 128; once the M = 17 case that
    raised): one launch, within 1e-5 x max|y| of the plain version, every
    row bitwise the row computed alone."""
    w = _row_gemm_w(k, n, layout, dev)
    x = _normal(2, (128, k), dev)
    for m in (17, 32, 128):
        before = tk.row_gemm.launches
        y = tk.row_gemm(x[:m], w)
        torch.cuda.synchronize()
        assert tk.row_gemm.launches == before + 1
        want = ref.row_gemm_ref(x[:m], w)
        assert float((y - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        for i in range(m):
            assert torch.equal(y[i], tk.row_gemm(x[i:i + 1], w)[0]), \
                f"M={m} row {i}"


def test_row_gemm_at_granites_down_projection(dev):
    """K = 24,576 (granite-34b's non-gated MLP, 24576 -> 6144), whose
    block did not fit the card's shared memory past 8 rows before its ring
    was fitted to the chunk: at M = 9, 16 and 17 one launch, within 1e-5 x
    max|y| of the plain version, sampled rows bitwise alone."""
    w = _row_gemm_w(24576, 6144, "kn", dev) * 24576 ** -0.5
    x = _normal(5, (17, 24576), dev)
    for m in (9, 16, 17):
        before = tk.row_gemm.launches
        y = tk.row_gemm(x[:m], w)
        torch.cuda.synchronize()
        assert tk.row_gemm.launches == before + 1
        want = ref.row_gemm_ref(x[:m], w)
        assert float((y - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        for i in (0, m // 2, m - 1):
            assert torch.equal(y[i], tk.row_gemm(x[i:i + 1], w)[0]), \
                f"M={m} row {i}"


@pytest.mark.parametrize("k,ns,bias", [
    (896, (896, 128, 128), True), (896, (4864, 4864), False),
    (2560, (2560, 2560, 2560), False), (2560, (6912, 6912), False),
    (64, (32, 8, 8), True)])
def test_row_gemm_grouped_equals_separate(dev, k, ns, bias):
    """q | k | v (with their biases) and gate | up in one launch: each
    output bitwise its own launch followed by the bias add, at M = 1, 4,
    17; within 1e-5 x max|y| of the plain version."""
    ws = [_normal(30 + i, (k, n), dev) for i, n in enumerate(ns)]
    bs = [_normal(40 + i, (n,), dev) for i, n in enumerate(ns)] \
        if bias else None
    x = _normal(3, (17, k), dev)
    for m in (1, 4, 17):
        before = tk.row_gemm.launches
        got = trg.row_gemm_group(x[:m], ws, bs)
        torch.cuda.synchronize()
        assert tk.row_gemm.launches == before + 1
        want = ref.row_gemm_group_ref(x[:m], ws, bs or [None] * len(ws))
        for i, (g, w, wnt) in enumerate(zip(got, ws, want)):
            alone = tk.row_gemm(x[:m], w)
            assert torch.equal(g, alone + bs[i] if bias else alone)
            assert float((g - wnt).abs().max()) <= \
                1e-5 * float(wnt.abs().max())


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_decode_norms_rows_bitwise_past_4_rows(dev, norm):
    """The norms at 128 rows, as the decode step runs them: every row
    bitwise the row alone (``torch.mean``'s reduction changes its split of
    a row with the row count on the card; ``F.rms_norm`` and
    ``F.layer_norm`` do not), within 1e-5 of the CPU's."""
    from types import SimpleNamespace
    cfg = SimpleNamespace(norm=norm)
    x = _normal(5, (128, 1, 896), dev)
    p = {"scale": _normal(6, (896,), dev), "bias": _normal(7, (896,), dev)}
    got = tL.apply_norm(cfg, x, p)
    torch.testing.assert_close(
        got.cpu(), tL.apply_norm(cfg, x.cpu(),
                                 {n: a.cpu() for n, a in p.items()}),
        rtol=1e-5, atol=1e-5)
    for i in range(128):
        assert torch.equal(tL.apply_norm(cfg, x[i:i + 1], p)[0],
                           got[i]), f"row {i}"


def test_rms_norm_op_keeps_the_cards_bits(dev):
    """``layers.rmsnorm`` on the card (the op ``repro_norm::rms_norm``,
    one op each way for the accountant) is bitwise ``F.rms_norm`` and its
    autograd: y, dx and the gain's gradient."""
    import torch.nn.functional as F
    x = _normal(8, (1024, 896), dev)
    w = _normal(9, (896,), dev)
    g = _normal(10, (1024, 896), dev)
    a = [t.clone().requires_grad_(True) for t in (x, w)]
    b = [t.clone().requires_grad_(True) for t in (x, w)]
    ya = tL.rmsnorm(*a)
    yb = F.rms_norm(b[0], (896,), b[1], 1e-6)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(ya, yb)
    assert torch.equal(a[0].grad, b[0].grad)
    assert torch.equal(a[1].grad, b[1].grad)


def test_row_gemm_raises_where_the_kernel_cannot_run(dev):
    x = _normal(0, (17, 64), dev)
    w = _normal(1, (64, 32), dev)
    before = tk.row_gemm.launches
    for bad in (lambda: trg.row_gemm_group(x, [w.T.contiguous().T] * 2),
                lambda: trg.row_gemm_group(x, [w, w.T.contiguous().T]),
                lambda: tk.row_gemm(x[:4].bfloat16(), w.bfloat16()),
                lambda: tk.row_gemm(x[:4], w[:, :30]),        # N % 4
                lambda: tk.row_gemm(x[:4, :63],
                                    _normal(2, (30, 63), dev).T),  # K % 4
                lambda: tk.row_gemm(x[:4], w.cpu())):
        with pytest.raises(ValueError):
            bad()
    assert tk.row_gemm.launches == before


def _decode_engine(model, params, dev, b_kv=8, **kw):
    from repro_torch.runtime import DecodeEngine
    eng = DecodeEngine(model, params, SMOKE_SYSP,
                       classes=[QosClass("interactive", t0=3.5, e0=2.0)],
                       auto=False, max_batch=3, max_new_tokens=6,
                       device=dev, **kw)
    eng.set_operating_point("interactive", 8, b_kv)
    return eng


def _decode_traffic(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 21))).astype(
        np.int32), int(rng.integers(1, 7)), 0.05 * i) for i in range(n)]


def test_captured_decode_equals_eager(dev, smoke_lm):
    """The captured token step and prefill equal their closures run
    eagerly on a copy of the same slot block, bitwise (tokens, codes,
    scales, positions); a capture leaves the block it ran on as it was."""
    from repro_torch.runtime import decode_engine as de
    model, params = smoke_lm
    eng = _decode_engine(model, params, dev)
    w = eng.class_params("interactive")
    cache = eng.compile_cache
    cfg = model.cfg
    bufs = [de._SlotBuffers(cfg, 32, 3, 8, dev) for _ in range(2)]
    prefill = de._prefill_call(cache, model, 8, w, bufs[0], 16)
    assert prefill.graph is not None
    rng = np.random.default_rng(0)
    for slot, p_len in ((0, 9), (2, 14)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p_len] = rng.integers(0, cfg.vocab_size, p_len)
        io = bufs[1].prefill_io(16)
        eager = lambda: de._prefill_slot(model, 8, w, bufs[1], io)  # noqa
        a = de._run_prefill(prefill, bufs[0].prefill_io(16), padded, p_len,
                            slot)
        b = de._run_prefill(eager, io, padded, p_len, slot)
        assert a == b
    # captured with two live rows: its warm-up step is undone
    before = [t.clone() for t in bufs[0].written()]
    step = de._step_call(cache, model, 8, w, bufs[0])
    for t, b in zip(bufs[0].written(), before):
        assert torch.equal(t, b)
    # q | k | v, wo, gate | up and down a layer, and the head
    assert step.launches["row_gemm"] == 4 * cfg.n_layers + 1
    assert step.launches["quantized_decode_attention"] == cfg.n_layers
    live = np.asarray([1, 0, 1], np.int32)
    blk_a, n_a = de._decode_chunk(step, bufs[0].step_io, live, 5)
    blk_b, n_b = de._decode_chunk(
        lambda: de._decode_step(model, 8, w, bufs[1], bufs[1].step_io),
        bufs[1].step_io, live, 5)
    torch.cuda.synchronize()
    assert n_a == n_b == 5 and torch.equal(blk_a, blk_b)
    for ta, tb in zip(bufs[0].written(), bufs[1].written()):
        assert torch.equal(ta, tb)


def test_capture_leaves_the_block_bitwise(dev, smoke_lm):
    """A prefill, token-step, draft-step and verify-step capture on a
    block with live rows (one at pos = T) leaves every buffer the block's
    graphs write bitwise as it was, while saving only the entries its
    warm-up run writes (ROADMAP C.10), not a copy of the block."""
    from repro_torch.runtime import decode_engine as de
    model, params = smoke_lm
    eng = _decode_engine(model, params, dev)
    w = eng.class_params("interactive")
    cache = eng.compile_cache
    buf = de._SlotBuffers(model.cfg, 32, 3, 8, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for c in (buf.k_codes, buf.v_codes):
        c.random_(-127, 128, generator=g)
    buf.pos.copy_(torch.tensor([5, 32, 17], dtype=torch.int32))
    io = buf.spec_io()
    io.act.copy_(torch.tensor([True, False, True]))
    pio = buf.prefill_io(16)
    pio.slot.fill_(1)
    pio.last.fill_(9)
    block = sum(t.numel() * t.element_size() for t in buf.canonical()[:4])
    assert de._save_entries(buf, buf.canonical()[:4], buf.pos).nbytes \
        < block / 8
    before = [t.clone() for t in buf.written()]
    for make in (lambda: de._prefill_call(cache, model, 8, w, buf, 16),
                 lambda: de._step_call(cache, model, 8, w, buf),
                 lambda: de._spec_draft_call(cache, model, 8, w, buf),
                 lambda: de._spec_verify_call(cache, model, 8, w, buf)):
        assert make().graph is not None
        torch.cuda.synchronize()
        for t, b in zip(buf.written(), before):
            assert torch.equal(t, b)


def test_moe_decode_step_captured_equals_eager(dev):
    """An MoE decode step on the dispatch path (16 experts: the block's
    rows one capacity group) captures as one CUDA graph and replays the
    closure's eager bits (tokens and the written entries)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CompiledForwardCache
    from repro_torch.runtime import decode_engine as de
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"),
                              n_experts=16)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    bufs = [de._SlotBuffers(cfg, 32, 4, 8, dev) for _ in range(2)]
    for b in bufs:
        g = torch.Generator(device=dev).manual_seed(3)
        for c in (b.k_codes, b.v_codes):
            c.random_(-127, 128, generator=g)
        b.pos.copy_(torch.tensor([3, 9, 20, 31], dtype=torch.int32))
        b.tok.copy_(torch.tensor([1, 2, 3, 4], dtype=torch.int32))
    step = de._step_call(CompiledForwardCache(), model, 8, params, bufs[0])
    assert step.graph is not None
    live = np.ones(4, np.int32)
    blk_a, _ = de._decode_chunk(step, bufs[0].step_io, live, 3)
    blk_b, _ = de._decode_chunk(
        lambda: de._decode_step(model, 8, params, bufs[1], bufs[1].step_io),
        bufs[1].step_io, live, 3)
    torch.cuda.synchronize()
    assert torch.equal(blk_a, blk_b)
    for ta, tb in zip(bufs[0].written(), bufs[1].written()):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("b_kv", [8, 16])
@pytest.mark.parametrize("warm", [False, True])
def test_captured_decode_engine_equals_reference(dev, smoke_lm, warm, b_kv):
    """Through graphs on the card: the engine equals the batch-1 oracle
    bitwise (the oracle's graphs from the same cache), with or without
    warm-up (a lazily captured graph mid-traffic changes no live row), and
    after warm-up no request captures; int8 codes and the raw f32 cache."""
    model, params = smoke_lm
    eng = _decode_engine(model, params, dev, b_kv)
    n = eng.warmup(20) if warm else 0
    traffic = _decode_traffic(model.cfg.vocab_size)
    rids = {eng.submit(t, "interactive", max_new_tokens=m, arrival_s=a): i
            for i, (t, m, a) in enumerate(traffic)}
    got = {rids[r.request_id]: r for r in eng.drain()}
    rep = eng.report()
    if warm:
        assert n > 0 and rep.compile_misses == n
    launches = eng.compile_cache.kernel_launches()
    assert launches["quantized_decode_attention"] \
        == model.cfg.n_layers * rep.decode_rounds
    for i, r in got.items():
        toks, m, _ = traffic[i]
        want = greedy_decode_reference(
            model, eng.class_params("interactive"), toks, m, b_kv=b_kv,
            compile_cache=eng.compile_cache, device=dev)
        np.testing.assert_array_equal(r.tokens, want)


def test_captured_decode_engine_past_16_slots(dev, smoke_lm):
    """max_batch 32 (once a fault: row_gemm raised past 16 rows) serving
    40 prompts from graphs: every response bitwise its batch-1 oracle."""
    from repro_torch.runtime import DecodeEngine
    model, params = smoke_lm
    eng = DecodeEngine(model, params, SMOKE_SYSP,
                       classes=[QosClass("interactive", t0=3.5, e0=2.0)],
                       auto=False, max_batch=32, max_new_tokens=6,
                       device=dev)
    eng.set_operating_point("interactive", 8, 8)
    traffic = _decode_traffic(model.cfg.vocab_size, n=40, seed=5)
    rids = {eng.submit(t, "interactive", max_new_tokens=m, arrival_s=0.0):
            i for i, (t, m, _) in enumerate(traffic)}
    got = {rids[r.request_id]: r for r in eng.drain()}
    assert len(got) == 40
    for i, r in got.items():
        toks, m, _ = traffic[i]
        want = greedy_decode_reference(
            model, eng.class_params("interactive"), toks, m, b_kv=8,
            compile_cache=eng.compile_cache, device=dev)
        np.testing.assert_array_equal(r.tokens, want)


def _spec_engine(model, params, dev, **kw):
    from repro_torch.runtime import SpeculativeDecodeEngine
    eng = SpeculativeDecodeEngine(
        model, params, SMOKE_SYSP,
        classes=[QosClass("interactive", t0=3.5, e0=2.0)], auto=False,
        max_batch=3, max_new_tokens=6, device=dev, **kw)
    eng.set_operating_point("interactive", 8, 8, b_draft=4, k=4)
    return eng


def test_decode_step_clamps_at_the_cache_end(dev, smoke_lm):
    """A row at pos = T writes its entry at T - 1 (the reference's
    dynamic_update_slice clamp) with no device assert: every other
    position of the row is untouched, and each row of the batched step is
    bitwise the row stepped alone."""
    from repro_torch.models.lm import tree_map
    from repro_torch.runtime import decode_engine as de
    from repro_torch.runtime import greedy_decode_reference as gref
    model, params = smoke_lm
    cfg = model.cfg
    w = tree_map(lambda a: a.to(dev), params)
    rng = np.random.default_rng(4)
    states = [gref(model, params, rng.integers(0, cfg.vocab_size, p), 1,
                   b_kv=8, reserve_tokens=16 - p, return_state=True,
                   device="cpu")[1] for p in (10, 14)]
    states[1]["pos"] = np.int32(16)

    def stepped(rows):
        buf = de._SlotBuffers(cfg, 16, len(rows), 8, dev)
        for name in ("k_codes", "v_codes", "k_scales", "v_scales"):
            getattr(buf, name).copy_(torch.from_numpy(np.concatenate(
                [states[r][name] for r in rows], axis=1)))
        buf.pos.copy_(torch.tensor([int(states[r]["pos"]) for r in rows]))
        buf.tok.copy_(torch.tensor([int(states[r]["last_token"])
                                    for r in rows]))
        de._decode_step(model, 8, w, buf, buf.step_io)
        torch.cuda.synchronize()
        return [t.cpu() for t in buf.canonical()]

    both, alone = stepped([0, 1]), [stepped([0]), stepped([1])]
    assert int(both[4][1]) == 17
    for i, t in enumerate(both):
        for r in (0, 1):
            row = t[:, r] if t.dim() > 1 else t[r:r + 1]
            one = alone[r][i][:, 0] if t.dim() > 1 else alone[r][i]
            assert torch.equal(row, one)
    for i, name in enumerate(("k_codes", "v_codes", "k_scales",
                              "v_scales")):
        before = torch.from_numpy(states[1][name])[:, 0]
        assert torch.equal(both[i][:, 1, :15], before[:, :15])
    assert not torch.equal(both[0][:, 1, 15],
                           torch.from_numpy(states[1]["k_codes"])[:, 0, 15])


def test_captured_spec_round_equals_eager(dev, smoke_lm):
    """One speculative round from the captured draft and verify steps
    equals the same closures run eagerly on a copy of the same slot block,
    bitwise (delivered block, counts, codes, scales, positions); the fixed
    n_draft + 1 verify replays deliver the same; the engine from graphs
    equals the batch-1 oracle with no capture after warm-up; the decode
engine at 32 slots equals the batch-1 oracle."""
    from repro_torch.runtime import decode_engine as de
    model, params = smoke_lm
    eng = _spec_engine(model, params, dev)
    w = eng.class_params("interactive")
    wd = eng.spec_params("interactive")
    cache = eng.compile_cache
    cfg = model.cfg
    bufs = [de._SlotBuffers(cfg, 32, 3, 8, dev) for _ in range(3)]
    rng = np.random.default_rng(0)
    prefill = de._prefill_call(cache, model, 8, w, bufs[0], 16)
    for slot, p_len in ((0, 9), (1, 14), (2, 5)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p_len] = rng.integers(0, cfg.vocab_size, p_len)
        de._run_prefill(prefill, bufs[0].prefill_io(16), padded, p_len, slot)
    for b in bufs[1:]:
        for t, s in zip(b.canonical(), bufs[0].canonical()):
            t.copy_(s)
    draft = de._spec_draft_call(cache, model, 8, wd, bufs[0])
    verify = de._spec_verify_call(cache, model, 8, w, bufs[0])
    assert draft.graph is not None and verify.graph is not None
    assert verify.launches["quantized_decode_attention"] == cfg.n_layers
    live = np.asarray([1, 1, 0], np.int32)
    rem = np.asarray([5, 2, 0], np.int32)
    got = de._spec_round(draft, verify, bufs[0], live, rem, 4)
    eager = de._spec_round(
        lambda: de._spec_draft_step(model, 8, wd, bufs[1].spec_io()),
        lambda: de._spec_verify_step(model, 8, w, bufs[1],
                                     bufs[1].spec_io()),
        bufs[1], live, rem, 4)
    fixed = de._spec_round(
        lambda: de._spec_draft_step(model, 8, wd, bufs[2].spec_io()),
        lambda: de._spec_verify_step(model, 8, w, bufs[2],
                                     bufs[2].spec_io()),
        bufs[2], live, rem, 4, read_flags=False)
    torch.cuda.synchronize()
    assert fixed[3] == 5 >= eager[3] == got[3]
    for a, b, c in zip(got[:3], eager[:3], fixed[:3]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[1], fixed[1]) and np.array_equal(got[2],
                                                               fixed[2])
    for ta, tb, tc in zip(bufs[0].canonical(), bufs[1].canonical(),
                          bufs[2].canonical()):
        assert torch.equal(ta, tb) and torch.equal(ta, tc)
    eng2 = _spec_engine(model, params, dev)
    n = eng2.warmup(20)
    traffic = _decode_traffic(model.cfg.vocab_size)
    rids = {eng2.submit(t, "interactive", max_new_tokens=m, arrival_s=a): i
            for i, (t, m, a) in enumerate(traffic)}
    out = {rids[r.request_id]: r for r in eng2.drain()}
    assert eng2.report().compile_misses == n > 0
    for i, r in out.items():
        toks, m, _ = traffic[i]
        np.testing.assert_array_equal(r.tokens, greedy_decode_reference(
            model, eng2.class_params("interactive"), toks, m, b_kv=8,
            compile_cache=eng2.compile_cache, device=dev))


# ---------------------------------------------------------------------------
# fleet, supervisor and checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_hat", [8, 4])
def test_shared_graph_cache_keys_on_the_baked_in_weights(dev, b_hat):
    """Two engines with one config and b̂ but different weights, over one
    compile cache: each replays a graph of its own weights and returns its
    own uncached engine's logits, bitwise."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine, CompiledForwardCache

    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    cache = CompiledForwardCache()
    got, want = [], []
    for seed in (0, 1):
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        shared = CoInferenceEngine(model, params, sysp, path="kernel",
                                   compiled=True, compile_cache=cache,
                                   device=dev)
        own = CoInferenceEngine(model, params, sysp, path="kernel",
                                compiled=True, device=dev)
        for eng in (shared, own):
            eng.configure(b_hat)
        got.append(shared.serve_batch({"tokens": toks})[0])
        want.append(own.serve_batch({"tokens": toks})[0])
    assert cache.misses == 2 and cache.hits == 0
    assert all(cf.graph is not None for cf in cache._exe.values())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])


def test_one_agent_fleet_from_graphs_equals_batched(dev, smoke_lm):
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.runtime import (BatchedCoInferenceEngine,
                                     FleetAgentSpec, FleetCoInferenceEngine,
                                     QosClass)

    model, params = smoke_lm
    sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    qos = QosClass("solo", t0=1.3, e0=1.5)
    kw = dict(max_batch=4, path="kernel", compiled=True, device=dev)
    fleet = FleetCoInferenceEngine(
        [FleetAgentSpec(name="solo", model=model, params=params, sysp=sysp,
                        qos=qos)], **kw)
    solo = BatchedCoInferenceEngine(model, params, sysp, classes=[qos], **kw)
    rng = np.random.default_rng(2)
    for _ in range(5):
        toks = rng.integers(0, model.cfg.vocab_size,
                            size=int(rng.integers(6, 17)))
        fleet.submit("solo", toks)
        solo.submit(toks, "solo")
    for x, y in zip(fleet.drain()["solo"], solo.drain()):
        assert x.stats == y.stats and torch.equal(x.logits, y.logits)


def test_snapshot_on_the_card_resumes_bitwise(dev, smoke_lm):
    """A slot snapshot taken between graph steps is the batch-1 state, and
    resuming it through the batch-1 graphs finishes the stream."""
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.runtime import (DecodeEngine, QosClass,
                                     greedy_decode_reference)

    model, params = smoke_lm
    qos = QosClass("c", t0=3.0, e0=2.0)
    eng = DecodeEngine(model, params,
                       SystemParams(n_flop_agent=6.4e10,
                                    n_flop_server=1.92e11),
                       classes=[qos], auto=False, max_batch=2,
                       max_new_tokens=8, device=dev)
    eng.set_operating_point("c", 8, 8)
    p = np.random.default_rng(4).integers(0, model.cfg.vocab_size, 14)
    rid = eng.submit(p, "c")
    for _ in range(3):
        eng.step(max_decode_steps=1)
    snap = eng.snapshot_request(rid)
    w = eng.class_params("c")
    done = len(snap["generated"])
    rest = greedy_decode_reference(model, w, p, 8 - done, b_kv=8,
                                   state=snap["state"],
                                   compile_cache=eng.compile_cache,
                                   device=dev)
    full = greedy_decode_reference(model, w, p, 8, b_kv=8,
                                   compile_cache=eng.compile_cache,
                                   device=dev)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(snap["generated"]), rest]), full)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamW

    g = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=g, device=dev),
              "b": torch.randn((32,), generator=g, device=dev)}
    tree = {"params": params, "opt": AdamW().init(params),
            "err": torch.zeros((), device=dev)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    w0 = params["w"].clone()
    mgr.save_async(3, tree, metadata={"data_step": 3})
    params["w"].add_(1.0)       # after the call: not in the checkpoint
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": AdamW().init(params), "err": torch.ones((), device=dev)}
    restored, manifest = mgr.restore_latest(like)
    assert manifest["step"] == 3
    assert restored["params"]["w"].device.type == "cuda"
    assert torch.equal(restored["params"]["w"], w0)
    assert torch.equal(restored["params"]["b"], params["b"])
    assert torch.equal(restored["err"], torch.zeros((), device=dev))
