"""The arithmetic of the two attention kernels, checked on the CPU.

The decode kernel (``csrc/decode_attn.cu``) splits the cache into chunks
of ``CHUNK`` positions at fixed multiples of CHUNK and combines the
chunks' softmax states in ascending order; ``decode_attn.chunks`` is its
schedule and ``ref.decode_attention_chunked_ref`` its order of arithmetic
in plain torch.  The flash kernel (``csrc/flash_attn.cu``) forms both of
its products on the tensor cores as three TF32 passes of an
error-compensated split; ``ref.tf32_rna``, ``ref.tf32x3_matmul`` and
``ref.flash_split_emulation`` model them.  Here those models are held
against the JAX reference (its Pallas kernels in interpret mode, or its
jnp oracle, as its own tests run them) at the reference's tolerances:
1e-5 x max|out| for decode, rtol = atol = 2e-5 for flash in f32 (3e-2 for
bf16 inputs).  The kernels themselves run in tests/test_torch_cuda.py
and chip_smoke.py on the card.  Inputs come from numpy seeds.
"""

import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as jda
from repro.kernels import flash as jflash
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import ref
from repro_torch.kernels.quantize import kv_quantize

CSRC = pathlib.Path(tda.__file__).resolve().parent / "csrc"
C = tda.CHUNK
FLASH_TOL = 2e-5


# ---------------------------------------------------------------------------
# (a) the decode kernel's chunk schedule
# ---------------------------------------------------------------------------

def test_chunk_is_the_kernels_constant():
    src = (CSRC / "decode_attn.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src)[1]) == C
    # nothing of the plain version's tile reaches the schedule
    assert "block_t" not in inspect.signature(tda.chunks).parameters
    assert "block_t" not in inspect.signature(
        ref.decode_attention_chunked_ref).parameters


@pytest.mark.parametrize("window", [0, 1, 63, 64, 100, 1000])
@pytest.mark.parametrize("length", [0, 1, C - 1, C, C + 1, 300, 532, 1024])
def test_chunks_hold_the_live_positions(length, window):
    """Exactly the chunks with a live position, ascending, and the same
    for every cache length T >= the row's length."""
    want = None
    for t in (length, 1024, 2048, 4096):
        if t < max(length, 1):
            continue
        hi = min(length, t)
        lo = max(length - window, 0) if window > 0 else 0
        brute = [c for c in range(-(-t // C))
                 if any(lo <= p < hi for p in range(c * C, (c + 1) * C))]
        got = list(tda.chunks(t, length, window))
        assert got == brute
        want = got if want is None else want
        assert got == want, f"T={t} changed the chunks"


def test_chunks_fill_the_card_at_the_timed_shape():
    """B = 4, T = 1024, lengths [1024, 800, 532, 300], KV = 2: 86 blocks
    (one (row, kv head) each gave 8)."""
    live = sum(len(tda.chunks(1024, n)) for n in (1024, 800, 532, 300))
    assert 2 * live == 86


@pytest.mark.parametrize("g,dh,t", [(7, 64, 524288), (48, 128, 32768),
                                    (1, 80, 1024), (4, 128, 131072)])
def test_smem_bytes_does_not_grow_with_the_cache(g, dh, t):
    """The combine keeps its weights in the global workspace, so a block's
    shared memory is the same at every T: qwen2-0.5b's heads (7, 64) at
    the reference's LONG_500K (524,288) and granite-34b's (48, 128) at
    DECODE_32K (32,768) fit the card; a head size whose chunk cannot fit
    still does not."""
    want = tda.smem_bytes(g, dh, C)
    for tt in (1, C, 1024, t, 4 * t):
        assert tda.smem_bytes(g, dh, tt) == want
    assert want <= tda.MAX_SMEM_BYTES
    assert tda.smem_bytes(2, 1024, t) > tda.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# (b) the decode combine against the reference
# ---------------------------------------------------------------------------

def _decode_case(b, t, b_kv, seed, lens, h=14, kv=2, dh=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32))
    if b_kv < 16:
        (kc, ks), (vc, vs) = kv_quantize(k, b_kv), kv_quantize(v, b_kv)
    else:
        kc, vc = k, v
        ks = vs = torch.ones(k.shape[:-1])
    return (torch.from_numpy(q), kc, vc, ks, vs,
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("window", [0, 100])
def test_chunked_decode_matches_reference(b_kv, window):
    """qwen2-0.5b's heads (14 over 2, dh = 64), lengths at the chunk
    edges and 0, against the reference's sequential tile walk."""
    t = 256
    lens = [0, 1, C - 1, C + 1, 200, t]
    args = _decode_case(len(lens), t, b_kv, seed=b_kv + window, lens=lens)
    got = ref.decode_attention_chunked_ref(*args, window=window)
    want = np.asarray(jda.quantized_decode_attention_ref(
        *(jnp.asarray(a.numpy()) for a in args), window=window))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert (got[0] == 0).all()                   # cache_len 0


@pytest.mark.parametrize("b_kv", [4, 16])
def test_chunked_decode_rows_alone_and_padding_bitwise(b_kv):
    t = 256
    lens = [t, 130, 64, 0, 1]
    args = _decode_case(len(lens), t, b_kv, seed=3 * b_kv, lens=lens)
    out = ref.decode_attention_chunked_ref(*args, window=40)
    for i in range(len(lens)):
        alone = ref.decode_attention_chunked_ref(
            *(a[i:i + 1] for a in args), window=40)
        assert torch.equal(alone[0], out[i]), f"row {i}"
    q, kc, vc, ks, vs, ln = args
    pad = (0, 0, 0, 0, 0, t)
    grown = ref.decode_attention_chunked_ref(
        q, torch.nn.functional.pad(kc, pad), torch.nn.functional.pad(vc, pad),
        torch.nn.functional.pad(ks, pad[2:], value=7.0),
        torch.nn.functional.pad(vs, pad[2:], value=7.0), ln, window=40)
    assert torch.equal(grown, out)


# ---------------------------------------------------------------------------
# (c) the error-compensated TF32 product
# ---------------------------------------------------------------------------

def test_tf32_rounding_is_cvt_rna():
    one = 1.0
    ulp = 2.0 ** -10                  # TF32 keeps 10 stored mantissa bits
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 0.0, 3.0e-3, -7.5e4],
                     dtype=torch.float32)
    got = ref.tf32_rna(x)
    # ties away from zero, else to nearest
    assert got[:5].tolist() == [one, one + ulp, one, one + ulp,
                                -(one + ulp)]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())          # 13 low bits clear
    assert bool(((got - x).abs() <= x.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_22_bits(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.uniform(-6, 6, 20000))
                         .astype(np.float32))
    hi, lo = ref.split_tf32(x)
    assert torch.equal(ref.tf32_rna(hi), hi)
    assert torch.equal(ref.tf32_rna(lo), lo)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -22).all())


@pytest.mark.parametrize("dh", [64, 128])
def test_three_pass_dot_within_the_flash_budget(dh):
    """q . k at O(1) inputs: three passes sit within the bound of their
    dropped and rounded terms plus f32 accumulation (~1e-6 of
    sum |q_i k_i|), no further from the float64 dot than an ascending f32
    chain (the SIMT kernel's arithmetic), and the scaled score's error is
    a tenth of FLASH_TOL; one TF32 pass misses FLASH_TOL itself."""
    rng = np.random.default_rng(dh)
    a = rng.standard_normal((256, dh)).astype(np.float32)
    b = rng.standard_normal((dh, 256)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = ref.tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b))
    err = np.abs(got.numpy().astype(np.float64) - exact)
    assert bool((err <= (3 * 2.0 ** -22 + dh * 2.0 ** -24) * mag).all())
    chain = np.zeros((256, 256), np.float32)
    for i in range(dh):
        chain = (chain + np.outer(a[:, i], b[i])).astype(np.float32)
    assert err.max() <= np.abs(chain.astype(np.float64) - exact).max()
    assert err.max() * dh ** -0.5 < FLASH_TOL / 10
    one_pass = ref.tf32_rna(torch.from_numpy(a)) @ ref.tf32_rna(
        torch.from_numpy(b))
    err1 = np.abs(one_pass.numpy().astype(np.float64) - exact)
    assert err1.max() * dh ** -0.5 > FLASH_TOL


# ---------------------------------------------------------------------------
# (d) attention with split products against the reference
# ---------------------------------------------------------------------------

CASES = [
    # B, H, KV, S, dh, causal, window (tests/test_flash.py's, qwen2's heads)
    (2, 4, 4, 256, 64, True, 0),
    (2, 4, 1, 128, 32, True, 0),               # MQA
    (1, 4, 4, 256, 64, False, 0),              # bidirectional
    (1, 4, 4, 256, 64, True, 64),              # sliding window
    (1, 2, 2, 384, 128, True, 0),              # dh = 128
    (2, 14, 2, 64, 64, True, 0),               # qwen2-0.5b, serve shape
    (1, 14, 2, 100, 64, True, 0),              # off the 64-row tile
]


def _qkv(seed, b, h, kv, s, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, dh)).astype(np.float32),
            rng.standard_normal((b, kv, s, dh)).astype(np.float32),
            rng.standard_normal((b, kv, s, dh)).astype(np.float32))


@pytest.mark.parametrize("b,h,kv,s,dh,causal,win", CASES)
def test_split_attention_matches_reference_kernel(b, h, kv, s, dh, causal,
                                                  win):
    q, k, v = _qkv(b * s + h, b, h, kv, s, dh)
    if s % 64:       # the reference's kernel needs whole blocks: its oracle
        want = jflash._ref_attention(*map(jnp.asarray, (q, k, v)), causal,
                                     win)
    else:
        want = jflash.flash_attention_fwd(
            *map(jnp.asarray, (q, k, v)), causal=causal, window=win,
            block_q=64, block_k=64, interpret=True)
    got = ref.flash_split_emulation(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_split_attention_bf16_matches_reference_kernel():
    """bf16 inputs: one pass for q k^T, two for p V (V exact); the
    reference's bf16 tolerance."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(0, 1, 4, 4, 256, 64))
    want = jflash.flash_attention_fwd(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), causal=True, interpret=True)
    got = ref.flash_split_emulation(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def _attention_f64(q, k, v, causal, kv_len=None):
    """Masked softmax attention in float64, q [B, H, S, dh]."""
    b, h, s, dh = q.shape
    g = h // k.shape[1]
    ke, ve = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    sc = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64),
                   ke.astype(np.float64)) * dh ** -0.5
    mask = np.ones((b, 1, s, k.shape[2]), bool)
    if causal:
        mask &= np.tril(np.ones((s, k.shape[2]), bool))
    if kv_len is not None:
        mask &= (np.arange(k.shape[2])[None, :]
                 < np.asarray(kv_len)[:, None])[:, None, None]
    sc = np.where(mask, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bhtd->bhsd", p, ve.astype(np.float64))


def test_split_attention_holds_at_the_longest_shape():
    """S = 1024, dh = 128: 16 kv tiles and 16 MMA-deep steps of
    accumulation, within FLASH_TOL of float64 attention."""
    q, k, v = _qkv(1024, 1, 2, 1, 1024, 128)
    got = ref.flash_split_emulation(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), _attention_f64(q, k, v, True),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_split_attention_masks_past_kv_len():
    q, k, v = _qkv(7, 2, 4, 2, 100, 64)
    lens = [100, 37]
    got = ref.flash_split_emulation(*map(torch.from_numpy, (q, k, v)),
                                    causal=False, kv_len=torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(),
                               _attention_f64(q, k, v, False, lens),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
