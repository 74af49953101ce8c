"""Decode attention over a quantized KV cache: the port's plain version
against the reference's, and the port's bitwise properties.

On the CPU the wrapper runs its plain version
(``ref.quantized_decode_attention_ref``).  Against the reference's
``quantized_decode_attention_ref`` it agrees within rtol = atol = 1e-5,
the reference's own GQA tolerance (``tests/test_decode_kernel.py``):
the same tile schedule, with sums in another order.  Port against port
it is bitwise: a row alone equals the row in a batch, growing the cache
bucket with the lengths fixed changes no bit, and the raw b_kv >= 16
container with unit scales is exact.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as jda
from repro_torch import kernels as tk
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attn import quantized_decode_attention
from repro_torch.kernels.quantize import kv_quantize

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launch_counts()
    yield
    assert tk.quantized_decode_attention.launches == 0  # CPU: plain only


def _case(b, h, kv, dh, t, b_kv, seed, lens=None):
    """numpy q [B,1,H,dh], codes [B,T,KV,dh], scales [B,T,KV], lens [B]."""
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
    if lens is None:
        lens = rng.integers(0, t + 1, size=b)
        lens[0] = 0                        # an empty row
    arrs = (q, kc.numpy(), vc.numpy(), ks.numpy(), vs.numpy(),
            np.asarray(lens, np.int32))
    return tuple(np.ascontiguousarray(a) for a in arrs)


def _port(arrs, **kw):
    return quantized_decode_attention(*map(torch.from_numpy, arrs), **kw)


def _jax(arrs, **kw):
    return np.asarray(jda.quantized_decode_attention_ref(
        *map(jnp.asarray, arrs), **kw))


# the reference's ladder: head dims x (cache bucket, tile) pairs covering
# single- and multi-tile grids
LADDER = [(dh, t, bt) for dh in (8, 16, 32)
          for (t, bt) in ((16, 16), (64, 16), (128, 32))]


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("dh,t,bt", LADDER)
def test_plain_matches_reference(b_kv, dh, t, bt):
    arrs = _case(3, 4, 2, dh, t, b_kv, seed=dh * 1000 + t + b_kv)
    got = _port(arrs, block_t=bt)
    np.testing.assert_allclose(got.numpy(), _jax(arrs, block_t=bt), **TOL)
    assert (got[0] == 0).all()                # cache_len 0 attends nothing


@pytest.mark.parametrize("b_kv", [4, 8, 16])
@pytest.mark.parametrize("window", [3, 7, 40])
def test_plain_matches_reference_sliding_window(b_kv, window):
    arrs = _case(4, 4, 2, 16, 64, b_kv, seed=window,
                 lens=[0, 5, 33, 64])
    np.testing.assert_allclose(
        _port(arrs, window=window, block_t=16).numpy(),
        _jax(arrs, window=window, block_t=16), **TOL)


def test_plain_matches_reference_at_qwen2_heads():
    """The full-width model's head layout: 14 query heads over 2 KV heads
    (G = 7), dh = 64, the default 128-position tile."""
    arrs = _case(2, 14, 2, 64, 256, 8, seed=14, lens=[200, 129])
    np.testing.assert_allclose(_port(arrs).numpy(), _jax(arrs), **TOL)


@pytest.mark.parametrize("grow", [16, 96])
def test_bucket_padding_is_invisible(grow):
    q, kc, vc, ks, vs, lens = _case(3, 4, 2, 16, 32, 8, seed=grow)
    pad = [(0, 0), (0, grow), (0, 0), (0, 0)]
    out = _port((q, kc, vc, ks, vs, lens), block_t=16)
    out_pad = _port((q, np.pad(kc, pad), np.pad(vc, pad),
                     np.pad(ks, pad[:-1]), np.pad(vs, pad[:-1]), lens),
                    block_t=16)
    assert torch.equal(out, out_pad)


@pytest.mark.parametrize("b_kv", [4, 8, 16])
def test_row_alone_equals_row_in_batch(b_kv):
    arrs = _case(5, 14, 2, 64, 256, b_kv, seed=b_kv,
                 lens=[0, 1, 128, 129, 256])
    out = _port(arrs)
    for i in range(5):
        alone = _port(tuple(a[i:i + 1] for a in arrs))
        assert torch.equal(alone[0], out[i]), f"row {i}"


def test_raw_container_is_exact():
    """b_kv >= 16 keeps raw values with unit scales: the plain version
    then equals attention over the unquantized cache, dequantization being
    x * 1.0."""
    q, k, v, ones, _, lens = _case(2, 4, 2, 16, 32, 16, seed=9,
                                   lens=[32, 16])
    out = _port((q, k, v, ones, ones, lens), block_t=16)
    want = _port((q, k * np.float32(1.0), v * np.float32(1.0), ones, ones,
                  lens), block_t=16)
    assert torch.equal(out, want) and torch.isfinite(out).all()


def test_scalar_cache_len_broadcasts():
    arrs = _case(2, 4, 2, 16, 32, 8, seed=1, lens=[20, 20])
    got = quantized_decode_attention(*map(torch.from_numpy, arrs[:5]), 20,
                                     block_t=16)
    assert torch.equal(got, _port(arrs, block_t=16))


@pytest.mark.parametrize("bad", ["tile", "dtype", "heads"])
def test_wrapper_rejects_bad_arguments(bad):
    q, kc, vc, ks, vs, lens = map(torch.from_numpy,
                                  _case(1, 4, 2, 16, 48, 8, seed=0))
    with pytest.raises(ValueError):
        if bad == "tile":          # T = 48 is not a multiple of bt = 32
            quantized_decode_attention(q, kc, vc, ks, vs, lens, block_t=32)
        elif bad == "dtype":
            quantized_decode_attention(q, kc.to(torch.int16), vc, ks, vs,
                                       lens, block_t=16)
        else:
            quantized_decode_attention(q[:, :, :3], kc, vc, ks, vs, lens,
                                       block_t=16)


def test_plain_version_is_the_wrappers_cpu_path():
    arrs = _case(2, 4, 2, 16, 64, 4, seed=3)
    tensors = list(map(torch.from_numpy, arrs))
    assert torch.equal(
        quantized_decode_attention(*tensors, block_t=16),
        ref.quantized_decode_attention_ref(*tensors, block_t=16))
