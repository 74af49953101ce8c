"""The port's KV-cache quantizer against the reference's.

The reference only runs ``kv_quantize`` under ``jax.jit`` (inside its
prefill and decode executables), where XLA turns ``amax / levels`` into
``amax * fl(1/levels)``; the port forms the scale that way, so codes and
scales are bitwise the jitted reference's, zero vectors included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jq
from repro_torch.kernels import quantize as tq

_jit_kv_quantize = jax.jit(jq.kv_quantize, static_argnums=1)


def _cache(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    x[..., 0, :] = 0.0                 # whole zero head vectors
    x[0, 1] = 0.0
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(2, 3, 16, 2, 16), (4, 256, 2, 64),
                                   (24, 4, 256, 2, 64)])
def test_kv_quantize_bitwise_the_jitted_reference(bits, shape):
    x = _cache(bits * 100 + len(shape), shape)
    want_c, want_s = _jit_kv_quantize(jnp.asarray(x), bits)
    got_c, got_s = tq.kv_quantize(torch.from_numpy(x), bits)
    assert got_c.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_s.numpy()[..., 0] == 1.0).all()          # zero vectors


@pytest.mark.parametrize("bits", [4, 8])
def test_kv_dequantize_equals_reference(bits):
    x = _cache(7, (3, 32, 2, 16))
    codes, scales = _jit_kv_quantize(jnp.asarray(x), bits)
    want = jq.kv_dequantize(codes, scales)
    got = tq.kv_dequantize(torch.from_numpy(np.asarray(codes)),
                           torch.from_numpy(np.asarray(scales)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 5, 8, 16])
@pytest.mark.parametrize("shape", [(4, 1, 256, 2, 64), (24, 1, 1024, 2, 64),
                                   (3, 7, 16)])
def test_kv_cache_bytes_equals_reference(bits, shape):
    assert tq.kv_cache_bytes(shape, bits) == jq.kv_cache_bytes(shape, bits)
    assert tq.kv_levels(bits) == jq.kv_levels(bits)
