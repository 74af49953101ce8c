"""The port's kernel wrappers (plain versions on the CPU) against the JAX
reference's ``repro.kernels.ops`` / ``repro.kernels.ref``, which run their
Pallas kernels in interpret mode here, as tests/test_kernels.py does.

Integer outputs (codes, scales, packed nibbles) must be exactly equal;
matmuls agree at rtol = atol = 1e-4, the tolerance of
tests/test_kernels.py (two f32 dot products summed in different orders).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()
    yield
    # every call in this file ran on CPU tensors: no kernel may launch
    assert tk.launch_counts() == {"group_quantize": 0, "qmm": 0,
                                  "qmm_int4": 0,
                                  "quantized_decode_attention": 0,
                                  "flash_attention_fwd": 0, "row_gemm": 0,
                                  "tc_gemm": 0}


# (k, n, group, bits): tests/test_kernels.py's shapes, the qwen2 MLP
# shapes, and the reference's fallback layouts (k < G, k not tileable,
# N off the 128 grid)
GQ_CASES = [
    (256, 128, 128, 8), (512, 256, 64, 8), (1024, 384, 256, 8),
    (256, 128, 128, 4), (512, 512, 128, 4),
    (896, 4864, 128, 8), (896, 4864, 128, 4),
    (4864, 896, 128, 8), (4864, 896, 128, 4),
    (96, 128, 128, 8), (192, 128, 128, 8), (256, 100, 128, 4),
]


@pytest.mark.parametrize("k,n,g,bits", GQ_CASES)
def test_group_quantize_exact(k, n, g, bits):
    w = _normal(k * 7 + n, (k, n))
    codes_j, scales_j = jops.group_quantize(jnp.asarray(w), group_size=g,
                                            bits=bits)
    codes_t, scales_t = tops.group_quantize(_t(w), group_size=g, bits=bits)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j))


def test_group_quantize_zero_group_scale_one():
    w = np.zeros((256, 128), np.float32)
    w[128:] = _normal(1, (128, 128))
    codes, scales = tops.group_quantize(_t(w), group_size=128)
    assert torch.all(scales[0] == 1.0) and torch.all(codes[:128] == 0)


def test_pack_unpack_int4_exact():
    codes = np.random.default_rng(0).integers(-7, 8, (256, 128)).astype(
        np.int8)
    packed_j = np.asarray(jref.pack_int4_ref(jnp.asarray(codes)))
    packed_t = tref.pack_int4_ref(_t(codes))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    np.testing.assert_array_equal(tref.unpack_int4_ref(packed_t).numpy(),
                                  codes)


# (m, k, n, g) from tests/test_kernels.py's SHAPES: aligned, G = 256,
# G = 64, the qwen2 MLP decode row, ragged M with K off the block grid
QMM_CASES = [
    (128, 256, 128, 128), (64, 1024, 384, 256), (512, 256, 128, 64),
    (1, 896, 4864, 128), (33, 640, 256, 128),
]


@pytest.mark.parametrize("m,k,n,g", QMM_CASES)
def test_qmm_matches_reference(m, k, n, g):
    x, w = _normal(m + k, (m, k)), _normal(n + g, (k, n))
    codes, scales = jref.group_quantize_ref(jnp.asarray(w), g)
    want = jops.quantized_matmul(jnp.asarray(x), codes, scales)
    got = tops.quantized_matmul(_t(x), _t(codes), _t(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n,g", QMM_CASES)
def test_qmm_int4_matches_reference(m, k, n, g):
    x, w = _normal(m + k + 1, (m, k)), _normal(n + g + 1, (k, n))
    codes, scales = jref.group_quantize_ref(jnp.asarray(w), g, bits=4)
    packed = jref.pack_int4_ref(codes)
    want = jops.quantized_matmul_int4(jnp.asarray(x), packed, scales)
    got = tops.quantized_matmul_int4(_t(x), _t(packed), _t(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_linear_leading_dims(bits):
    """[B, S, K] flattens into M; every row equals the row served alone."""
    x, w = _normal(3, (3, 5, 256)), _normal(4, (256, 128))
    ql_t = tops.quantize_linear(_t(w), bits=bits)
    ql_j = jops.quantize_linear(jnp.asarray(w), bits=bits)
    np.testing.assert_array_equal(ql_t.codes.numpy(), np.asarray(ql_j.codes))
    got = ql_t.apply(_t(x))
    assert got.shape == (3, 5, 128)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ql_j.apply(jnp.asarray(x))), **TOL)
    assert ql_t.nbytes() == ql_j.nbytes()


def test_group_layout_follows_reference():
    assert tops.group_layout(896, 128) == 128
    assert tops.group_layout(96, 128) == 96
    assert tops.group_layout(192, 128) == 1


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor runs the plain version; off the CPU a wrapper
    runs its kernel's op: the launch on CUDA, and on ``meta`` (the
    dry-run's stand-in for the card) the op's fake version, which
    computes nothing (no product of the plain version is dispatched) and
    refuses what the kernel would (a CPU operand beside a card one)."""
    from repro_torch.launch import opcount as oc
    x = torch.zeros(4, 256, device="meta")
    codes = torch.zeros(256, 64, dtype=torch.int8, device="meta")
    scales = torch.ones(2, 64, device="meta")
    wt = x.T.contiguous()
    for name, call in (("qmm", lambda: tk.qmm(x, codes, scales)),
                       ("qmm_int4", lambda: tk.qmm_int4(x, codes[:128],
                                                        scales)),
                       ("group_quantize", lambda: tk.group_quantize(wt))):
        out, c = oc.account(call)
        assert c.kernel_calls == {name: 1}
        assert c.n_dots == 0
        for t in (out if isinstance(out, tuple) else (out,)):
            assert t.device.type == "meta"
    with pytest.raises(ValueError, match="several devices"):
        tk.qmm(x, codes, torch.ones(2, 64))


def test_kernel_build_keeps_ieee_numerics():
    """The quantizer's codes depend on IEEE division and rint: the build
    must target Hopper without fast-math."""
    from repro_torch.kernels import build
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags
    assert "fast_math" not in flags and "prec-div" not in flags
    assert build.lib_path("qmm") != build.lib_path("group_quantize")


def test_wrappers_reject_bad_shapes():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError):
        tk.qmm(x, torch.zeros(128, 64, dtype=torch.int8), torch.ones(1, 64))
    with pytest.raises(ValueError):
        tk.qmm_int4(torch.zeros(4, 255), torch.zeros(127, 64,
                                                     dtype=torch.int8),
                    torch.ones(1, 64))
    with pytest.raises(ValueError):
        tk.group_quantize(torch.zeros(192, 64), group_size=128)
