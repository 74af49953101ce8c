"""The row-independent GEMM (``kernels.row_gemm``) on the CPU: its plain
version, its schedule, and the decode step it carries, against the JAX
reference.

* The decode step's logits, every projection and the tied head through
  ``layers.row_matmul`` (the plain version here), agree with the JAX
  reference's ``decode_step_q`` within rtol = atol = 1e-4 (the forward's
  tolerance) at B = 1, 3 and 4 from the same quantized cache state.
* Each row of ``row_gemm(x[:M], w)`` is bitwise the row computed alone at
  M = 1..8, for a row-major w and for the transposed view of the tied
  embedding, and the product agrees with a float64 one within 1e-5 of its
  scale.
* ``row_matmul`` on a [B, 1, K] activation is bitwise the per-leading-row
  loop the decode step used before.
* ``schedule`` (the kernel's split of K) covers K exactly, gives every
  warp whole 4-aligned slices, fills about two blocks per SM at the
  decode shapes, and is a function of (K, N) alone.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels.quantize import kv_quantize as jkv_quantize
from repro.models.registry import build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref, row_gemm
from repro_torch.models import layers as L
from repro_torch.models.lm import DecoderLM

# the module (the package's name ``row_gemm`` is the wrapper function)
rg_mod = importlib.import_module("repro_torch.kernels.row_gemm")

TOL4 = dict(rtol=1e-4, atol=1e-4)
# (K, N) of the decode step's products at qwen2-0.5b's full width
DECODE_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                 (896, 151936)]


@pytest.fixture(scope="module")
def qwen():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, DecoderLM(get_smoke("qwen2-0.5b")), tparams


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("b", [1, 3, 4])
@pytest.mark.parametrize("b_kv", [8, 16])
def test_decode_step_logits_match_reference(qwen, b, b_kv):
    jmodel, jparams, tmodel, tparams = qwen
    rng = np.random.default_rng(10 * b + b_kv)
    toks = rng.integers(0, 512, (b, 16)).astype(np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    k, v = jc["k"], jc["v"]
    if b_kv < 16:
        (kq, ks), (vq, vs) = (jax.jit(jkv_quantize, static_argnums=1)(
            a, b_kv) for a in (k, v))
    else:
        kq, vq = k, v
        ks = vs = jnp.ones(k.shape[:-1], jnp.float32)
    pad = [(0, 0), (0, 0), (0, 16), (0, 0), (0, 0)]
    state = {"k_codes": jnp.pad(kq, pad), "v_codes": jnp.pad(vq, pad),
             "k_scales": jnp.pad(ks, pad[:-1], constant_values=1.0),
             "v_scales": jnp.pad(vs, pad[:-1], constant_values=1.0)}
    pos = rng.integers(4, 17, (b,)).astype(np.int32)
    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    step = jax.jit(lambda p, c, bt: jmodel.decode_step_q(p, c, bt,
                                                         b_kv=b_kv))
    want, _ = step(jparams, {**state, "len": jnp.asarray(pos)},
                   {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    tstate = {n: torch.from_numpy(np.array(a)) for n, a in state.items()}
    got, _ = tmodel.decode_step_q(
        tparams, {**tstate, "len": torch.from_numpy(pos)},
        {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)},
        b_kv=b_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_rows_are_bitwise_alone(m, transposed):
    k, n = 96, 200
    x = _normal(m, (8, k))
    w = _normal(100 + m, (n, k)).T if transposed else _normal(m, (k, n))
    y = row_gemm(x[:m], w)
    assert y.shape == (m, n) and y.dtype == torch.float32
    for i in range(m):
        assert torch.equal(y[i], row_gemm(x[i:i + 1], w)[0])
    want = x[:m].double().numpy() @ w.double().numpy()
    np.testing.assert_allclose(y.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()),
                               rtol=0)


def test_row_matmul_equals_the_per_row_loop():
    x = _normal(0, (4, 1, 64))
    for w in (_normal(1, (64, 48)), _normal(2, (80, 64)).T):
        old = torch.cat([x[i:i + 1] @ w for i in range(x.shape[0])])
        assert torch.equal(L.row_matmul(x, w), old)
    assert torch.equal(ref.row_gemm_ref(x[:0, 0], w),
                       torch.zeros((0, w.shape[1])))


@pytest.mark.parametrize("k,n", DECODE_SHAPES + [(7, 8), (64, 4), (100, 12),
                                                 (20000, 128)])
def test_schedule_covers_k_from_k_and_n_alone(k, n):
    assert list(inspect.signature(rg_mod.schedule).parameters) == ["k", "n"]
    chunk, splits = rg_mod.schedule(k, n)
    assert chunk % rg_mod.WARPS == 0 and chunk > 0
    assert (splits - 1) * chunk < k <= splits * chunk
    tiles = -(-n // rg_mod.TILE_N)
    if k >= rg_mod.WARPS * rg_mod.MIN_PER_WARP * 2:
        assert chunk // rg_mod.WARPS >= rg_mod.MIN_PER_WARP
    if (k, n) in DECODE_SHAPES[:4]:
        # the decode projections: about two blocks per SM, or every chunk
        # at its smallest
        assert tiles * splits >= rg_mod.TARGET_BLOCKS \
            or chunk == rg_mod.WARPS * rg_mod.MIN_PER_WARP


def test_bad_shapes_raise():
    x = _normal(0, (2, 8))
    with pytest.raises(ValueError):
        row_gemm(x, _normal(1, (9, 4)))
    with pytest.raises(ValueError):
        row_gemm(x[0], _normal(1, (8, 4)))
