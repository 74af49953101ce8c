"""The port's output-distortion theory (paper §III, Prop. 3.1, Fig. 3)
against the JAX reference's, then the reference's own properties
(``tests/test_distortion.py``) on the port.

The paper's FC-DNN-16 at its published dims (784 -> ... -> 784, 17
widths, 16 matrices) is initialized by the reference and crossed over
through the bridge; both packages then run on the same weights and, for the
quantized side, on the same quantized weights (made by the reference's
quantizer).  Induced norms, chain coefficients, the chain bound,
``param_distortion`` and the measured output distortion agree at rtol =
1e-5 (float32 sums and products in another order), the gradient-norm
constant H at rtol = 1e-4 (per-example gradients through ``torch.func``
against the reference's ``jax.vmap(jax.grad)``).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import distortion as jd
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.quantization import quantize_dequantize as jqdq
from repro.models import fcdnn as jfc
from repro_torch.bridge import params_from_jax
from repro_torch.core import distortion as td
from repro_torch.core.quantization import QuantConfig, quantize_dequantize
from repro_torch.models import fcdnn as tfc

TOL = dict(rtol=1e-5)


def _cross(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _f(x):
    return float(np.asarray(x))


def _jquant(ws, bits, scheme="uniform"):
    cfg = JQuantConfig(bits=bits, scheme=scheme, granularity="per-tensor")
    return [jqdq(w, cfg) for w in ws]


def _tquant(ws, bits, scheme="uniform"):
    cfg = QuantConfig(bits=bits, scheme=scheme, granularity="per-tensor")
    return [quantize_dequantize(w, cfg) for w in ws]


@pytest.fixture(scope="module")
def fcdnn16():
    """The reference's FC-DNN-16 at its published dims, its inputs on the
    unit L1 ball (Assumption 1), and both crossed to the port."""
    ws = jfc.init_fcdnn(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (16, jfc.layer_dims()[0]))
    x = x / jnp.sum(jnp.abs(x), axis=-1, keepdims=True)
    return ws, x, _cross(ws), torch.from_numpy(np.array(x))


def test_fcdnn16_dims_and_forward_match_reference(fcdnn16):
    ws, x, tws, tx = fcdnn16
    assert tfc.layer_dims() == jfc.layer_dims()
    assert len(tws) == len(tfc.layer_dims()) - 1 == 16
    assert [tuple(w.shape) for w in tws] == [w.shape for w in ws]
    np.testing.assert_allclose(tfc.apply_fcdnn(tws, tx).numpy(),
                               np.asarray(jfc.apply_fcdnn(ws, x)), **TOL,
                               atol=1e-7)
    np.testing.assert_allclose(float(tfc.mse_loss(tws, tx)),
                               _f(jfc.mse_loss(ws, x)), **TOL)


def test_init_fcdnn_draws_from_its_generator():
    a = tfc.init_fcdnn(torch.Generator().manual_seed(3), [8, 6, 4])
    b = tfc.init_fcdnn(torch.Generator().manual_seed(3), [8, 6, 4])
    assert [tuple(w.shape) for w in a] == [(6, 8), (4, 6)]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # He-style scale 0.5 * sqrt(2 / d_in)
    big = tfc.init_fcdnn(torch.Generator().manual_seed(0), [400, 400])[0]
    assert float(big.std()) == pytest.approx(0.5 * (2.0 / 400) ** 0.5,
                                             rel=0.02)


def test_induced_norms_match_reference(fcdnn16):
    ws, _, tws, _ = fcdnn16
    for w, tw in zip(ws, tws):
        np.testing.assert_allclose(float(td.induced_l1_norm(tw)),
                                   _f(jd.induced_l1_norm(w)), **TOL)
    # more than two dims read as [out, in*]
    w3 = np.random.default_rng(0).standard_normal((5, 3, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(td.induced_l1_norm(torch.from_numpy(w3))),
        _f(jd.induced_l1_norm(jnp.asarray(w3))), **TOL)


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("scheme", ["uniform", "pot-log"])
def test_chain_bound_matches_reference(fcdnn16, bits, scheme):
    ws, x, tws, tx = fcdnn16
    ws_hat = _jquant(ws, bits, scheme)
    tws_hat = _cross(ws_hat)
    taus = [jd.induced_l1_norm(w - wh) for w, wh in zip(ws, ws_hat)]
    ttaus = [td.induced_l1_norm(w - wh) for w, wh in zip(tws, tws_hat)]
    for a, b in zip(td.chain_bound_coefficients(tws, ttaus),
                    jd.chain_bound_coefficients(ws, taus)):
        np.testing.assert_allclose(float(a), _f(b), **TOL)
    np.testing.assert_allclose(float(td.fc_chain_bound(tws, tws_hat)),
                               _f(jd.fc_chain_bound(ws, ws_hat)), **TOL)
    np.testing.assert_allclose(float(td.param_distortion(tws, tws_hat)),
                               _f(jd.param_distortion(ws, ws_hat)), **TOL)
    np.testing.assert_allclose(
        float(td.measured_output_distortion(tfc.apply_fcdnn, tws, tws_hat,
                                            tx)),
        _f(jd.measured_output_distortion(jfc.apply_fcdnn, ws, ws_hat, x)),
        **TOL)
    # and the port's own per-tensor quantizer gives the reference's
    # weights: bitwise on the uniform codebook; on pot-log the codepoint
    # index is round(log2(amax/|w|)) from two libraries' log2, so a weight
    # within an ulp of a rounding tie can land on the neighbouring
    # codepoint (a factor of 2), in at most 1e-4 of the weights
    for a, b in zip(_tquant(tws, bits, scheme), tws_hat):
        if scheme == "uniform":
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            continue
        near = torch.isclose(a, b, rtol=1e-6, atol=0)
        far = ~near
        assert int(far.sum()) <= 1e-4 * a.numel()
        ratio = (a[far] / b[far]).abs()
        assert bool(((ratio == 2.0) | (ratio == 0.5)).all()), ratio


def test_param_distortion_over_a_dict_matches_reference():
    rng = np.random.default_rng(1)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"v": rng.standard_normal(5).astype(np.float32)}}
    b = jax.tree_util.tree_map(lambda t: t * np.float32(0.9), a)
    np.testing.assert_allclose(
        float(td.param_distortion(_cross(a), _cross(b))),
        _f(jd.param_distortion(a, b)), **TOL)
    assert float(td.elementwise_l1(torch.ones(3), torch.zeros(3))) == 3.0
    assert float(td.param_distortion({}, {})) == 0.0


def test_grad_norm_H_and_taylor_bound_match_reference():
    dims = [24, 16, 12, 24]
    ws = jfc.init_fcdnn(jax.random.PRNGKey(4), dims)
    xs = jax.random.normal(jax.random.PRNGKey(5), (8, dims[0]))
    xs = xs / jnp.sum(jnp.abs(xs), axis=-1, keepdims=True)
    tws, txs = _cross(ws), torch.from_numpy(np.array(xs))
    h = td.estimate_grad_norm_H(tfc.apply_fcdnn, tws, txs)
    jh = jd.estimate_grad_norm_H(jfc.apply_fcdnn, ws, xs)
    np.testing.assert_allclose(float(h), _f(jh), rtol=1e-4)
    ws_hat = _jquant(ws, 10)
    np.testing.assert_allclose(
        float(td.taylor_surrogate_bound(h, tws, _cross(ws_hat))),
        _f(jd.taylor_surrogate_bound(jh, ws, ws_hat)), rtol=1e-4)


def test_grad_norm_H_over_a_dict_tree():
    """A dict parameter tree (sorted-key leaves) gives the same H as the
    same matrices in a list."""
    ws = tfc.init_fcdnn(torch.Generator().manual_seed(6), [10, 8, 10])
    xs = torch.randn((5, 10), generator=torch.Generator().manual_seed(7))

    def apply_dict(p, x):
        return tfc.apply_fcdnn([p["a"], p["b"]], x)

    h_list = td.estimate_grad_norm_H(tfc.apply_fcdnn, ws, xs)
    h_dict = td.estimate_grad_norm_H(apply_dict, {"a": ws[0], "b": ws[1]},
                                     xs)
    assert float(h_list) == float(h_dict)


# ---------------------------------------------------------------------------
# the reference's own properties, on the port
# ---------------------------------------------------------------------------

def test_induced_l1_norm_definition():
    w = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    assert float(td.induced_l1_norm(w)) == pytest.approx(4.0)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_prop_induced_norm_submultiplicative(seed):
    g = torch.Generator().manual_seed(seed)
    a, b = torch.randn((8, 6), generator=g), torch.randn((6, 5), generator=g)
    assert float(td.induced_l1_norm(a @ b)) <= \
        float(td.induced_l1_norm(a)) * float(td.induced_l1_norm(b)) \
        * (1 + 1e-5)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_prop_operator_bound_holds(seed):
    """||Wx||_1 <= ||W||_1 ||x||_1: the proof's key step."""
    g = torch.Generator().manual_seed(seed)
    w, x = torch.randn((8, 6), generator=g), torch.randn(6, generator=g)
    assert float(torch.sum(torch.abs(w @ x))) <= \
        float(td.induced_l1_norm(w)) * float(torch.sum(torch.abs(x))) \
        * (1 + 1e-5)


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("scheme", ["uniform", "pot-log"])
def test_prop31_chain_bound_upper_bounds_output(bits, scheme):
    """Proposition 3.1 on the FC-DNN family (reduced widths)."""
    dims = [32, 24, 16, 24, 16, 32]
    ws = tfc.init_fcdnn(torch.Generator().manual_seed(0), dims)
    ws_hat = _tquant(ws, bits, scheme)
    x = torch.randn((16, dims[0]), generator=torch.Generator().manual_seed(1))
    x = x / torch.sum(torch.abs(x), dim=-1, keepdim=True)
    out, out_hat = tfc.apply_fcdnn(ws, x), tfc.apply_fcdnn(ws_hat, x)
    measured = float(torch.max(torch.sum(torch.abs(out - out_hat), dim=-1)))
    bound = float(td.fc_chain_bound(ws, ws_hat))
    assert measured <= bound * (1 + 1e-5), (measured, bound)


def test_prop31_bound_tightens_with_bits():
    ws = tfc.init_fcdnn(torch.Generator().manual_seed(2), [32, 24, 16, 24,
                                                            32])
    prev = np.inf
    for bits in (3, 5, 7, 9):
        b = float(td.fc_chain_bound(ws, _tquant(ws, bits)))
        assert b <= prev * (1 + 1e-6)
        prev = b


def test_chain_coefficients_independent_of_quantized_weights():
    """Remark 3.1: A^(l) depends only on W and tau, not on W_hat."""
    ws = tfc.init_fcdnn(torch.Generator().manual_seed(3), [16, 12, 8, 16])
    taus = [torch.tensor(0.1)] * len(ws)
    c1 = td.chain_bound_coefficients(ws, taus)
    c2 = td.chain_bound_coefficients(ws, taus)
    assert [float(a) for a in c1] == [float(b) for b in c2]
    assert all(float(c) > 0 for c in c1)


def test_param_distortion_is_l1():
    a = {"w": torch.tensor([1.0, -1.0]), "v": torch.tensor([[2.0]])}
    b = {"w": torch.tensor([0.0, 1.0]), "v": torch.tensor([[0.0]])}
    assert float(td.param_distortion(a, b)) == pytest.approx(5.0)


def test_taylor_surrogate_tracks_measured():
    """Eq. (17): H ||W - W_hat||_1 upper-bounds the measured distortion
    for small perturbations (the first-order regime)."""
    dims = [24, 16, 12, 24]
    ws = tfc.init_fcdnn(torch.Generator().manual_seed(4), dims)
    xs = torch.randn((8, dims[0]), generator=torch.Generator().manual_seed(5))
    xs = xs / torch.sum(torch.abs(xs), dim=-1, keepdim=True)
    h = td.estimate_grad_norm_H(tfc.apply_fcdnn, ws, xs)
    ws_hat = _tquant(ws, 10)
    measured = float(td.measured_output_distortion(tfc.apply_fcdnn, ws,
                                                   ws_hat, xs))
    bound = float(td.taylor_surrogate_bound(h, ws, ws_hat))
    assert measured <= bound * (1 + 1e-4), (measured, bound)
