"""The port's rate-distortion bounds and Blahut-Arimoto against the JAX
reference's (paper §IV, Props. 4.1/4.2, Fig. 4), then the reference's own
properties (``tests/test_rate_distortion.py``) on the port.

Both compute in float32: the closed forms agree at rtol = 1e-6 over a
grid of lam, rate and distortion.  Blahut-Arimoto runs every multiplier
in one batched torch loop where the reference runs one jitted scan per
multiplier, so sums run in another order.  Its rates agree at rtol =
1e-4 with atol = 1e-6 bits (measured worst: 7.6e-8 bits absolute at a
rate of 1.7e-4 bits, 4.3e-4 relative, a sum of terms near 0; elsewhere
below 1e-6 relative), its distortions at rtol = 1e-4 with atol = 1e-30
(below ~1e-30 the joint's products underflow into float32's subnormals
in both, 1.3e-36 vs 1.7e-36 at the largest multiplier; elsewhere the
worst is 1e-6 relative).  At small multipliers the output marginal
underflows to 0 in places and the reference's rate is 0 * -inf = NaN;
the port keeps that arithmetic (nothing is clamped that the reference
does not clamp), and where the underflow starts differs by one or two
multipliers, so the port is NaN only where the reference is.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import rate_distortion as jrd
from repro_torch.core import rate_distortion as trd

RTOL = 1e-6
LAMS = [0.5, 3.0, 20.0, 55.0, 400.0]
RATES = [0.0, 1e-9, 0.25, 1.0, 3.0, 7.0, 12.0]


def _f(x):
    return float(np.asarray(x))


@pytest.mark.parametrize("lam", LAMS)
def test_rate_bounds_match_reference(lam):
    for r in RATES:
        for name in ("distortion_lower_bound", "distortion_upper_bound"):
            np.testing.assert_allclose(
                _f(getattr(trd, name)(r, lam)),
                _f(getattr(jrd, name)(r, lam)), rtol=RTOL, err_msg=name)
    for b in (1.0, 2.0, 4.0, 8.0, 16.0):
        np.testing.assert_allclose(_f(trd.codesign_objective(b, lam)),
                                   _f(jrd.codesign_objective(b, lam)),
                                   rtol=RTOL)
    for d in (1e-6, 1e-3, 0.1, 0.49):
        dd = d / lam
        for name in ("rate_lower_bound", "rate_upper_bound"):
            np.testing.assert_allclose(
                _f(getattr(trd, name)(dd, lam)),
                _f(getattr(jrd, name)(dd, lam)), rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(_f(trd.exponential_entropy(lam)),
                               _f(jrd.exponential_entropy(lam)), rtol=RTOL)


def test_bounds_take_tensors_as_the_reference_takes_arrays():
    lam = np.asarray([2.0, 30.0], np.float32)
    rate = np.asarray([0.5, 6.0], np.float32)
    for name in ("distortion_lower_bound", "distortion_upper_bound",
                 "codesign_objective"):
        np.testing.assert_allclose(
            getattr(trd, name)(torch.from_numpy(rate),
                               torch.from_numpy(lam)).numpy(),
            np.asarray(getattr(jrd, name)(jnp.asarray(rate),
                                          jnp.asarray(lam))), rtol=RTOL)


def test_exponential_mle_matches_reference():
    rng = np.random.default_rng(0)
    for lam in (0.5, 3.0, 40.0):
        sample = rng.exponential(1.0 / lam, size=200_000).astype(np.float32)
        np.testing.assert_allclose(
            float(trd.exponential_mle(torch.from_numpy(sample))),
            float(jrd.exponential_mle(jnp.asarray(sample))), rtol=1e-5)
    zero = np.zeros(8, np.float32)
    assert float(trd.exponential_mle(torch.from_numpy(zero))) == \
        float(jrd.exponential_mle(jnp.asarray(zero)))


@pytest.mark.parametrize("lam,kw", [
    (20.0, dict(n_source=192, n_repro=192, n_iters=150)),
    (55.0, dict(n_source=128, n_repro=160, n_iters=120)),
])
def test_blahut_arimoto_matches_reference(lam, kw):
    want = jrd.blahut_arimoto_distortion_rate(lam, **kw)
    got = trd.blahut_arimoto_distortion_rate(lam, device="cpu", **kw)
    np.testing.assert_array_equal(got.betas, want.betas)
    nan_got, nan_want = np.isnan(got.rates), np.isnan(want.rates)
    assert not (nan_got & ~nan_want).any(), (nan_got, nan_want)
    both = ~nan_got & ~nan_want
    assert both.sum() >= 16, both.sum()
    np.testing.assert_allclose(got.rates[both], want.rates[both], rtol=1e-4,
                               atol=1e-6)
    assert np.isfinite(got.distortions).all()
    np.testing.assert_allclose(got.distortions, want.distortions, rtol=1e-4,
                               atol=1e-30)


def test_blahut_arimoto_custom_betas_match_reference():
    betas = np.asarray([1.0, 10.0, 100.0, 1000.0])
    want = jrd.blahut_arimoto_distortion_rate(8.0, n_source=96, n_repro=96,
                                              betas=betas, n_iters=80)
    got = trd.blahut_arimoto_distortion_rate(8.0, n_source=96, n_repro=96,
                                             betas=betas, n_iters=80,
                                             device="cpu")
    assert np.isfinite(want.rates).all() and np.isfinite(got.rates).all()
    np.testing.assert_allclose(got.rates, want.rates, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.distortions, want.distortions, rtol=1e-4)


# ---------------------------------------------------------------------------
# the reference's own properties, on the port
# ---------------------------------------------------------------------------

def test_entropy_closed_form():
    assert float(trd.exponential_entropy(1.0)) == pytest.approx(
        np.log2(np.e), rel=1e-6)
    assert float(trd.exponential_entropy(2.0)) == pytest.approx(
        np.log2(np.e / 2), rel=1e-6)


def test_mle_recovers_lambda():
    rng = np.random.default_rng(0)
    for lam in (0.5, 3.0, 40.0):
        sample = rng.exponential(1.0 / lam, size=200_000)
        assert float(trd.exponential_mle(torch.from_numpy(sample))) == \
            pytest.approx(lam, rel=0.02)


@pytest.mark.parametrize("lam,rate", list(itertools.product(
    [0.1, 2.0, 45.0, 500.0], [0.25, 1.5, 6.0, 12.0])))
def test_bounds_ordering(lam, rate):
    """D^L(R) <= D^U(R) (Props. 4.1 vs 4.2)."""
    dl = float(trd.distortion_lower_bound(rate, lam))
    du = float(trd.distortion_upper_bound(rate, lam))
    assert 0 < dl <= du * (1 + 1e-6)


@settings(max_examples=40, deadline=None)
@given(lam=st.floats(0.1, 500.0), d=st.floats(1e-6, 0.49))
def test_prop_rate_bounds_consistent(lam, d):
    """R^L and D^L are inverses; so are the upper pair (f32 slack)."""
    dd = d / lam
    rl = float(trd.rate_lower_bound(dd, lam))
    assert float(trd.distortion_lower_bound(rl, lam)) == \
        pytest.approx(dd, rel=1e-4)
    ru = float(trd.rate_upper_bound(dd, lam))
    assert float(trd.distortion_upper_bound(ru, lam)) == \
        pytest.approx(dd, rel=2e-2)


def test_upper_bound_large_but_finite_near_rate_zero():
    du = float(trd.distortion_upper_bound(1e-6, 5.0))
    assert math.isfinite(du) and du > 100.0


def test_bounds_decay_and_converge():
    """Both bounds fall in R and their gap closes (paper Fig. 4)."""
    lam = 30.0
    rates = np.linspace(1.0, 10.0, 19)
    dl = np.array([float(trd.distortion_lower_bound(r, lam)) for r in rates])
    du = np.array([float(trd.distortion_upper_bound(r, lam)) for r in rates])
    assert np.all(np.diff(dl) < 0) and np.all(np.diff(du) < 0)
    gap = du - dl
    assert gap[-1] < gap[0] * 0.02


def test_blahut_arimoto_between_bounds():
    """The numerical D(R) sits in [D^L, D^U] (10 % discretization slack)
    in the rate window where the discretized source stands in for the
    continuous one (paper Fig. 4)."""
    lam = 20.0
    res = trd.blahut_arimoto_distortion_rate(lam, n_source=192, n_repro=192,
                                             n_iters=150, device="cpu")
    mask = (res.rates > 0.5) & (res.rates < 3.5)
    assert mask.sum() >= 5
    for r, d in zip(res.rates[mask], res.distortions[mask]):
        assert d >= float(trd.distortion_lower_bound(r, lam)) * 0.90
        assert d <= float(trd.distortion_upper_bound(r, lam)) * 1.10


def test_blahut_arimoto_monotone():
    res = trd.blahut_arimoto_distortion_rate(20.0, n_source=128, n_repro=128,
                                             n_iters=100, device="cpu")
    mask = (res.rates > 0.25) & (res.rates < 3.5)
    d_sorted = res.distortions[mask][np.argsort(res.rates[mask])]
    assert np.all(np.diff(d_sorted) <= 1e-4)


def test_lambda_scaling_insight():
    """Remark 4.1: a larger lam gives less distortion at the same rate."""
    for r in (2.0, 4.0, 6.0):
        assert float(trd.distortion_upper_bound(r, 50.0)) < \
            float(trd.distortion_upper_bound(r, 5.0))


def test_blahut_arimoto_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trd.blahut_arimoto_distortion_rate(20.0, n_source=16, n_repro=16,
                                           n_iters=2)
