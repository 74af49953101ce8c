"""The port's cost model and (P1) solvers against the JAX reference's.

The reference's cost model imports jax.numpy but computes in Python float64
arithmetic, as the port's does, so every number agrees to the last digits:
discrete choices (b̂, feasibility) are equal and f, f̃, delay, energy and
the objective agree at rtol = 1e-12.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools

import numpy as np
import pytest

from repro.core import baselines as jbl
from repro.core import codesign as jcd
from repro.core import cost_model as jcm
from repro_torch.core import baselines as tbl
from repro_torch.core import codesign as tcd
from repro_torch.core import cost_model as tcm

RTOL = 1e-12
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
LINK = dict(SYSP, emb_bytes_full=4.0e5, link_bps=2.0e6, tx_power_w=0.25)
GRID = list(itertools.product([0.4, 1.1, 3.5], [0.3, 1.5, 4.0]))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.b_hat, a.feasible, a.iterations) == \
        (b.b_hat, b.feasible, b.iterations)
    for f in ("f", "f_server", "objective", "d_upper", "d_lower", "delay",
              "energy"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL)


@pytest.mark.parametrize("sysp", [SYSP, LINK], ids=["compute", "link"])
def test_cost_model_matches_reference(sysp):
    tp, jp = tcm.SystemParams(**sysp), jcm.SystemParams(**sysp)
    for b, f, fs in itertools.product([1, 4, 8, 16], [0.5e9, 2e9],
                                      [1e9, 10e9]):
        for name in ("total_delay", "total_energy"):
            np.testing.assert_allclose(
                float(getattr(tcm, name)(b, f, fs, tp, b_emb=8)),
                float(getattr(jcm, name)(b, f, fs, jp, b_emb=8)), rtol=RTOL)


@pytest.mark.parametrize("sysp", [SYSP, LINK], ids=["compute", "link"])
@pytest.mark.parametrize("t0,e0", GRID)
def test_solvers_match_reference(sysp, t0, e0):
    tp, jp = tcm.SystemParams(**sysp), jcm.SystemParams(**sysp)
    lam = 23.7
    _same(tcd.solve_sca(lam, tp, t0, e0, b_emb=8),
          jcd.solve_sca(lam, jp, t0, e0, b_emb=8))
    _same(tcd.solve_oracle(lam, tp, t0, e0, b_emb=8),
          jcd.solve_oracle(lam, jp, t0, e0, b_emb=8))
    _same(tbl.solve_fixed_frequency(lam, tp, t0, e0),
          jbl.solve_fixed_frequency(lam, jp, t0, e0))


def test_ppo_baseline_matches_reference():
    tp, jp = tcm.SystemParams(**SYSP), jcm.SystemParams(**SYSP)
    _same(tbl.solve_ppo(23.7, tp, 1.1, 1.5, iters=40),
          jbl.solve_ppo(23.7, jp, 1.1, 1.5, iters=40))


@pytest.mark.parametrize("b", [1.0, 2.5, 4.0, 8.0, 16.0])
def test_distortion_gap_matches_reference(b):
    assert tcd.distortion_gap(b, 11.0) == jcd.distortion_gap(b, 11.0)
