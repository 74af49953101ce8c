"""The recurrent cells of ``repro_torch.models.ssm`` (Mamba-2, mLSTM,
sLSTM) against the JAX reference's, on the CPU, at the smoke configs'
widths (jamba's for Mamba, xlstm-350m's for the xLSTM cells).

The reference's parameters cross through ``repro_torch.bridge``; inputs
come from a numpy seed.  Forward at several chunk sizes and a length off
the chunk grid, and the decode step carried over several tokens, agree at
rtol 1e-4, atol 1e-5 x max(1, max|ref|) (float32 sums in another order;
an mLSTM output divides by the cell's normalizer, so its rounding scales
with the largest output, not with each element).  Port on port, the
token-by-token decode equals the chunked forward at the reference's own
2e-3 (``tests/test_models.py``).  The gradients stay finite where a
chunk's decay differences overflow float32 (the reference's Mamba
gradient is NaN there: ROADMAP C.7(e)) and equal the reference's at a
chunk size where its own is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import ssm as JS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import ssm as S

RTOL, ATOL = 1e-4, 1e-5
STEP_TOL = dict(rtol=2e-3, atol=2e-3)    # the reference's decode == forward


def assert_close(got, want, err_msg=""):
    """rtol 1e-4, atol 1e-5 x max(1, max|want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=err_msg)


# cell: (arch of the widths, init, forward, chunked, init_state, step)
CELLS = {"mamba": ("jamba-1.5-large-398b", "init_mamba", "mamba_forward",
                   True, "mamba_init_state", "mamba_decode_step"),
         "mlstm": ("xlstm-350m", "init_mlstm", "mlstm_forward", True,
                   "mlstm_init_state", "mlstm_decode_step"),
         "slstm": ("xlstm-350m", "init_slstm", "slstm_forward", False,
                   "slstm_init_state", "slstm_decode_step")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The cells' ops are too small to share among threads, and the suite
    runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell(request):
    name = request.param
    arch, init, *_ = CELLS[name]
    jcfg = jget_smoke(arch)
    jp, _ = getattr(JS, init)(jcfg, jax.random.PRNGKey(len(name)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return name, jcfg, jp, get_smoke(arch), tp


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s,chunk", [(37, 8), (37, 16), (37, 256),
                                     (64, 16)])
def test_forward_matches_reference(cell, s, chunk):
    """The full-sequence forward at chunk sizes on and off the length's
    grid (37: a padded last chunk; 256: one chunk); the sLSTM has no
    chunks and runs the same lengths."""
    name, jcfg, jp, cfg, tp = cell
    _, _, fwd, chunked, _, _ = CELLS[name]
    x = _x(s + chunk, 2, s, cfg.d_model)
    kw = {"chunk": chunk} if chunked else {}
    want = getattr(JS, fwd)(jcfg, jp, jnp.asarray(x), **kw)
    got = getattr(S, fwd)(cfg, tp, torch.from_numpy(x), **kw)
    assert got.shape == (2, s, cfg.d_model)
    assert_close(got.numpy(), want)


def test_decode_step_matches_reference(cell):
    """Eight tokens decoded from the zero state, each side carrying its
    own state: every output and every state leaf at each step."""
    name, jcfg, jp, cfg, tp = cell
    _, _, _, _, init_state, step = CELLS[name]
    x = _x(5, 3, 8, cfg.d_model)
    jst = getattr(JS, init_state)(jcfg, 3)
    tst = getattr(S, init_state)(cfg, 3)
    assert sorted(tst) == sorted(jst)
    for t in range(8):
        jy, jst = getattr(JS, step)(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                    jst)
        ty, tst = getattr(S, step)(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                   tst)
        assert_close(ty.numpy(), jy, f"step {t}")
        for k in jst:
            assert_close(tst[k].numpy(), jst[k], f"step {t} state {k}")


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 5)])
def test_decode_equals_chunked_forward(cell, s, chunk):
    """Port on port: the recurrence token by token == the chunked
    forward over the same inputs, at the reference's 2e-3."""
    name, _, _, cfg, tp = cell
    _, _, fwd, chunked, init_state, step = CELLS[name]
    x = torch.from_numpy(_x(s, 2, s, cfg.d_model))
    kw = {"chunk": chunk} if chunked else {}
    y_par = getattr(S, fwd)(cfg, tp, x, **kw)
    state = getattr(S, init_state)(cfg, 2)
    ys = []
    for t in range(s):
        y, state = getattr(S, step)(cfg, tp, x[:, t:t + 1], state)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_par.numpy(),
                               **STEP_TOL)


@pytest.mark.parametrize("name", ["mamba", "mlstm"])
def test_gradients_finite_past_exp_overflow(name):
    """A 300-token chunk of 256 puts decay differences past float32's
    exp range in the masked triangle.  The port masks the exponent, so its
    gradients (parameters and input) are finite, and they equal the
    reference's at chunk 32 (the same function; the reference's own
    gradient at chunk 256 is NaN for Mamba, ROADMAP C.7(e)) within 1e-4
    of each leaf's scale."""
    arch, init, fwd, *_ = CELLS[name]
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jp, _ = getattr(JS, init)(jcfg, jax.random.PRNGKey(2))
    x = _x(7, 1, 300, cfg.d_model)
    want_p, want_x = jax.grad(
        lambda p, xx: getattr(JS, fwd)(jcfg, p, xx, chunk=32).sum(),
        argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    getattr(S, fwd)(cfg, tp, xt, chunk=256).sum().backward()
    pairs = [(xt.grad, want_x)] + [(tp[k].grad, want_p[k]) for k in tp]
    for got, want in pairs:
        want = np.asarray(want)
        assert bool(torch.isfinite(got).all())
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


def test_init_matches_reference_shapes_and_axes(cell):
    """``init_*`` draws the reference's leaves (shapes, dtypes, the
    constant ones' values) and axes, stacked over (2, 3) leading sizes
    as the hybrid and xLSTM models stack them."""
    name, jcfg, jp, cfg, _ = cell
    init = CELLS[name][1]
    p, ax = getattr(S, init)(cfg, torch.Generator().manual_seed(0),
                             layers=(2, 3))
    jp3, jax3 = getattr(JS, init)(jcfg, jax.random.PRNGKey(0), layers=3)
    _, meta_ax = getattr(S, init)(cfg, None, layers=3, device="meta")
    assert meta_ax == jax3 and ax == jax3
    assert sorted(p) == sorted(jp)
    for k in p:
        assert tuple(p[k].shape) == (2,) + tuple(jp3[k].shape), k
        assert str(p[k].dtype) == f"torch.{jp3[k].dtype}", k
    for k in ("conv_x", "A_log", "D", "dt_bias", "norm", "b_i", "b_f", "b"):
        if k in p:
            np.testing.assert_array_equal(p[k][0].numpy(),
                                          np.asarray(jp3[k]), err_msg=k)
