"""The port's decode path against the JAX reference, on the CPU.

Inputs come from numpy seeds and the reference's own seeds (its smoke
model at ``PRNGKey(0)``, ``tests/test_decode.py``'s traffic); its
parameters cross through ``bridge.params_from_jax``.  The reference runs
as its tests run it: interpret-mode Pallas inside its AOT executables.

* ``prefill`` logits and K/V, and one ``decode_step_q`` from the same
  quantized cache state, agree within 1e-4 (the forward's tolerance).
* ``fit_kv_lambda`` agrees within 1e-5 relative (one f32 mean over the
  cache, summed in another order); ``solve_decode`` and
  ``CodesignCache.solve_decode`` give the same discrete solution, with
  objective, delay and energy within 1e-12.
* Greedy token streams: equal up to the first step whose top-2 logit
  margin in the reference's run is below 1e-4 (there float noise of the
  order of the logit tolerance may flip the argmax); the test counts the
  steps it compared.
* ``DecodeReport``'s counts equal the reference engine's on traffic
  pinned the same way; its modeled clock and energy agree within 1e-12
  relative.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import codesign as jcd
from repro.core.cost_model import SystemParams as JSystemParams
from repro.kernels.bucketing import seq_bucket
from repro.kernels.quantize import kv_quantize as jkv_quantize
from repro.models.registry import build_model
from repro.runtime import CompiledForwardCache
from repro.runtime import DecodeEngine as JDecodeEngine
from repro.runtime import QosClass as JQosClass
from repro.runtime import greedy_decode_reference as jgreedy
from repro.runtime.decode_engine import fit_kv_lambda as jfit_kv_lambda
from repro.runtime.serve_engine import CodesignCache as JCodesignCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import codesign as tcd
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (CodesignCache, DecodeEngine, QosClass,
                                 fit_kv_lambda, greedy_decode_reference)

TOL4 = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 3.5, 2.0)


@pytest.fixture(scope="module")
def qwen():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_smoke("qwen2-0.5b"))
    return jmodel, jparams, tmodel, _bridge(jparams)


@pytest.fixture(scope="module")
def jcache():
    return CompiledForwardCache()


def _bridge(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                           device="cpu")


def _ragged_traffic(cfg, n, seed, max_prompt=20, max_new=6):
    """``tests/test_decode.py``'s traffic generator."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(4, max_prompt + 1)))
        out.append((toks.astype(np.int32),
                    int(rng.integers(1, max_new + 1)), 0.05 * i))
    return out


def _quantized_state(jcache_kv, b_kv, t):
    """The reference's prefill cache, quantized at b_kv and padded to t."""
    k, v = jcache_kv
    if b_kv < 16:
        (kq, ks), (vq, vs) = (jax.jit(jkv_quantize, static_argnums=1)(a,
                                                                     b_kv)
                              for a in (k, v))
    else:
        kq, vq = k, v
        ks = vs = jnp.ones(k.shape[:-1], jnp.float32)
    pad = [(0, 0), (0, 0), (0, t - k.shape[2]), (0, 0), (0, 0)]
    return {"k_codes": jnp.pad(kq, pad), "v_codes": jnp.pad(vq, pad),
            "k_scales": jnp.pad(ks, pad[:-1], constant_values=1.0),
            "v_scales": jnp.pad(vs, pad[:-1], constant_values=1.0)}


def test_prefill_matches_reference(qwen):
    jmodel, jparams, tmodel, tparams = qwen
    toks = np.random.default_rng(0).integers(0, 512, (2, 32)).astype(
        np.int32)
    last = np.asarray([31, 12], np.int32)
    want, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                              last_index=jnp.asarray(last))
    got, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             last_index=torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL4)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("b_kv", [4, 8, 16])
def test_decode_step_q_matches_reference(qwen, b_kv):
    jmodel, jparams, tmodel, tparams = qwen
    rng = np.random.default_rng(b_kv)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    state = _quantized_state((jc["k"], jc["v"]), b_kv, 32)
    pos = np.asarray([16, 9], np.int32)       # row 1 overwrites position 9
    tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
    step = jax.jit(lambda p, c, b: jmodel.decode_step_q(p, c, b, b_kv=b_kv))
    want, jq = step(jparams, {**state, "len": jnp.asarray(pos)},
                    {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    got, tq = tmodel.decode_step_q(
        tparams, {**tstate, "len": torch.from_numpy(pos)},
        {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)},
        b_kv=b_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)
    np.testing.assert_array_equal(tq["len"].numpy(), np.asarray(jq["len"]))
    # the fresh entries went where the reference wrote them
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(tq[name].numpy(), np.asarray(jq[name]),
                                   **TOL4)


def test_plain_decode_step_matches_reference(qwen):
    """The full-precision cache step (``decode_step`` over
    ``layers.decode_attention``) from the same prefill state."""
    jmodel, jparams, tmodel, tparams = qwen
    toks = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(
        np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    pad = [(0, 0), (0, 0), (0, 16), (0, 0), (0, 0)]
    cache = {"k": jnp.pad(jc["k"], pad), "v": jnp.pad(jc["v"], pad),
             "len": jc["len"]}
    batch = {"token": np.asarray([[7], [11]], np.int32),
             "pos": np.asarray([16, 3], np.int32)}
    want, jnew = jmodel.decode_step(jparams, cache,
                                    jax.tree_util.tree_map(jnp.asarray,
                                                           batch))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    got, tnew = tmodel.decode_step(
        tparams, tcache, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)
    np.testing.assert_allclose(tnew["k"].numpy(), np.asarray(jnew["k"]),
                               **TOL4)
    np.testing.assert_array_equal(tnew["len"].numpy(),
                                  np.asarray(jnew["len"]))
    init = tmodel.init_cache(2, 32)
    assert init["k"].shape == jmodel.init_cache(2, 32)["k"].shape
    assert tmodel.cache_axes() == jmodel.cache_axes()


def test_fit_kv_lambda_matches_reference(qwen):
    jmodel, jparams, tmodel, tparams = qwen
    np.testing.assert_allclose(fit_kv_lambda(tmodel, tparams),
                               jfit_kv_lambda(jmodel, jparams), rtol=1e-5)


def _kv_sysp(cls, kv_full):
    return cls(**SYSP, kv_bytes_full=kv_full, kv_bw_bps=kv_full,
               kv_power_w=2.0)


# budgets whose solutions land on every rung of the ladder, and one that
# no rung can meet
@pytest.mark.parametrize("t0,e0", [(2.0, 1.2), (2.0, 1.5), (3.5, 2.0),
                                   (2.0, 6.0), (3.0, 3.0), (0.4, 0.3)])
def test_solve_decode_matches_reference(t0, e0):
    kv_full = 2.0 * 4 * 4 * 80 * 2 * 16 * 4
    lam, lam_kv = 10.93, 1.29
    want = jcd.solve_decode(lam, lam_kv, _kv_sysp(JSystemParams, kv_full),
                            t0, e0, b_max=16)
    got = tcd.solve_decode(lam, lam_kv, _kv_sysp(SystemParams, kv_full),
                           t0, e0, b_max=16)
    jc, tc = JCodesignCache(), CodesignCache()
    jq, tq = JQosClass("c", t0=t0, e0=e0), QosClass("c", t0=t0, e0=e0)
    cached = [tc.solve_decode(lam, lam_kv, _kv_sysp(SystemParams, kv_full),
                              tq, 16) for _ in range(2)]
    jcached = jc.solve_decode(lam, lam_kv, _kv_sysp(JSystemParams, kv_full),
                              jq, 16)
    assert (tc.hits, tc.misses) == (1, 1)
    if want is None:
        assert got is None and cached[0] is None and jcached is None
        return
    for sol, ref in ((got, want), (cached[0], jcached)):
        assert (sol.b_kv, sol.b_hat, sol.f, sol.f_server) == \
            (ref.b_kv, ref.b_hat, ref.f, ref.f_server)
        for f in ("objective", "delay", "energy"):
            np.testing.assert_allclose(getattr(sol, f), getattr(ref, f),
                                       rtol=1e-12)
    assert cached[1] is cached[0]


def _gap(logits):
    top2 = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top2[1] - top2[0])


def _reference_margins(jmodel, jweights, toks, stream, b_kv):
    """Top-2 margins of the reference's logits at every step of its own
    token stream (teacher-forced replay of prefill + decode_step_q)."""
    p = toks.size
    t = int(seq_bucket(p + stream.size))
    padded = np.zeros((1, int(seq_bucket(p))), np.int32)
    padded[0, :p] = toks
    logits, jc = jax.jit(jmodel.prefill)(jweights, {"tokens": padded},
                                         jnp.asarray([p - 1], jnp.int32))
    margins = [_gap(logits[0])]
    state = _quantized_state((jc["k"], jc["v"]), b_kv, t)
    step = jax.jit(lambda w, c, b: jmodel.decode_step_q(w, c, b, b_kv=b_kv))
    for j in range(1, stream.size):
        logits, qc = step(jweights, {**state, "len": jnp.asarray([p + j - 1])},
                          {"token": jnp.asarray([[stream[j - 1]]]),
                           "pos": jnp.asarray([p + j - 1], jnp.int32)})
        state = {k: qc[k] for k in state}
        margins.append(_gap(logits[0]))
    return np.asarray(margins)


@pytest.mark.parametrize("b_hat,b_kv", [(4, 4), (8, 8), (8, 16)])
def test_greedy_streams_match_reference(qwen, jcache, b_hat, b_kv):
    jmodel, jparams, tmodel, _ = qwen
    jeng = JDecodeEngine(jmodel, jparams, JSystemParams(**SYSP),
                         classes=[JQosClass(*QOS)], auto=False,
                         compile_cache=jcache)
    jeng.set_operating_point(QOS[0], b_hat, b_kv)
    jweights = jeng.class_params(QOS[0])
    tweights = _bridge(jweights)
    compared = total = 0
    for toks, n_new, _ in _ragged_traffic(jmodel.cfg, 6, seed=3,
                                          max_new=8):
        want = jgreedy(jmodel, jweights, toks, n_new, b_kv=b_kv,
                       compile_cache=jcache)
        got = greedy_decode_reference(tmodel, tweights, toks, n_new,
                                      b_kv=b_kv, device="cpu")
        margins = _reference_margins(jmodel, jweights, toks, want, b_kv)
        close = np.flatnonzero(margins < MARGIN)
        upto = int(close[0]) if close.size else n_new
        np.testing.assert_array_equal(got[:upto], want[:upto])
        compared += upto
        total += n_new
    print(f"b_hat={b_hat} b_kv={b_kv}: compared {compared} of {total} "
          "greedy steps")
    # the rule may skip near-ties, but most steps must be compared
    assert compared >= total // 2, (compared, total)


def test_report_matches_reference_engine(qwen, jcache):
    jmodel, jparams, tmodel, tparams = qwen
    traffic = _ragged_traffic(jmodel.cfg, 6, seed=3)
    kv_full = 2.0 * 4 * 3 * 40 * 2 * 16 * 4
    reps = []
    for Engine, Sysp, Qos, kw in (
            (JDecodeEngine, JSystemParams, JQosClass,
             dict(compile_cache=jcache)),
            (DecodeEngine, SystemParams, QosClass, dict(device="cpu"))):
        params = jparams if Engine is JDecodeEngine else tparams
        model = jmodel if Engine is JDecodeEngine else tmodel
        eng = Engine(model, params, _kv_sysp(Sysp, kv_full),
                     classes=[Qos(*QOS)], auto=False, max_batch=3,
                     max_new_tokens=6, **kw)
        eng.set_operating_point(QOS[0], 4, 4)
        for toks, n_new, t in traffic:
            eng.submit(toks, QOS[0], max_new_tokens=n_new, arrival_s=t)
        eng.drain()
        reps.append(eng.report())
    want, got = reps
    for f in ("requests_served", "prefills", "decode_rounds",
              "tokens_generated", "kv_bytes", "kv_bytes_full", "h2d_bytes",
              "d2h_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("total_delay_s", "total_energy_j"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12)
    assert got.admission == want.admission
    assert [dataclasses.astuple(c)[:5] for c in got.classes] == \
        [dataclasses.astuple(c)[:5] for c in want.classes]
