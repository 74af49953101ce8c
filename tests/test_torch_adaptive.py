"""Adaptive serving in the port against the JAX reference, on the CPU
(mirrors tests/test_adaptive.py's twelve tests).

The reference runs these cases on stablelm-3b's smoke config; these keep
qwen2-0.5b's smoke config (the port's only config when they were
written), in both packages, with the reference's parameters carried across by
``bridge.params_from_jax``.  Every scenario runs through the JAX
``AdaptiveCoInferenceEngine`` and the port's on the same environment
(``repro_torch.env``, a copy of ``repro.env``) and the same numpy-seeded
requests: the replan events (time, reason, environment key, bits,
degraded), the ``AdaptiveReport``, the batch history and the per-request
accounting are equal, the logits within rtol = atol = 1e-4, and then the
reference's own assertions hold for the port.  Under a constant trace the
port's adaptive engine equals its batched engine bitwise, also on the
kernel path from the compiled forward.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import env as jenv
from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import AdaptiveCoInferenceEngine as JAdaptive
from repro.runtime import BatchedCoInferenceEngine as JBatched
from repro.runtime import CodesignCache as JCodesignCache
from repro.runtime import CoInferenceEngine as JCoInference
from repro.runtime import QosClass as JQosClass
from repro_torch import env as tenv
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (AdaptiveCoInferenceEngine,
                                 BatchedCoInferenceEngine, CodesignCache,
                                 CoInferenceEngine, QosClass)

SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 1.30, 1.5)
TOL = dict(rtol=1e-4, atol=1e-4)
LAM_RTOL = 1e-6


def _pair(split=None):
    jcfg, tcfg = jget_smoke("qwen2-0.5b"), get_smoke("qwen2-0.5b")
    if split is not None:
        jcfg = dataclasses.replace(jcfg, split_layer=split)
        tcfg = dataclasses.replace(tcfg, split_layer=split)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {"jax": (jmodel, jparams), "port": (DecoderLM(tcfg), tparams)}


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def models_split2():
    return _pair(split=2)


# the two packages' names, so one scenario runs through either
SIDES = {
    "jax": dict(env=jenv, Sysp=JSystemParams, Qos=JQosClass,
                Adaptive=JAdaptive, Batched=JBatched,
                CoInference=JCoInference, kw={}),
    "port": dict(env=tenv, Sysp=SystemParams, Qos=QosClass,
                 Adaptive=AdaptiveCoInferenceEngine,
                 Batched=BatchedCoInferenceEngine,
                 CoInference=CoInferenceEngine, kw=dict(device="cpu")),
}


def _engine(side, models, env, qos=QOS, sysp=SYSP, **kw):
    s = SIDES[side]
    model, params = models[side]
    return s["Adaptive"](model, params, s["Sysp"](**sysp),
                         classes=[s["Qos"](*q) for q in
                                  ([qos] if isinstance(qos[0], str)
                                   else qos)],
                         environment=env(s["env"]) if env else None,
                         **kw, **s["kw"])


def _submit(eng, n=6, seed=0, qos=QOS[0], spacing_s=0.0, vocab=512):
    rng = np.random.default_rng(seed)
    for i in range(n):
        toks = rng.integers(0, vocab, size=int(rng.integers(6, 17)))
        eng.submit(toks, qos, arrival_s=i * spacing_s)


def _throttle_env(f_lo=0.6e9, dwell_s=4.0, horizon_s=40.0):
    """f_max steps 2.0 -> f_lo GHz and stays there."""
    return lambda e: e.Environment(seed=0, dt_s=0.5, horizon_s=horizon_s,
                                   f_cap=e.TraceReplay(values=(2.0e9, f_lo),
                                                       dwell_s=dwell_s))


def _both(models, env, submit=None, **kw):
    """The scenario through both engines; returns (jax, port) engines and
    their responses, after holding the port to the reference."""
    out = {}
    for side in SIDES:
        eng = _engine(side, models, env, **kw)
        (submit or _submit)(eng)
        out[side] = (eng, sorted(eng.drain(), key=lambda r: r.request_id))
    (jeng, jres), (teng, tres) = out["jax"], out["port"]
    assert [dataclasses.astuple(e) for e in teng.replan_events] \
        == [dataclasses.astuple(e) for e in jeng.replan_events]
    assert dataclasses.astuple(teng.adaptive_report()) \
        == dataclasses.astuple(jeng.adaptive_report())
    assert [dataclasses.astuple(b) for b in teng.batch_history] \
        == [dataclasses.astuple(b) for b in jeng.batch_history]
    assert len(tres) == len(jres)
    for x, y in zip(tres, jres):
        assert x.request_id == y.request_id
        assert dataclasses.astuple(x.stats) == dataclasses.astuple(y.stats)
        assert torch.isfinite(x.logits).all()
        np.testing.assert_allclose(x.logits.numpy(), np.asarray(y.logits),
                                   **TOL)
    for name in teng.classes:
        _assert_same_solution(teng.solution_for(name),
                              jeng.solution_for(name))
    return jeng, teng, tres


def _assert_same_solution(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.b_hat == want.b_hat
    assert got.feasible == want.feasible
    assert getattr(got, "bits", None) == getattr(want, "bits", None)
    for f in ("f", "f_server", "delay", "energy"):
        assert getattr(got, f) == getattr(want, f), f
    # the bound depends on λ, which each package fits from the same
    # weights as a float32 reduction in its own order
    np.testing.assert_allclose(got.objective, want.objective, rtol=LAM_RTOL)


# ---------------------------------------------------------------------------
# identity with the static engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("environment,path", [
    (None, "fake"), ("constant", "fake"), ("constant", "kernel")])
def test_bitwise_identical_to_batched_on_constant_trace(models, environment,
                                                        path):
    """Port on port, adaptive == batched bitwise (on the kernel path from
    the compiled forward: the same graphs replayed on the card), and the
    adaptive engine is the reference's."""
    env = (lambda e: e.Environment(seed=0, dt_s=0.5, horizon_s=20.0)) \
        if environment == "constant" else None
    kw = dict(max_batch=2, path=path)
    if path == "kernel":
        kw.update(compiled=True, qos=("int8", 1.30, 1.2))
    _, teng, tres = _both(models, env, submit=lambda e: _submit(
        e, qos=kw.get("qos", QOS)[0]), **kw)
    model, params = models["port"]
    kw.pop("qos", None)
    b = BatchedCoInferenceEngine(model, params, SystemParams(**SYSP),
                                 classes=list(teng.classes.values()),
                                 device="cpu", **kw)
    _submit(b, qos=next(iter(teng.classes)))
    rb = sorted(b.drain(), key=lambda r: r.request_id)
    assert len(tres) == len(rb) == 6
    assert teng.batch_history == b.batch_history
    for x, y in zip(tres, rb):
        assert x.stats == y.stats
        assert torch.equal(x.logits, y.logits)
    rep = teng.adaptive_report()
    assert rep.plan_switches == 0 and rep.degraded_batches == 0
    if path == "kernel":
        assert teng.engine.agent_path == "kernel-int8"
        assert teng.report().compile_misses == b.report().compile_misses


# ---------------------------------------------------------------------------
# drift detection and hysteresis
# ---------------------------------------------------------------------------

def test_sustained_drift_triggers_replan_and_switch(models):
    _, eng, _ = _both(models, _throttle_env(), max_batch=1,
                      hysteresis_steps=2,
                      submit=lambda e: _submit(e, n=10, spacing_s=1.0))
    rep = eng.adaptive_report()
    assert rep.replans >= 1 and rep.plan_switches >= 1
    assert rep.env_keys_seen == 2
    assert eng.batch_history[-1].b_hat < eng.batch_history[0].b_hat
    ev = eng.replan_events[0]
    assert ev.reason == "env-drift" and ev.b_after < ev.b_before


def _oscillating(e):
    return e.Environment(seed=0, dt_s=1.0, horizon_s=40.0,
                         f_cap=e.TraceReplay(values=(2.0e9, 1.2e9) * 10,
                                             dwell_s=1.0))


def test_hysteresis_no_flapping_on_boundary_oscillation(models):
    """A state crossing the quantization boundary at every observation
    never sustains a drift streak; the oracle chases it."""
    submit = lambda e: _submit(e, n=10, spacing_s=1.0)  # noqa: E731
    _, eng, _ = _both(models, _oscillating, max_batch=1, hysteresis_steps=2,
                      submit=submit)
    rep = eng.adaptive_report()
    assert rep.env_keys_seen == 2 and rep.replans == 0
    _, oracle, _ = _both(models, _oscillating, max_batch=1, policy="oracle",
                         submit=submit)
    assert oracle.adaptive_report().replans >= 5


def test_replans_bounded_by_hysteresis(models):
    env = lambda e: e.Environment(  # noqa: E731
        seed=0, dt_s=0.5, horizon_s=40.0,
        f_cap=e.TraceReplay(values=(2.0e9, 1.2e9, 2.0e9, 0.6e9, 2.0e9),
                            dwell_s=4.0))
    _, eng, _ = _both(models, env, max_batch=1, hysteresis_steps=3,
                      submit=lambda e: _submit(e, n=12, spacing_s=1.0))
    assert eng.adaptive_report().replans <= len(eng.batch_history) // 3


def test_static_policy_never_replans_but_is_billed_by_the_env(models):
    _, eng, _ = _both(models, _throttle_env(), max_batch=1, policy="static",
                      submit=lambda e: _submit(e, n=8, spacing_s=1.0))
    assert eng.adaptive_report().replans == 0
    assert eng.batch_history[0].f == pytest.approx(
        eng.solution_for(QOS[0]).f)
    assert eng.batch_history[-1].f <= 0.6e9 * (1 + 1e-9)


# ---------------------------------------------------------------------------
# infeasible windows degrade instead of raising
# ---------------------------------------------------------------------------

def _capped(e):
    return e.Environment(seed=0, dt_s=0.5, horizon_s=20.0,
                         f_cap=e.TraceReplay(values=(0.05e9,), dwell_s=1.0))


def test_infeasible_window_degrades_to_lowest_distortion_feasible_plan(
        models):
    tight = ("tight", 0.12, 1.5)
    model, params = models["port"]
    with pytest.raises(ValueError):
        BatchedCoInferenceEngine(
            model, params,
            dataclasses.replace(SystemParams(**SYSP), f_max=0.05e9),
            classes=[QosClass(*tight)], device="cpu")
    _, eng, res = _both(models, _capped, qos=tight, max_batch=2,
                        submit=lambda e: _submit(e, n=4, qos="tight"))
    sol = eng.solution_for("tight")
    assert not sol.feasible and sol.b_hat == 1
    assert math.isfinite(sol.f) and sol.f > 0
    assert len(res) == 4
    assert eng.adaptive_report().degraded_batches == len(eng.batch_history)


def test_degraded_plan_meets_deadline_when_only_energy_is_impossible(
        models):
    env = lambda e: e.Environment(seed=0, dt_s=0.5,  # noqa: E731
                                  horizon_s=10.0)
    _, eng, _ = _both(models, env, qos=("weird", 2.0, 1e-12), max_batch=1,
                      submit=lambda e: _submit(e, n=2, qos="weird"))
    sol = eng.solution_for("weird")
    assert not sol.feasible
    assert sol.b_hat == 16
    assert sol.delay <= 2.0 * (1 + 1e-9)


def test_infeasible_window_mixed_precision_mode(models_split2):
    """The degraded b̂ spent as a flat per-layer budget: (1, 1), the
    reference's plan (the fake path clamps its levels; on the kernel path
    a 1-bit layer is NaN in both packages, ROADMAP C.7(c))."""
    _, eng, res = _both(models_split2, _capped, qos=("tight", 0.12, 1.5),
                        max_batch=2, mixed_precision=True,
                        submit=lambda e: _submit(e, n=2, qos="tight"))
    sol = eng.solution_for("tight")
    assert not sol.feasible and sol.bits == (1, 1)
    assert len(res) == 2


# ---------------------------------------------------------------------------
# adaptive beats static on a throttling trace
# ---------------------------------------------------------------------------

def test_adaptive_strictly_fewer_violations_than_static(models):
    """Per-request workload at the smoke model's own FLOPs, so realized
    batch delays are commensurate with the deadline."""
    model, params = models["port"]
    n_a, n_s = CoInferenceEngine(model, params, SystemParams(**SYSP),
                                 device="cpu").flop_split(16)
    sysp = dict(n_flop_agent=n_a, n_flop_server=n_s)
    p = SystemParams(**sysp)
    t_ref = n_a / (p.c_agent * p.f_max) + n_s / (p.c_server * p.f_server_max)
    horizon = 12.0e-3
    env = lambda e: e.Environment(  # noqa: E731
        seed=0, dt_s=0.5e-3, horizon_s=horizon,
        f_cap=e.TraceReplay(values=(2.0e9, 0.6e9), dwell_s=horizon / 2))

    def submit(eng):
        rng = np.random.default_rng(2)
        for i in range(12):
            eng.submit(rng.integers(0, 512, size=16), "rt",
                       arrival_s=i * horizon / 12)

    reports = {}
    for policy in ("static", "adaptive"):
        _, eng, _ = _both(models, env, qos=("rt", 0.78 * t_ref, 2.0e-3),
                          sysp=sysp, max_batch=1, policy=policy,
                          hysteresis_steps=2, submit=submit)
        reports[policy] = eng.adaptive_report()
    assert reports["static"].deadline_violations \
        > reports["adaptive"].deadline_violations
    assert reports["adaptive"].replans >= 1


# ---------------------------------------------------------------------------
# environment-keyed codesign cache
# ---------------------------------------------------------------------------

def test_codesign_cache_env_key_separates_and_memoizes():
    jc, tc = JCodesignCache(), CodesignCache()
    q, jq = QosClass(*QOS), JQosClass(*QOS)
    a = tc.solve(30.0, SystemParams(**SYSP), q, b_max=16, env_key=("good",))
    b = tc.solve(30.0, SystemParams(**SYSP), q, b_max=16, env_key=("bad",))
    assert tc.misses == 2 and tc.hits == 0
    assert a == b
    tc.solve(30.0, SystemParams(**SYSP), q, b_max=16, env_key=("good",))
    assert tc.hits == 1
    want = jc.solve(30.0, JSystemParams(**SYSP), jq, b_max=16,
                    env_key=("good",))
    _assert_same_solution(a, want)
    assert a.iterations == want.iterations


def test_revisited_env_state_hits_cache_through_engine(models):
    env = lambda e: e.Environment(  # noqa: E731
        seed=0, dt_s=0.5, horizon_s=40.0,
        f_cap=e.TraceReplay(values=(2.0e9, 0.6e9, 2.0e9), dwell_s=5.0))
    _, eng, _ = _both(models, env, max_batch=1, hysteresis_steps=2,
                      submit=lambda e: _submit(e, n=14, spacing_s=1.0))
    rep = eng.adaptive_report()
    assert rep.plan_switches >= 2
    cache = eng.codesign_cache
    assert cache.hits >= 1
    assert len(cache) == 2


def test_battery_derate_tightens_energy_budget(models):
    """Below the reserve the energy budget is derated and the chosen b̂
    can only be lower, for both packages alike."""
    full = lambda e: e.Environment(seed=0, dt_s=0.5,  # noqa: E731
                                   horizon_s=10.0)
    low = lambda e: e.Environment(  # noqa: E731
        seed=0, dt_s=0.5, horizon_s=10.0,
        battery=e.Battery(capacity_j=1e9, drain_w=0.0, soc0=0.085),
        battery_reserve_soc=0.25)
    assert low(tenv).state_at(0.0).energy_scale \
        == low(jenv).state_at(0.0).energy_scale < 1.0
    sols = {}
    for name, env in (("full", full), ("low", low)):
        for side in SIDES:
            eng = _engine(side, models, env, qos=("tight-e", 1.3, 1.5))
            sols[name, side] = eng.solution_for("tight-e")
        _assert_same_solution(sols[name, "port"], sols[name, "jax"])
    s_full, s_low = sols["full", "port"], sols["low", "port"]
    assert s_full.feasible and s_low.feasible
    assert s_low.b_hat < s_full.b_hat
