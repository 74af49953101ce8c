"""Fleet serving in the port against the JAX reference, on the CPU
(mirrors tests/test_fleet.py), and the compile-cache key that keeps one
engine's captured weights from serving another's requests.

* ``core.fleet`` given the same λ: shares, bits and the upgrade log equal,
  the aggregate bound within rtol 1e-12 (float64 host math in both).
  With each package's own λ (``fit_lambda`` over bridged weights, a
  float32 reduction in each framework's order) the allocations are equal
  too: the λs agree to 1e-6 and no greedy step of these fleets is that
  close to a tie (asserted).
* The engine against ``repro.runtime.FleetCoInferenceEngine`` on the same
  bridged weights and requests (qwen2-0.5b and stablelm-3b smoke agents,
  one under ``wifi-markov``, as in ``examples/fleet_spec.json``): logits
  within rtol = atol = 1e-4 (on the kernel path a padded batch is held
  against the reference's request alone where its padded kernel path
  differs, ROADMAP C.7(a), and a b_emb = 8 uplink code that sat on a
  rounding edge is traced stage by stage), report counts equal, clocks
  and energies within rtol 1e-12, bounds within the λ tolerance.
* Port on port: a one-agent fleet equals the batched engine bitwise, and
  the reference's shared-codesign-cache, FIFO and mixed-precision cases.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import env as jenv
from repro.configs import get_smoke as jget_smoke
from repro.core import fleet as jfl
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import CoInferenceEngine as JCoInference
from repro.runtime import FleetAgentSpec as JFleetAgentSpec
from repro.runtime import FleetCoInferenceEngine as JFleet
from repro.runtime import QosClass as JQosClass
from repro.runtime import fit_lambda as jfit_lambda
from repro_torch import env as tenv
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import codesign as cd
from repro_torch.core import fleet as fl
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (BatchedCoInferenceEngine, CodesignCache,
                                 CoInferenceEngine, CompiledForwardCache,
                                 FleetAgentSpec, FleetCoInferenceEngine,
                                 QosClass, fit_lambda)

SYSP_KW = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
SYSP = SystemParams(**SYSP_KW)
TOL = dict(rtol=1e-4, atol=1e-4)     # logits: f32 sums in another order
LAM_RTOL = 1e-6                      # λ: f32 reductions in another order
HOST_RTOL = 1e-12                    # float64 host math, same formulas


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agent(mod, sysp, name, t0, e0, lam=10.0, weight=1.0):
    return mod.FleetAgent(name=name, lam=lam, sysp=sysp, t0=t0, e0=e0,
                          weight=weight, b_emb=8)


# the reference's allocator scenarios (tests/test_fleet.py): one tight +
# two slack agents, a weighted pair, one agent, and a link-shared split
SCENARIOS = {
    "heterogeneous": [("tight", 0.8, 8.0, 10.0, 1.0),
                      ("loose-a", 3.0, 4.0, 12.0, 1.0),
                      ("loose-b", 3.0, 4.0, 8.0, 1.0)],
    "weighted": [("tight-heavy", 0.8, 8.0, 10.0, 100.0),
                 ("tight-light", 0.85, 8.0, 10.0, 1.0)],
    "single": [("tight", 0.8, 8.0, 10.0, 1.0)],
    "infeasible": [(f"a{i}", 0.16, 8.0, 10.0, 1.0) for i in range(8)],
}


def _solve(mod, sysp, rows, solver, **kw):
    agents = [_agent(mod, sysp, n, t0, e0, lam, w)
              for n, t0, e0, lam, w in rows]
    return getattr(mod, solver)(agents, **kw)


def _same_allocation(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.solver == b.solver
    np.testing.assert_allclose(a.shares, b.shares, rtol=HOST_RTOL, atol=0)
    assert [s.b_hat for s in a.solutions] == [s.b_hat for s in b.solutions]
    np.testing.assert_allclose([s.f for s in a.solutions],
                               [s.f for s in b.solutions], rtol=HOST_RTOL)
    np.testing.assert_allclose([s.f_server for s in a.solutions],
                               [s.f_server for s in b.solutions],
                               rtol=HOST_RTOL)
    np.testing.assert_allclose(a.aggregate_bound, b.aggregate_bound,
                               rtol=HOST_RTOL)
    assert (a.upgrades, a.solves) == (b.upgrades, b.solves)
    assert len(a.upgrade_log) == len(b.upgrade_log)
    for x, y in zip(a.upgrade_log, b.upgrade_log):
        assert x[:2] == y[:2]
        np.testing.assert_allclose(x[2:], y[2:], rtol=HOST_RTOL)


# ---------------------------------------------------------------------------
# core.fleet: the same λ -> the same allocation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("solver", ["solve_fleet", "solve_equal_split"])
@pytest.mark.parametrize("share_link", [False, True])
def test_allocation_equals_reference(scenario, solver, share_link):
    kw = dict(SYSP_KW, link_bps=2.5e6, emb_bytes_full=4.0e5,
              tx_power_w=0.25)
    rows = SCENARIOS[scenario]
    ours = _solve(fl, SystemParams(**kw), rows, solver,
                  share_link=share_link)
    ref = _solve(jfl, JSystemParams(**kw), rows, solver,
                 share_link=share_link)
    _same_allocation(ours, ref)


@pytest.mark.parametrize("b_hat", [1, 4, 8, 12, 16])
def test_min_share_equals_reference(b_hat):
    ours = fl.min_share_for(_agent(fl, SYSP, "t", 0.8, 8.0), b_hat)
    ref = jfl.min_share_for(_agent(jfl, JSystemParams(**SYSP_KW), "t", 0.8,
                                   8.0), b_hat)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert ours == ref
        # the threshold share really is feasible for b_hat
        p = fl.shared_params(SYSP, ours)
        assert cd.feasible_bitwidth(b_hat, p, 0.8, 8.0, b_emb=8)[0]


def test_shared_params_and_validation():
    """The reference's identity, link-share and validation cases."""
    assert fl.shared_params(SYSP, 1.0) == SYSP
    p = fl.shared_params(SYSP, 0.5)
    assert p.f_server_max == pytest.approx(SYSP.f_server_max * 0.5)
    assert p.f_max == SYSP.f_max
    base = SystemParams(n_flop_agent=1e9, n_flop_server=1e9,
                        link_bps=2.0e6, emb_bytes_full=1e5)
    assert fl.shared_params(base, 0.25, share_link=True).link_bps \
        == pytest.approx(5.0e5)
    assert fl.shared_params(base, 0.25).link_bps == base.link_bps
    with pytest.raises(ValueError):
        fl.FleetAgent(name="x", lam=-1.0, sysp=SYSP, t0=1.0, e0=1.0)
    tight = _agent(fl, SYSP, "tight", 0.8, 8.0)
    with pytest.raises(ValueError):
        fl.solve_fleet([tight, tight])
    with pytest.raises(ValueError):
        fl.solve_fleet([])
    with pytest.raises(ValueError):
        fl.shared_params(SYSP, 0.0)


def test_joint_beats_equal_split():
    """The reference's heterogeneous-fleet claims, on the port."""
    rows = SCENARIOS["heterogeneous"]
    joint = _solve(fl, SYSP, rows, "solve_fleet")
    equal = _solve(fl, SYSP, rows, "solve_equal_split")
    assert abs(sum(joint.shares) - 1.0) < 1e-6
    assert joint.aggregate_bound < equal.aggregate_bound
    assert joint.shares[0] > equal.shares[0]
    assert joint.solutions[0].b_hat > equal.solutions[0].b_hat
    single = _solve(fl, SYSP, SCENARIOS["single"], "solve_fleet")
    assert single.shares == (1.0,)
    assert single.solutions[0] == cd.solve_sca(10.0, SYSP, 0.8, 8.0,
                                               b_max=16, b_emb=8)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

def _bridged(arch, seed):
    jmodel = build_model(jget_smoke(arch))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return (jmodel, jparams), (DecoderLM(get_smoke(arch)), tparams)


@pytest.fixture(scope="module")
def fleet_models():
    """examples/fleet_spec.json's archs, seeded by first appearance."""
    return {"qwen2-0.5b": _bridged("qwen2-0.5b", 0),
            "stablelm-3b": _bridged("stablelm-3b", 1)}


# examples/fleet_spec.json's agents
SPEC = [dict(name="drone", arch="qwen2-0.5b", t0=0.8, e0=8.0, weight=2.0),
        dict(name="monitor", arch="stablelm-3b", t0=3.0, e0=4.0),
        dict(name="kiosk", arch="qwen2-0.5b", t0=3.0, e0=4.0,
             env_trace=True,
             sysp=dict(emb_bytes_full=400000.0, link_bps=2500000.0,
                       tx_power_w=0.25))]


def _specs(side, models):
    out = []
    for a in SPEC:
        (jm, jp), (tm, tp) = models[a["arch"]]
        if side == "jax":
            sysp = dataclasses.replace(JSystemParams(**SYSP_KW),
                                       **a.get("sysp", {}))
            env = jenv.presets.wifi_markov(seed=0) if a.get("env_trace") \
                else None
            out.append(JFleetAgentSpec(
                name=a["name"], model=jm, params=jp, sysp=sysp,
                qos=JQosClass(a["name"], t0=a["t0"], e0=a["e0"]),
                weight=a.get("weight", 1.0), environment=env))
        else:
            sysp = dataclasses.replace(SYSP, **a.get("sysp", {}))
            env = tenv.presets.wifi_markov(seed=0) if a.get("env_trace") \
                else None
            out.append(FleetAgentSpec(
                name=a["name"], model=tm, params=tp, sysp=sysp,
                qos=QosClass(a["name"], t0=a["t0"], e0=a["e0"]),
                weight=a.get("weight", 1.0), environment=env))
    return out


def _traffic(specs, n=6, seq=32):
    """The CLI's fleet traffic: per agent, n requests of seq/2..seq."""
    rng = np.random.default_rng(0)
    out = []
    for s in specs:
        for _ in range(n):
            out.append((s.name, rng.integers(
                0, s.model.cfg.vocab_size,
                size=int(rng.integers(max(seq // 2, 1), seq + 1)))))
    return out


@pytest.mark.parametrize("path,compiled,allocator", [
    ("fake", False, "joint"), ("fake", False, "equal"),
    ("kernel", False, "joint"), ("kernel", True, "joint")])
def test_fleet_engine_matches_reference(fleet_models, path, compiled,
                                        allocator):
    jspecs, tspecs = _specs("jax", fleet_models), _specs("port",
                                                         fleet_models)
    # each package's own λ per agent: the same to LAM_RTOL
    for js, ts in zip(jspecs, tspecs):
        split = ts.model.cfg.split_layer
        np.testing.assert_allclose(fit_lambda(ts.params, split),
                                   jfit_lambda(js.params, split),
                                   rtol=LAM_RTOL)
    jf = JFleet(jspecs, allocator=allocator, max_batch=4, path=path,
                compiled=compiled)
    tf = FleetCoInferenceEngine(tspecs, allocator=allocator, max_batch=4,
                                path=path, compiled=compiled, device="cpu")
    if compiled:
        assert tf.warmup(32) == jf.warmup(32)
    traffic = _traffic(tspecs)
    for name, toks in traffic:
        jf.submit(name, toks)
        tf.submit(name, toks)
    jout, tout = jf.drain(), tf.drain()
    sent = {}
    for name, toks in traffic:
        sent.setdefault(name, []).append(toks)
    for name in jout:
        assert [r.request_id for r in tout[name]] == \
            [r.request_id for r in jout[name]]
        for a, b in zip(tout[name], jout[name]):
            _hold_logits(a, b, jf.engines[name], tf.engines[name],
                         sent[name][a.request_id])
            assert (a.stats.b_hat, a.stats.batch_size, a.stats.emb_bytes) \
                == (b.stats.b_hat, b.stats.batch_size, b.stats.emb_bytes)
            np.testing.assert_allclose(
                [a.stats.total_delay_s, a.stats.energy_j],
                [b.stats.total_delay_s, b.stats.energy_j], rtol=HOST_RTOL)
    tr, jr = tf.report(), jf.report()
    for f in ("allocator", "n_agents", "requests_served", "batches_served",
              "deadline_violations", "codesign_hits", "codesign_misses",
              "compile_hits", "compile_misses", "compiled_variants"):
        assert getattr(tr, f) == getattr(jr, f), f
    np.testing.assert_allclose(tr.shares, jr.shares, rtol=HOST_RTOL)
    np.testing.assert_allclose(
        [tr.total_energy_j, tr.makespan_s, tr.throughput_rps],
        [jr.total_energy_j, jr.makespan_s, jr.throughput_rps],
        rtol=HOST_RTOL)
    np.testing.assert_allclose(tr.aggregate_bound, jr.aggregate_bound,
                               rtol=LAM_RTOL)
    for a, b in zip(tr.per_agent, jr.per_agent):
        assert (a.name, a.b_hat, a.plan_bits, a.requests_served,
                a.batches_served, a.deadline_violations) == \
            (b.name, b.b_hat, b.plan_bits, b.requests_served,
             b.batches_served, b.deadline_violations)
        np.testing.assert_allclose(
            [a.share, a.clock_s, a.energy_j, a.mean_occupancy,
             a.throughput_rps],
            [b.share, b.clock_s, b.energy_j, b.mean_occupancy,
             b.throughput_rps], rtol=HOST_RTOL)
        np.testing.assert_allclose(a.bound, b.bound, rtol=LAM_RTOL)
    # the greedy's decisions: each package's own λ gave the same log
    assert [u[:2] for u in tf.allocation.upgrade_log] == \
        [u[:2] for u in jf.allocation.upgrade_log]


def _hold_logits(got, want, jmember, tmember, toks):
    """A port response against the reference's: within TOL, else against
    the reference's engine serving the request alone (its eager kernel
    path is not padding-invisible, ROADMAP C.7(a)), else every difference
    traced to uplink codes that sat on a rounding edge."""
    g = got.logits.numpy()
    if np.allclose(g, np.asarray(want.logits), **TOL):
        return
    qos = got.stats.qos
    sol = tmember.solution_for(qos)
    pair = []
    for member, Eng, kw in ((jmember, JCoInference, {}),
                            (tmember, CoInferenceEngine,
                             dict(device="cpu"))):
        inner = member.engine
        e = Eng(inner.model, inner.params, member.sysp, path=inner.path,
                b_emb=inner.b_emb, **kw)
        e.configure(sol.b_hat, sol.f, sol.f_server)
        pair.append(e)
    jalone, talone = pair
    toks = np.asarray(toks)[None]
    if np.allclose(g, np.asarray(jalone.serve_batch(
            {"tokens": jnp.asarray(toks)})[0][0]), **TOL):
        return
    assert _hold_stages(jalone, talone, toks) > 0


def _hold_stages(jeng, teng, tokens) -> int:
    """The forward stage by stage (tests/test_torch_serve_mixed.py's): the
    boundary activation at TOL; the b_emb-bit uplink codes equal except
    where a boundary element lies within the boundary difference of a
    rounding edge (there the code moves a whole step, and its logits with
    it); the server stage at TOL on the reference's received embedding.
    Returns the moved count."""
    jx, jpos = jeng.agent_stage({"tokens": jnp.asarray(tokens)})
    tx, tpos = teng.agent_stage({"tokens": tokens})
    jx, tx = np.array(jx), tx.numpy()
    np.testing.assert_allclose(tx, jx, **TOL)
    jrx = np.array(jeng.transport(jnp.asarray(jx))[0])
    trx = teng.transport(torch.from_numpy(tx))[0].numpy()
    step = np.abs(jx).max(axis=(1, 2), keepdims=True) \
        / (2 ** (jeng.b_emb - 1) - 1)
    edge = np.abs(np.abs(jx) / step % 1.0 - 0.5) * step
    moved = np.abs(trx - jrx) > 0.5 * step
    slack = np.abs(tx - jx).max() + 1e-6 * step
    assert (edge[moved] <= slack).all(), (edge[moved], slack)
    np.testing.assert_allclose(
        teng.server_stage(torch.from_numpy(jrx), tpos).numpy(),
        np.asarray(jeng.server_stage(jnp.asarray(jrx), jpos)), **TOL)
    return int(moved.sum())


def test_fleet_reallocate_matches_reference(fleet_models):
    """A dropout and a rejoin re-water-fill the same shares in both."""
    jf = JFleet(_specs("jax", fleet_models), max_batch=4)
    tf = FleetCoInferenceEngine(_specs("port", fleet_models), max_batch=4,
                                device="cpu")
    for active in (["drone", "kiosk"], ["drone", "monitor", "kiosk"]):
        a, b = tf.reallocate(active), jf.reallocate(active)
        np.testing.assert_allclose(a.shares, b.shares, rtol=HOST_RTOL)
        assert [s.b_hat for s in a.solutions] == \
            [s.b_hat for s in b.solutions]
        assert tf.active_agents == jf.active_agents
        for name in tf.active_agents:
            assert tf.solution_for(name).b_hat == \
                jf.solution_for(name).b_hat
    assert tf.reallocations == jf.reallocations == 2


# ---------------------------------------------------------------------------
# port on port (the reference's engine cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(1))


def _port_specs(model, params, n=3):
    qos = [QosClass("tight", t0=0.8, e0=8.0),
           QosClass("loose-a", t0=3.0, e0=4.0),
           QosClass("loose-b", t0=3.0, e0=4.0)]
    return [FleetAgentSpec(name=q.name, model=model, params=params,
                           sysp=SYSP, qos=q) for q in qos[:n]]


@pytest.mark.parametrize("path,compiled", [("fake", False),
                                           ("kernel", False),
                                           ("kernel", True)])
def test_single_agent_fleet_bitwise_batched(smoke_model, path, compiled):
    cfg, model, params = smoke_model
    qos = QosClass("solo", t0=1.3, e0=1.5)
    spec = FleetAgentSpec(name="solo", model=model, params=params,
                          sysp=SYSP, qos=qos)
    fleet = FleetCoInferenceEngine([spec], allocator="joint", max_batch=4,
                                   path=path, compiled=compiled,
                                   device="cpu")
    solo = BatchedCoInferenceEngine(model, params, SYSP, classes=[qos],
                                    max_batch=4, path=path,
                                    compiled=compiled, device="cpu")
    assert fleet.allocation.shares == (1.0,)
    rng = np.random.default_rng(2)
    for _ in range(5):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 17)))
        fleet.submit("solo", toks)
        solo.submit(toks, "solo")
    ra, rb = fleet.drain()["solo"], solo.drain()
    assert len(ra) == len(rb) == 5
    for x, y in zip(ra, rb):
        assert x.stats == y.stats
        assert torch.equal(x.logits, y.logits)


def test_fleet_serves_and_reports(smoke_model):
    cfg, model, params = smoke_model
    specs = _port_specs(model, params)
    fleet = FleetCoInferenceEngine(specs, allocator="joint", max_batch=2,
                                   device="cpu")
    rng = np.random.default_rng(0)
    for s in specs:
        for _ in range(3):
            fleet.submit(s.name, rng.integers(0, cfg.vocab_size,
                                              size=int(rng.integers(6, 17))))
    out = fleet.drain()
    assert all(len(v) == 3 for v in out.values())
    rep = fleet.report()
    assert rep.requests_served == 9 and rep.n_agents == 3
    assert abs(sum(rep.shares) - 1.0) < 1e-6
    assert rep.makespan_s == max(p.clock_s for p in rep.per_agent)
    assert rep.aggregate_bound == pytest.approx(
        sum(p.bound for p in rep.per_agent))
    assert rep.per_agent[0].share == max(rep.shares)


def test_fleet_shared_codesign_cache_dedups(smoke_model):
    _, model, params = smoke_model
    specs = [FleetAgentSpec(name=f"twin-{i}", model=model, params=params,
                            sysp=SYSP,
                            qos=QosClass(f"twin-{i}", t0=1.3, e0=1.5))
             for i in range(2)]
    cache = CodesignCache()
    FleetCoInferenceEngine(specs, allocator="equal", max_batch=2,
                           codesign_cache=cache, device="cpu")
    assert cache.misses == 1 and cache.hits >= 1


def test_fleet_shared_compile_cache(smoke_model):
    """Agents over one params object share graphs where (plan, bucket)
    match; an agent with weights of its own captures its own."""
    cfg, model, params = smoke_model
    specs = _port_specs(model, params, n=2)
    cc = CompiledForwardCache()
    fleet = FleetCoInferenceEngine(specs, allocator="equal", max_batch=2,
                                   path="kernel", compiled=True,
                                   compile_cache=cc, device="cpu")
    n_first = fleet.engines["tight"].warmup(16)
    assert n_first >= 1
    b0 = fleet.solution_for("tight").b_hat
    b1 = fleet.solution_for("loose-a").b_hat
    n_second = fleet.engines["loose-a"].warmup(16)
    assert n_second == 0 if b0 == b1 else n_second <= n_first
    # a twin with other weights of the same config misses every bucket
    other = model.init(torch.Generator().manual_seed(7))
    twin = BatchedCoInferenceEngine(model, other, SYSP,
                                    classes=[specs[0].qos], max_batch=2,
                                    path="kernel", compiled=True,
                                    compile_cache=cc, device="cpu")
    assert twin.warmup(16) == n_first
    rep = fleet.report()
    assert rep.compile_misses == n_first + n_second


def test_fleet_fifo_ranks_agents_by_oldest_arrival(smoke_model):
    cfg, model, params = smoke_model
    specs = _port_specs(model, params, n=2)
    fleet = FleetCoInferenceEngine(specs, allocator="equal", max_batch=4,
                                   device="cpu")
    rng = np.random.default_rng(5)
    fleet.submit("tight", rng.integers(0, cfg.vocab_size, size=8),
                 arrival_s=5.0)
    fleet.submit("tight", rng.integers(0, cfg.vocab_size, size=8),
                 arrival_s=1.0)
    fleet.submit("loose-a", rng.integers(0, cfg.vocab_size, size=8),
                 arrival_s=2.0)
    assert fleet.engines["tight"].oldest_pending_arrival() == 1.0
    name, responses = fleet.step()
    assert name == "tight" and responses


def test_fleet_mixed_precision_plans_per_slice():
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), split_layer=2)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    specs = [FleetAgentSpec(name="tight", model=model, params=params,
                            sysp=SYSP, qos=QosClass("tight", t0=0.8,
                                                    e0=8.0)),
             FleetAgentSpec(name="loose", model=model, params=params,
                            sysp=SYSP, qos=QosClass("loose", t0=3.0,
                                                    e0=4.0))]
    fleet = FleetCoInferenceEngine(specs, allocator="joint", max_batch=2,
                                   mixed_precision=True, device="cpu")
    rng = np.random.default_rng(0)
    for s in specs:
        for _ in range(2):
            fleet.submit(s.name, rng.integers(0, cfg.vocab_size, size=10))
    out = fleet.drain()
    assert all(len(v) == 2 for v in out.values())
    tight, loose = fleet.report().per_agent
    assert tight.share > loose.share
    assert len(tight.plan_bits) == len(loose.plan_bits) == 2
    assert min(loose.plan_bits) >= min(tight.plan_bits)
    assert fleet.solution_for("tight").bits == tight.plan_bits


def test_fleet_engine_validation(smoke_model):
    _, model, params = smoke_model
    specs = _port_specs(model, params, n=1)
    with pytest.raises(ValueError):
        FleetCoInferenceEngine([], allocator="joint", device="cpu")
    with pytest.raises(ValueError):
        FleetCoInferenceEngine(specs, allocator="best-effort", device="cpu")
    with pytest.raises(ValueError):
        FleetCoInferenceEngine(specs + specs, device="cpu")
    tight = FleetAgentSpec(name="no", model=model, params=params,
                           sysp=SYSP, qos=QosClass("no", t0=1e-9, e0=1e-9))
    with pytest.raises(ValueError, match="infeasible"):
        FleetCoInferenceEngine([tight], device="cpu")
    fleet = FleetCoInferenceEngine(specs, device="cpu")
    with pytest.raises(KeyError):
        fleet.submit("ghost", np.arange(4))


# ---------------------------------------------------------------------------
# the compile cache keys on the weights a graph bakes in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_hat", [8, 4])
def test_shared_compile_cache_serves_each_engine_its_own_weights(b_hat):
    """Two engines with the same config and b̂ but different weights,
    over one compile cache: each returns its own uncached engine's logits
    (a captured graph bakes its weights in, so a key naming only the plan
    served the second engine the first one's weights)."""
    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, 12))
    cache = CompiledForwardCache()
    got, want = [], []
    for seed in (0, 1):
        params = model.init(torch.Generator().manual_seed(seed))
        shared = CoInferenceEngine(model, params, SYSP, path="kernel",
                                   compiled=True, compile_cache=cache,
                                   device="cpu")
        own = CoInferenceEngine(model, params, SYSP, path="kernel",
                                compiled=True, device="cpu")
        for eng in (shared, own):
            eng.configure(b_hat)
            assert eng.agent_path == f"kernel-int{b_hat}"
        got.append(shared.serve_batch({"tokens": toks})[0])
        want.append(own.serve_batch({"tokens": toks})[0])
    assert cache.misses == 2 and cache.hits == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])
