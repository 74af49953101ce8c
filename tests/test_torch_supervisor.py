"""The port's serving supervisor against the JAX reference's, on the CPU
(mirrors tests/test_chaos.py's supervisor cases and the serving half of
tests/test_fault_tolerance.py).

Both packages serve the same bridged weights and the same numpy-seeded
requests under the same seeded ``ChaosTrace`` (``repro_torch.env`` is a
copy of ``repro.env``; the traces are asserted equal):

* the ``ResilienceReport``s are equal (every count; the virtual clock and
  the goodput within rtol 1e-12, float64 host math in both);
* prefill-style engines' logits within rtol = atol = 1e-4 of the
  reference's (the fake path), and a supervised clean or retransmitted run
  bitwise the port's bare engine;
* every resumed decode or speculative stream is bitwise the port's
  uninterrupted run, and equal to the reference's tokens;
* ``payload_checksum`` equals the reference's on the same arrays, and
  ``flip_bit`` flips the same bit;
* ``chaos_from_spec`` (what ``--chaos-trace`` reads) realizes the
  reference's schedule bitwise and rejects a malformed spec with the
  reference's message.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.env as jenv
from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import BatchedCoInferenceEngine as JBatched
from repro.runtime import DecodeEngine as JDecode
from repro.runtime import FleetAgentSpec as JFleetAgentSpec
from repro.runtime import FleetCoInferenceEngine as JFleet
from repro.runtime import QosClass as JQosClass
from repro.runtime import ServingSupervisor as JSupervisor
from repro.runtime import SpeculativeDecodeEngine as JSpeculative
from repro.runtime import flip_bit as jflip_bit
from repro.runtime import greedy_decode_reference as jgreedy
from repro.runtime import payload_checksum as jpayload_checksum
import repro_torch.env as tenv
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (AdaptiveCoInferenceEngine,
                                 BatchedCoInferenceEngine, DecodeEngine,
                                 FleetAgentSpec, FleetCoInferenceEngine,
                                 QosClass, ServingSupervisor,
                                 SpeculativeDecodeEngine, flip_bit,
                                 greedy_decode_reference, payload_checksum)

SYSP_KW = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 1.3, 1.5)
TOL = dict(rtol=1e-4, atol=1e-4)     # logits: f32 sums in another order
HOST_RTOL = 1e-12                    # virtual clocks: float64 host math


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SIDES = {
    "jax": dict(env=jenv, Sysp=JSystemParams, Qos=JQosClass,
                Batched=JBatched, Decode=JDecode, Spec=JSpeculative,
                Fleet=JFleet, Spec_=JFleetAgentSpec, Sup=JSupervisor,
                kw={}),
    "port": dict(env=tenv, Sysp=SystemParams, Qos=QosClass,
                 Batched=BatchedCoInferenceEngine, Decode=DecodeEngine,
                 Spec=SpeculativeDecodeEngine, Fleet=FleetCoInferenceEngine,
                 Spec_=FleetAgentSpec, Sup=ServingSupervisor,
                 kw=dict(device="cpu")),
}

REPORT_COUNTS = ("mode", "engine", "clean", "requests_total", "delivered",
                 "failed", "shed", "retries", "retransmits", "failovers",
                 "recoveries", "reallocations", "faults_seen",
                 "stragglers_seen", "tokens_delivered", "tokens_lost",
                 "tokens_duplicated", "goodput_unit")


@pytest.fixture(scope="module")
def models():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {"jax": (jmodel, jparams),
            "port": (DecoderLM(get_smoke("qwen2-0.5b")), tparams)}


def _same_report(t, j):
    for f in REPORT_COUNTS:
        assert getattr(t, f) == getattr(j, f), (f, t, j)
    np.testing.assert_allclose([t.clock_s, t.goodput], [j.clock_s, j.goodput],
                               rtol=HOST_RTOL)


# ---------------------------------------------------------------------------
# payload checksum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "uint8",
                                   "float64"])
@pytest.mark.parametrize("shape", [(), (7,), (3, 4, 5)])
def test_payload_checksum_equals_reference(dtype, shape):
    rng = np.random.default_rng(0)
    arr = np.asarray(rng.standard_normal(shape) * 50).astype(dtype)
    want = jpayload_checksum(arr)
    assert payload_checksum(arr) == want
    if dtype != "float64":          # JAX holds no float64 by default
        assert jpayload_checksum(jnp.asarray(arr)) == want
    assert payload_checksum(torch.from_numpy(arr.copy())) == want
    nbits = max(arr.nbytes * 8, 1)
    for bit in (0, nbits // 2, nbits - 1):
        flipped = flip_bit(arr, bit)
        np.testing.assert_array_equal(flipped, jflip_bit(arr, bit))
        assert payload_checksum(flipped) != want
        t = flip_bit(torch.from_numpy(arr.copy()), bit)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), flipped)


# ---------------------------------------------------------------------------
# batched engine
# ---------------------------------------------------------------------------

def _traffic(vocab, n, seed=7, spacing=0.01):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(6, 17))).astype(
        np.int32), spacing * i) for i in range(n)]


def _chaos(env, kind):
    if kind == "clean":
        return env.presets.chaos_clean()
    if kind == "outage":
        return env.ChaosTrace(dt_s=0.005, horizon_s=2.0, seed=1,
                              link_outage=env.LinkOutage(p_fail=0.3,
                                                         p_recover=0.05))
    if kind == "corruption":
        return env.ChaosTrace(dt_s=0.005, horizon_s=2.0, seed=4,
                              corruption=env.PacketCorruption(rate=0.5))
    assert kind == "storm"
    return env.presets.chaos_storm(seed=3, horizon_s=5.0)


def _run_batched(side, models, kind, supervised):
    s = SIDES[side]
    model, params = models[side]
    qos = s["Qos"](*QOS)
    eng = s["Batched"](model, params, s["Sysp"](**SYSP_KW), classes=[qos],
                       max_batch=3, **s["kw"])
    chaos = _chaos(s["env"], kind)
    sup = s["Sup"](eng, chaos=chaos, supervised=supervised, seed=3)
    rids = {}
    for i, (toks, t) in enumerate(_traffic(model.cfg.vocab_size, 6)):
        rids[sup.submit(toks, qos.name, arrival_s=t)] = i
    out = {rids[r.request_id]: r for r in sup.drain()}
    return out, sup.report(), chaos


@pytest.mark.parametrize("kind,supervised", [
    ("clean", True), ("outage", True), ("outage", False),
    ("corruption", True), ("storm", True), ("storm", False)])
def test_batched_supervisor_matches_reference(models, kind, supervised):
    tout, trep, tchaos = _run_batched("port", models, kind, supervised)
    jout, jrep, jchaos = _run_batched("jax", models, kind, supervised)
    for f in ("link_up", "server_up", "corrupt"):
        np.testing.assert_array_equal(getattr(tchaos, f),
                                      getattr(jchaos, f))
    _same_report(trep, jrep)
    assert trep.requests_total == trep.delivered + trep.failed + trep.shed
    assert sorted(tout) == sorted(jout)
    for i in tout:
        np.testing.assert_allclose(tout[i].logits.numpy(),
                                   np.asarray(jout[i].logits), **TOL)
        assert tout[i].stats.b_hat == jout[i].stats.b_hat
    # the reference's own claims
    if kind == "clean":
        assert trep.clean and trep.delivered == 6
        assert trep.retries == trep.failovers == trep.shed == 0
    if kind == "outage" and supervised:
        assert trep.failovers > 0 and trep.failed == 0
    if kind == "outage" and not supervised:
        assert trep.failed > 0
    if kind == "corruption" and supervised:
        assert trep.retransmits > 0 and trep.delivered == 6


@pytest.mark.parametrize("kind", ["clean", "corruption"])
def test_supervised_run_is_bitwise_the_bare_engine(models, kind):
    """A clean trace is pure pass-through, and a retransmitted payload is
    the same payload: both deliver the bare engine's logits bitwise."""
    model, params = models["port"]
    out, rep, _ = _run_batched("port", models, kind, True)
    eng = BatchedCoInferenceEngine(model, params, SystemParams(**SYSP_KW),
                                   classes=[QosClass(*QOS)], max_batch=3,
                                   device="cpu")
    for toks, t in _traffic(model.cfg.vocab_size, 6):
        eng.submit(toks, QOS[0], arrival_s=t)
    for i, r in enumerate(eng.drain()):
        assert torch.equal(out[i].logits, r.logits)
        if kind == "clean":     # a retransmit bills time: other batches
            assert out[i].stats == r.stats
    assert rep.delivered == 6


def test_adaptive_engine_clean_trace_passthrough(models):
    """The adaptive engine under the supervisor on a clean trace: bitwise
    its unsupervised run."""
    model, params = models["port"]

    def run(sup_on):
        eng = AdaptiveCoInferenceEngine(
            model, params, SystemParams(**SYSP_KW),
            classes=[QosClass(*QOS)], max_batch=3,
            environment=tenv.presets.constant(), device="cpu")
        front = ServingSupervisor(eng, chaos=tenv.presets.chaos_clean(),
                                  seed=3) if sup_on else eng
        for toks, t in _traffic(model.cfg.vocab_size, 6):
            front.submit(toks, QOS[0], arrival_s=t)
        return front.drain()

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a.logits, b.logits) and a.stats == b.stats


def test_shed_only_unmeetable_requests(models):
    """The reference's shedding case, in both packages."""
    reps, served = {}, {}
    for side in ("port", "jax"):
        s = SIDES[side]
        model, params = models[side]
        qos = s["Qos"](*QOS)
        eng = s["Batched"](model, params, s["Sysp"](**SYSP_KW),
                           classes=[qos], max_batch=3, **s["kw"])
        sup = s["Sup"](eng, chaos=s["env"].ChaosTrace(
            dt_s=0.5, horizon_s=400.0, seed=0,
            corruption=s["env"].PacketCorruption(rate=0.001)),
            supervised=True, seed=3, deadline_factor=4.0)
        streams = _traffic(model.cfg.vocab_size, 3)
        sup.submit(streams[0][0], qos.name, arrival_s=0.0)
        sup.engine.fast_forward(50.0)
        sup.submit(streams[1][0], qos.name, arrival_s=0.0)
        rid_ok = sup.submit(streams[2][0], qos.name, arrival_s=49.0)
        outs = sup.drain()
        reps[side] = sup.report()
        served[side] = any(r.request_id == rid_ok for r in outs)
    _same_report(reps["port"], reps["jax"])
    rep = reps["port"]
    assert rep.shed >= 1 and served["port"]
    assert rep.requests_total == rep.delivered + rep.shed + rep.failed


# ---------------------------------------------------------------------------
# fleet engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("supervised", [True, False])
def test_fleet_dropout_matches_reference(models, supervised):
    reps = {}
    for side in ("port", "jax"):
        s = SIDES[side]
        model, params = models[side]
        qos = [s["Qos"]("tight", t0=0.8, e0=8.0),
               s["Qos"]("loose-a", t0=3.0, e0=4.0),
               s["Qos"]("loose-b", t0=3.0, e0=4.0)]
        specs = [s["Spec_"](name=q.name, model=model, params=params,
                            sysp=s["Sysp"](**SYSP_KW), qos=q) for q in qos]
        chaos = s["env"].ChaosTrace(
            dt_s=0.005, horizon_s=10.0, seed=9, n_agents=3,
            dropout=s["env"].AgentDropout(p_drop=0.3, p_rejoin=0.3))
        fleet = s["Fleet"](specs, allocator="joint", max_batch=2,
                           **s["kw"])
        sup = s["Sup"](fleet, chaos=chaos, supervised=supervised, seed=3)
        rng = np.random.default_rng(0)
        for sp in specs:
            for _ in range(3):
                sup.submit(sp.name, rng.integers(
                    0, model.cfg.vocab_size, size=int(rng.integers(6, 17))))
        sup.drain()
        reps[side] = sup.report()
    _same_report(reps["port"], reps["jax"])
    rep = reps["port"]
    if supervised:
        assert rep.delivered == 9 and rep.failed == 0
        assert rep.reallocations > 0
    else:
        assert rep.failed > 0


# ---------------------------------------------------------------------------
# decode engines: crash recovery
# ---------------------------------------------------------------------------

def _decode_engine(side, models, spec=False, cache=None):
    s = SIDES[side]
    model, params = models[side]
    kw = dict(classes=[s["Qos"]("c", t0=3.0, e0=2.0)], auto=False,
              max_batch=2, max_new_tokens=6, compile_cache=cache, **s["kw"])
    if spec:
        eng = s["Spec"](model, params, s["Sysp"](**SYSP_KW), draft_bits=4,
                        lookahead=3, **kw)
    else:
        eng = s["Decode"](model, params, s["Sysp"](**SYSP_KW), **kw)
    eng.set_operating_point("c", 8, 8)
    return eng


def _streams(vocab, t_round):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, size=int(rng.integers(6, 17))).astype(
        np.int32), int(rng.integers(3, 7)), 10.0 * t_round * i)
        for i in range(3)]


def _crash_trace(env, t_round, span, lo, hi):
    chaos = env.ChaosTrace(dt_s=t_round, horizon_s=4.0 * span, seed=0,
                           preemption=env.ServerPreemption(mtbf_s=1e9,
                                                           mttr_s=1e9))
    i0 = chaos.index_at(lo * span)
    i1 = max(i0 + 1, chaos.index_at(hi * span))
    chaos.server_up[:] = True
    chaos.server_up[i0:i1] = False
    assert not chaos.is_clean()
    return chaos


@pytest.mark.parametrize("spec", [False, True])
def test_decode_crash_recovery_matches_reference(models, spec):
    """The reference's parity matrix: preempt the server during admission,
    mid-stream and near retirement; the supervisor snapshots, waits and
    resumes every in-flight request.  Every stream is bitwise the port's
    uninterrupted run and equals the reference's tokens; the reports are
    equal; at least one window forces a snapshot and restore."""
    probe = {side: _decode_engine(side, models, spec) for side in SIDES}
    t_round = probe["port"].decode_round_cost("c", 32)[0]
    np.testing.assert_allclose(
        t_round, probe["jax"].decode_round_cost("c", 32)[0], rtol=HOST_RTOL)
    model = models["port"][0]
    streams = _streams(model.cfg.vocab_size, t_round)
    tcache = probe["port"].compile_cache
    ref = {i: greedy_decode_reference(
        model, probe["port"].class_params("c"), toks, n, b_kv=8,
        compile_cache=tcache, device="cpu")
        for i, (toks, n, _) in enumerate(streams)}
    for i, (toks, n, _) in enumerate(streams):
        jref = jgreedy(models["jax"][0], probe["jax"].class_params("c"),
                       toks, n, b_kv=8,
                       compile_cache=probe["jax"].compile_cache)
        np.testing.assert_array_equal(ref[i], np.asarray(jref))
    eng0 = _decode_engine("port", models, spec, tcache)
    for toks, n, t in streams:
        eng0.submit(toks, "c", max_new_tokens=n, arrival_s=t)
    eng0.drain()
    span = eng0.clock_s

    recoveries = 0
    for lo, hi in [(0.05, 0.25), (0.35, 0.60), (0.70, 0.95)]:
        reps = {}
        for side in ("port", "jax"):
            s = SIDES[side]
            eng = _decode_engine(side, models, spec,
                                 probe[side].compile_cache)
            sup = s["Sup"](eng, chaos=_crash_trace(s["env"], t_round, span,
                                                   lo, hi),
                           supervised=True, seed=3)
            rids = {}
            for i, (toks, n, t) in enumerate(streams):
                rids[sup.submit(toks, "c", max_new_tokens=n,
                                arrival_s=t)] = i
            out = {rids[r.request_id]: np.asarray(r.tokens)
                   for r in sup.drain()}
            reps[side] = sup.report()
            assert out.keys() == ref.keys()
            for i in ref:
                np.testing.assert_array_equal(out[i], ref[i])
            if side == "port" and spec:
                erep = eng.report()
                assert eng.spec_stats().delivered \
                    == erep.tokens_generated - erep.prefills
        _same_report(reps["port"], reps["jax"])
        rep = reps["port"]
        assert rep.delivered == len(streams) and rep.failed == 0
        assert rep.tokens_lost == 0 and rep.tokens_duplicated == 0
        recoveries += rep.recoveries
    assert recoveries > 0


def test_decode_bare_engine_loses_work(models):
    """The control arm: the same preemption strands in-flight requests
    without the supervisor, in both packages alike."""
    reps = {}
    for side in ("port", "jax"):
        s = SIDES[side]
        eng = _decode_engine(side, models)
        t_round = eng.decode_round_cost("c", 32)[0]
        chaos = s["env"].ChaosTrace(
            dt_s=t_round, horizon_s=5000.0 * t_round, seed=0,
            preemption=s["env"].ServerPreemption(mtbf_s=1e9, mttr_s=1e9))
        chaos.server_up[:] = True
        chaos.server_up[2:] = False
        sup = s["Sup"](eng, chaos=chaos, supervised=False, seed=3)
        rng = np.random.default_rng(11)
        for i in range(3):
            sup.submit(rng.integers(0, 512, size=8 + i), "c",
                       max_new_tokens=5, arrival_s=0.0)
        sup.drain()
        reps[side] = sup.report()
    _same_report(reps["port"], reps["jax"])
    assert reps["port"].failed > 0 and reps["port"].tokens_lost > 0


@pytest.mark.parametrize("steps", [1, 3])
def test_snapshot_is_the_batch1_state(models, steps):
    """``snapshot_request`` after some token steps is the batch-1
    reference's state at the same point, bitwise, its bytes counted in
    ``d2h_bytes``; resuming it finishes the uninterrupted stream."""
    model = models["port"][0]
    eng = _decode_engine("port", models)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 14)]
    rids = [eng.submit(p, "c", arrival_s=0.0) for p in prompts]
    eng.step(max_decode_steps=1)          # admits both, one step
    for _ in range(steps - 1):
        eng.step(max_decode_steps=1)
    d2h = eng.report().d2h_bytes
    w = eng.class_params("c")
    nbytes = 0
    for rid, p in zip(rids, prompts):
        snap = eng.snapshot_request(rid)
        nbytes += sum(v.nbytes for v in snap["state"].values())
        n_done = len(snap["generated"])
        toks, state = greedy_decode_reference(
            model, w, p, n_done, b_kv=8, reserve_tokens=6,
            return_state=True, device="cpu")
        np.testing.assert_array_equal(np.asarray(snap["generated"]), toks)
        for k in ("k_codes", "v_codes", "k_scales", "v_scales", "pos",
                  "last_token", "t_bucket"):
            np.testing.assert_array_equal(snap["state"][k], state[k])
        rest = greedy_decode_reference(model, w, p, 6 - n_done, b_kv=8,
                                       state=snap["state"], device="cpu")
        full = greedy_decode_reference(model, w, p, 6, b_kv=8, device="cpu")
        np.testing.assert_array_equal(np.concatenate([toks, rest]), full)
    assert eng.report().d2h_bytes == d2h + nbytes


# ---------------------------------------------------------------------------
# the chaos spec the CLI's --chaos-trace reads (repro_torch.env.faults)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,match", [
    ([1, 2], "top level"),
    ({"no_such": 1}, "unknown top-level"),
    ({"dt_s": "fast"}, "must be a number"),
    ({"link_outage": 3}, "must be an object"),
    ({"link_outage": {"p_flail": 0.1}}, "unknown key"),
    ({"corruption": {"rate": 2.0}}, "rate"),
    ({"preemption": {"mtbf_s": -1.0}}, "mtbf_s"),
])
def test_chaos_from_spec_rejects_malformed(spec, match):
    """The reference's exit-2 contract: the same one-line ValueError."""
    with pytest.raises(ValueError, match=match) as ours:
        tenv.chaos_from_spec(spec)
    with pytest.raises(ValueError) as ref:
        jenv.chaos_from_spec(spec)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed", [None, 42])
def test_chaos_spec_trace_equals_reference(seed):
    """examples/chaos_spec.json (and a dropout spec) realize the
    reference's schedule bitwise, with the seed override."""
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" \
        / "chaos_spec.json"
    specs = [json.loads(path.read_text()),
             {"dt_s": 0.1, "horizon_s": 20.0, "seed": 9,
              "link_outage": {"p_fail": 0.2, "p_recover": 0.4},
              "corruption": {"rate": 0.05},
              "dropout": {"p_drop": 0.1, "p_rejoin": 0.5, "n_agents": 3}}]
    for spec in specs:
        ours = tenv.chaos_from_spec(spec, seed=seed)
        ref = jenv.chaos_from_spec(spec, seed=seed)
        assert ours.seed == ref.seed and ours.n_agents == ref.n_agents
        for f in ("link_up", "server_up", "corrupt", "agents_up"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
        for t in (0.0, 0.37, ours.end_s, 10 * ours.horizon_s):
            assert dataclasses.asdict(ours.fault_at(t)) == \
                dataclasses.asdict(ref.fault_at(t))
            assert ours.next_server_up(t) == ref.next_server_up(t)
            assert ours.next_link_up(t) == ref.next_link_up(t)
        assert ours.outage_fraction() == ref.outage_fraction()


@pytest.mark.parametrize("t0,e0", [(1.3, 0.675), (1.5, 0.775), (3.0, 4.0),
                                   (0.05, 0.01), (1e-9, 1e-9)])
def test_device_only_solution_equals_reference(t0, e0):
    """The failover's operating point: (P1) with the whole model on the
    agent, relaxed when infeasible, equal to the reference's."""
    from repro.core import codesign as jcd
    from repro_torch.core import codesign as tcd
    kw = dict(SYSP_KW, link_bps=2.5e6, emb_bytes_full=4.0e5,
              tx_power_w=0.25)
    p, jp = SystemParams(**kw), JSystemParams(**kw)
    assert dataclasses.asdict(tcd.device_only_params(p)) == \
        dataclasses.asdict(jcd.device_only_params(jp))
    ours = tcd.solve_device_only(45.0, p, t0, e0)
    ref = jcd.solve_device_only(45.0, jp, t0, e0)
    assert (ours.b_hat, ours.feasible) == (ref.b_hat, ref.feasible)
    np.testing.assert_allclose(
        [ours.f, ours.f_server, ours.objective, ours.delay, ours.energy],
        [ref.f, ref.f_server, ref.objective, ref.delay, ref.energy],
        rtol=HOST_RTOL)
