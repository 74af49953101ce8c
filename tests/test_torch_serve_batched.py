"""The port's batched co-inference engine on the CPU, case for case with the
reference's tests/test_serve_batched.py, then held against the reference.

The reference runs these cases on stablelm-3b's smoke config; these keep
qwen2-0.5b's smoke config (the port's only config when they were
written) throughout.  Its three classes resolve to b̂ = 3, 9 and 16 (the fake
path); KERNEL_CLASSES resolve to 4 and 8, so the kernel path is batched
too.  Port against port, batched == sequential is bitwise on the CPU.
Against the reference (its weights carried across by
``bridge.params_from_jax``, the same numpy-seeded requests): the same
batches in the same order with equal integer accounting, and per-request
logits at rtol = atol = 1e-4.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import BatchedCoInferenceEngine as JBatched
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.obs import MetricsRegistry, TickClock, Tracer
from repro_torch.runtime import (BatchedCoInferenceEngine, CodesignCache,
                                 CoInferenceEngine, QosClass)

SYSP = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
CLASSES = [
    QosClass("realtime", t0=1.10, e0=0.9),
    QosClass("interactive", t0=1.30, e0=1.5),
    QosClass("batch", t0=2.50, e0=4.0),
]
# b̂ = 4 and 8 for the seed-0 smoke weights: the kernel path, batched
KERNEL_CLASSES = [QosClass("int4", t0=1.10, e0=1.0),
                  QosClass("int8", t0=1.30, e0=1.2)]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _batched(model, params, **kw):
    return BatchedCoInferenceEngine(model, params, SYSP, device="cpu", **kw)


def _mixed_requests(eng, cfg, classes=CLASSES, n=9, seed=0):
    """Round-robin classes, varying sequence lengths; returns id -> req."""
    rng = np.random.default_rng(seed)
    sent = {}
    for i in range(n):
        qos = classes[i % len(classes)].name
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 17)),
                            dtype=np.int64)
        sent[eng.submit(toks, qos)] = (toks, qos)
    return sent


@pytest.mark.parametrize("path,classes", [
    ("fake", CLASSES), ("kernel", CLASSES), ("kernel", KERNEL_CLASSES)])
def test_batched_bitwise_identical_to_sequential(lm, path, classes):
    cfg, model, params = lm
    eng = _batched(model, params, classes=classes, max_batch=4, path=path)
    sent = _mixed_requests(eng, cfg, classes)
    responses = eng.drain()
    assert len(responses) == len(sent)
    if classes is KERNEL_CLASSES:
        assert {b.agent_path for b in eng.batch_history} == \
            {"kernel-int4", "kernel-int8"}

    seq = CoInferenceEngine(model, params, SYSP, path=path,
                            cache_weights=True, device="cpu")
    for r in responses:
        toks, qos = sent[r.request_id]
        sol = eng.solution_for(qos)
        seq.configure(sol.b_hat, sol.f, sol.f_server)
        want, _ = seq.serve_batch({"tokens": toks[None]})
        assert torch.equal(r.logits, want[0]), r.request_id


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_ragged_batch_padding_cannot_change_uplink_scale(lm, seed):
    """A short request padded next to a longer one keeps its own
    per-request absmax for the b_emb quantization: padding positions are
    zeroed before transport, so batched logits stay bitwise equal to
    sequential for every seed."""
    cfg, model, params = lm
    eng = _batched(model, params, classes=[CLASSES[1]], max_batch=2)
    rng = np.random.default_rng(seed)
    short = rng.integers(0, cfg.vocab_size, size=6)
    long = rng.integers(0, cfg.vocab_size, size=16)
    rid_short = eng.submit(short, CLASSES[1].name)
    eng.submit(long, CLASSES[1].name)
    responses = {r.request_id: r for r in eng.drain()}
    assert responses[rid_short].logits.shape[0] == 6

    seq = CoInferenceEngine(model, params, SYSP, device="cpu")
    sol = eng.solution_for(CLASSES[1].name)
    seq.configure(sol.b_hat, sol.f, sol.f_server)
    want, stats = seq.serve_batch({"tokens": short[None]})
    assert torch.equal(responses[rid_short].logits, want[0])
    # and its reported uplink bytes are the request's own
    assert responses[rid_short].stats.emb_bytes == stats.emb_bytes


def test_codesign_cache_hit_miss(lm):
    cfg, model, params = lm
    cache = CodesignCache()
    eng = _batched(model, params, classes=CLASSES, codesign_cache=cache)
    # one miss per distinct (T0, E0); no per-request solves
    assert cache.misses == len(CLASSES)
    assert cache.hits == 0
    for i in range(12):
        eng.submit(np.arange(8), CLASSES[i % 3].name)
    eng.drain()
    assert cache.misses == len(CLASSES)  # serving never re-solved (P1)

    # a second engine sharing the cache resolves every class from it
    eng2 = _batched(model, params, classes=CLASSES, codesign_cache=cache)
    assert cache.hits == len(CLASSES)
    assert cache.misses == len(CLASSES)
    for c in CLASSES:
        assert eng2.solution_for(c.name) == eng.solution_for(c.name)
    # report() attributes each engine only its own hits/misses
    assert eng.report().codesign_misses == len(CLASSES)
    assert eng.report().codesign_hits == 0
    assert eng2.report().codesign_misses == 0
    assert eng2.report().codesign_hits == len(CLASSES)


def test_codesign_cache_keys_on_numbers_not_names():
    cache = CodesignCache()
    a = QosClass("a", t0=1.3, e0=1.5)
    b = QosClass("b", t0=1.3, e0=1.5)
    s1 = cache.solve(30.0, SYSP, a, b_max=16)
    s2 = cache.solve(30.0, SYSP, b, b_max=16)
    assert s1 == s2
    assert cache.misses == 1 and cache.hits == 1
    # different hardware -> different entry
    cache.solve(30.0, SystemParams(n_flop_agent=3.2e10,
                                   n_flop_server=1.92e11), a, b_max=16)
    assert cache.misses == 2


def test_mixed_qos_never_shares_a_batch_and_respects_qos(lm):
    cfg, model, params = lm
    eng = _batched(model, params, classes=CLASSES, max_batch=8)
    sent = _mixed_requests(eng, cfg, n=12)
    responses = eng.drain()

    # every batch is single-class, within max_batch, billed at its own b̂
    for b in eng.batch_history:
        assert b.qos in {c.name for c in CLASSES}
        assert 1 <= b.batch_size <= 8
        sol = eng.solution_for(b.qos)
        assert b.b_hat == sol.b_hat
        assert b.f == sol.f and b.f_server == sol.f_server
        assert 0.0 < b.occupancy <= 1.0

    # per-request accounting carries the request's own class configuration,
    # and that configuration satisfies the class's (T0, E0) on the nominal
    # per-request workload
    by_name = {c.name: c for c in CLASSES}
    for r in responses:
        _, qos = sent[r.request_id]
        assert r.stats.qos == qos
        sol = eng.solution_for(qos)
        assert r.stats.b_hat == sol.b_hat
        c = by_name[qos]
        assert sol.delay <= c.t0 * (1 + 1e-6)
        assert sol.energy <= c.e0 * (1 + 1e-6)
        assert r.stats.queue_wait_s >= 0.0
        assert r.stats.total_delay_s == pytest.approx(
            r.stats.queue_wait_s + r.stats.batch_delay_s)


def test_fifo_order_and_max_batch(lm):
    cfg, model, params = lm
    eng = _batched(model, params, classes=CLASSES, max_batch=2)
    ids = [eng.submit(np.arange(8), "realtime") for _ in range(5)]
    first = eng.step()
    assert [r.request_id for r in first] == ids[:2]
    rest = eng.drain()
    assert [r.request_id for r in rest] == ids[2:]
    assert [b.batch_size for b in eng.batch_history] == [2, 2, 1]


def test_report_aggregates(lm):
    cfg, model, params = lm
    eng = _batched(model, params, classes=CLASSES, max_batch=4)
    _mixed_requests(eng, cfg, n=8)
    eng.drain()
    rep = eng.report()
    assert rep.requests_served == 8
    assert rep.batches_served == len(eng.batch_history)
    assert rep.mean_batch_size == pytest.approx(8 / rep.batches_served)
    assert 0.0 < rep.mean_occupancy <= 1.0
    assert rep.total_delay_s > 0.0
    assert rep.throughput_rps == pytest.approx(8 / rep.total_delay_s)
    assert rep.total_energy_j == pytest.approx(
        sum(b.energy_j for b in eng.batch_history))
    # the virtual clock is the sum of batch delays (all arrivals at t=0)
    assert rep.total_delay_s == pytest.approx(
        sum(b.batch_delay_s for b in eng.batch_history))
    assert rep.to_dict()["requests_served"] == 8


def test_submit_validation(lm):
    cfg, model, params = lm
    eng = _batched(model, params, classes=CLASSES)
    with pytest.raises(KeyError):
        eng.submit(np.arange(4), "no-such-class")
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,)), "realtime")
    with pytest.raises(ValueError):
        _batched(model, params,
                 classes=[QosClass("impossible", t0=1e-9, e0=1e-9)])
    with pytest.raises(ValueError):
        _batched(model, params, classes=CLASSES, max_batch=0)
    with pytest.raises(ValueError):
        _batched(model, params, classes=[CLASSES[0], CLASSES[0]])


def test_infeasible_class_cached_as_none():
    cache = CodesignCache()
    bad = QosClass("bad", t0=1e-9, e0=1e-9)
    assert cache.solve(30.0, SYSP, bad, b_max=16) is None
    assert cache.solve(30.0, SYSP, bad, b_max=16) is None
    assert cache.misses == 1 and cache.hits == 1


def test_queue_hooks(lm):
    """cancel, fast_forward, oldest_pending_arrival and arrivals: a batch
    takes only requests that have arrived by its start."""
    cfg, model, params = lm
    eng = _batched(model, params, classes=CLASSES, max_batch=4)
    assert eng.oldest_pending_arrival() is None
    a = eng.submit(np.arange(8), "realtime", arrival_s=5.0)
    b = eng.submit(np.arange(8), "realtime", arrival_s=1.0)
    c = eng.submit(np.arange(8), "realtime", arrival_s=9.0)
    assert eng.oldest_pending_arrival() == 1.0
    assert eng.cancel(b) and not eng.cancel(b)
    eng.fast_forward(2.0)
    eng.fast_forward(1.0)                       # never backwards
    assert eng.clock_s == 2.0
    first = eng.step()
    assert [r.request_id for r in first] == [a]  # c arrives later
    assert first[0].stats.queue_wait_s == 0.0
    assert [r.request_id for r in eng.drain()] == [c]
    assert eng.pending() == 0 and eng.step() == []
    assert eng.plan_for("realtime") is None


def test_tracer_and_metrics_hooks(lm):
    """The batched engine's spans (batch.assemble, batch.forward,
    forward.capture) and counters, as in the reference."""
    cfg, model, params = lm
    tracer, metrics = Tracer(clock=TickClock()), MetricsRegistry()
    eng = _batched(model, params, classes=CLASSES, max_batch=4,
                   compiled=True, tracer=tracer, metrics=metrics)
    n = eng.warmup(16)
    _mixed_requests(eng, cfg, n=6)
    eng.drain()
    names = [e["name"] for e in tracer.events if e.get("ph") == "B"]
    assert names.count("forward.capture") == n
    assert names.count("batch.forward") == len(eng.batch_history)
    assert names.count("batch.assemble") == len(eng.batch_history)
    snap = metrics.snapshot()
    assert sum(r["value"] for r in snap["serve.requests"]["series"]) == 6
    assert sum(r["value"]
               for r in snap["compile.cache_misses"]["series"]) == n


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, DecoderLM(get_smoke("qwen2-0.5b")), params


@pytest.mark.parametrize("path", ["fake", "kernel"])
def test_batched_matches_reference(bridged, path):
    """Both packages' eager batched engines on one workload: the same
    batches in the same order, equal integer accounting per batch, per
    request and in the report, and per-request logits within 1e-4."""
    jmodel, jparams, model, params = bridged
    jsysp = JSystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    jeng = JBatched(jmodel, jparams, jsysp, classes=CLASSES, max_batch=4,
                    path=path)
    teng = _batched(model, params, classes=CLASSES, max_batch=4, path=path)
    for c in CLASSES:
        assert teng.solution_for(c.name).b_hat == \
            jeng.solution_for(c.name).b_hat
    rng = np.random.default_rng(3)
    for i in range(10):
        toks = rng.integers(0, model.cfg.vocab_size,
                            size=int(rng.integers(6, 40)))
        jeng.submit(jnp.asarray(toks), CLASSES[i % 3].name)
        teng.submit(toks, CLASSES[i % 3].name)
    while jeng.pending():
        jr, tr = jeng.step(), teng.step()
        assert [r.request_id for r in tr] == [r.request_id for r in jr]
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.logits.numpy(),
                                       np.asarray(b.logits), **TOL)
            assert (a.stats.qos, a.stats.b_hat, a.stats.batch_size,
                    a.stats.emb_bytes) == (b.stats.qos, b.stats.b_hat,
                                           b.stats.batch_size,
                                           b.stats.emb_bytes)
    assert teng.pending() == 0
    for a, b in zip(teng.batch_history, jeng.batch_history):
        assert (a.qos, a.batch_size, a.b_hat, a.agent_path, a.real_tokens,
                a.padded_tokens, a.emb_bytes, a.plan_bits) == \
            (b.qos, b.batch_size, b.b_hat, b.agent_path, b.real_tokens,
             b.padded_tokens, b.emb_bytes, b.plan_bits)
    tr_, jr_ = teng.report(), jeng.report()
    for f in ("requests_served", "batches_served", "codesign_hits",
              "codesign_misses", "compile_hits", "compile_misses",
              "compiled_variants"):
        assert getattr(tr_, f) == getattr(jr_, f), f
