"""Mixed-precision serving in the port against the JAX reference: the
sequential engine's ``auto_configure_mixed``, the batched engine with
``mixed_precision=True`` (eager and compiled) and the decode engine with
``mixed_precision=True``.

The serving config is qwen2-0.5b cut to 3 layers at widths that reach the
reference's Pallas kernels (split 2, so a plan has two agent layers); the
reference's parameters cross over.  Each package allocates from its own
layer statistics; the (T0, E0) points are ones whose allocations are
mixed, hold no 1-bit layer (ROADMAP C.5(c)) and have a greedy margin far
above the statistics' difference (``tests/test_torch_mixed_precision.py``
asserts that margin).  Bits and frequencies are equal; on one unpadded
request the boundary activation and the server stage agree at rtol = atol
= 1e-4, and the logits too unless the b_emb = 8 uplink moved a code at a
rounding edge (one point does: a 5e-6 boundary difference crosses an
edge and moves its logits by 2e-3; the test checks that every moved code
sat within that difference of an edge).  Batching, padding and the
compiled path are then proved port on port, bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.configs.qwen2_0_5b import FULL as JFULL
from repro.core.cost_model import SystemParams as JSystemParams
from repro.core.quantization import QuantPlan as JQuantPlan
from repro.models.registry import build_model
from repro.runtime import CoInferenceEngine as JEngine
from repro.runtime import CompiledForwardCache as JCompiledForwardCache
from repro.runtime import DecodeEngine as JDecodeEngine
from repro.runtime import QosClass as JQosClass
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.configs.qwen2_0_5b import FULL
from repro_torch.core import mixed_precision as tmp
from repro_torch.core.cost_model import SystemParams
from repro_torch.kernels.bucketing import seq_ladder
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (BatchedCoInferenceEngine, CodesignCache,
                                 CoInferenceEngine, DecodeEngine, QosClass,
                                 greedy_decode_reference)

CUT = dict(n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
           d_ff=512, vocab_size=512, split_layer=2)
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
TOL = dict(rtol=1e-4, atol=1e-4)
S = 24
# (T0, E0) -> the allocation both packages make on the cut model (b_emb 8)
POINTS = [((1.12, 1.05), (5, 4), "kernel-mixed[5/4]"),
          ((1.1, 1.5), (7, 6), "kernel-mixed[7/6]"),
          ((1.1, 0.95), (4, 3), "kernel-mixed[4/3]"),
          ((1.6, 1.05), (12, 11), "kernel-mixed[12/11]")]
CLASSES = [QosClass("tight", t0=1.12, e0=1.05),
           QosClass("loose", t0=1.1, e0=1.5)]


@pytest.fixture(scope="module")
def cut():
    jcfg = dataclasses.replace(JFULL, **CUT)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    model = DecoderLM(dataclasses.replace(FULL, **CUT))
    tokens = np.random.default_rng(0).integers(0, CUT["vocab_size"],
                                               (1, S)).astype(np.int32)
    return jmodel, jparams, model, params, tokens


@pytest.fixture(scope="module")
def jengines(cut):
    jmodel, jparams, *_ = cut
    return {path: JEngine(jmodel, jparams, JSystemParams(**SYSP), path=path,
                          cache_weights=True)
            for path in ("kernel", "fake")}


@pytest.mark.parametrize("path", ["kernel", "fake"])
@pytest.mark.parametrize("point,bits,agent_path", POINTS)
def test_auto_configure_mixed_matches_reference(cut, jengines, path, point,
                                                bits, agent_path):
    _, _, model, params, tokens = cut
    jeng = jengines[path]
    teng = CoInferenceEngine(model, params, SystemParams(**SYSP), path=path,
                             device="cpu")
    want = jeng.auto_configure_mixed(JQosClass("q", *point))
    got = teng.auto_configure_mixed(QosClass("q", *point),
                                    cache=CodesignCache())
    assert got.bits == want.bits == bits
    assert (got.uniform_b, got.b_hat) == (want.uniform_b, want.b_hat)
    for f in ("f", "f_server", "mean_bits", "delay", "energy"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-5)
    assert teng.agent_path == jeng.agent_path == \
        (agent_path if path == "kernel" else "fake")
    assert teng.plan.key() == jeng.plan.key()
    assert teng.b_eff == jeng.b_eff
    want_logits, jstats = jeng.serve_batch({"tokens": jnp.asarray(tokens)})
    got_logits, tstats = teng.serve_batch({"tokens": tokens})
    assert tstats.plan_bits == jstats.plan_bits == bits
    assert torch.isfinite(got_logits).all()
    if _hold_stages(jeng, teng, tokens) == 0:
        np.testing.assert_allclose(got_logits.numpy(),
                                   np.asarray(want_logits), **TOL)


def _hold_stages(jeng, teng, tokens) -> int:
    """The forward stage by stage: the boundary activation at TOL; the
    b_emb-bit uplink codes equal except where a boundary element lies
    within the boundary difference of a rounding edge (there the code
    moves a whole step, and its logits with it); the server stage at TOL
    on the reference's received embedding.  Returns the moved count."""
    jx, jpos = jeng.agent_stage({"tokens": jnp.asarray(tokens)})
    tx, tpos = teng.agent_stage({"tokens": tokens})
    jx, tx = np.array(jx), tx.numpy()
    np.testing.assert_allclose(tx, jx, **TOL)
    jrx = np.array(jeng.transport(jnp.asarray(jx))[0])
    trx = teng.transport(torch.from_numpy(tx))[0].numpy()
    step = np.abs(jx).max(axis=(1, 2), keepdims=True) \
        / (2 ** (jeng.b_emb - 1) - 1)
    edge = np.abs(np.abs(jx) / step % 1.0 - 0.5) * step
    # a code moved where the received values differ by a step (elsewhere
    # only the step, from the absmax, differs in its last bits)
    moved = np.abs(trx - jrx) > 0.5 * step
    slack = np.abs(tx - jx).max() + 1e-6 * step
    assert (edge[moved] <= slack).all(), (edge[moved], slack)
    np.testing.assert_allclose(
        teng.server_stage(torch.from_numpy(jrx), tpos).numpy(),
        np.asarray(jeng.server_stage(jnp.asarray(jrx), jpos)), **TOL)
    return int(moved.sum())


def test_layer_stats_memoized_and_plan_of(cut):
    _, _, model, params, _ = cut
    eng = CoInferenceEngine(model, params, SystemParams(**SYSP),
                            path="kernel", device="cpu")
    assert eng.layer_stats() is eng.layer_stats()
    assert eng.layer_stats().n_layers == CUT["split_layer"]
    sol = tmp.allocate_bits(eng.layer_stats(), eng.sysp, 1.12, 1.05, b_emb=8)
    assert eng.plan_of(sol).key() == tmp.plan_from_bits(sol.bits).key()
    assert eng.auto_configure_mixed(QosClass("x", 1e-9, 1e-9)) is None


def test_solve_mixed_cached_on_stats_not_names(cut):
    _, _, model, params, _ = cut
    sysp = SystemParams(**SYSP)
    eng = CoInferenceEngine(model, params, sysp, device="cpu")
    cache = CodesignCache()
    a = cache.solve_mixed(eng.layer_stats(), sysp,
                          QosClass("a", t0=1.3, e0=1.5), b_max=16)
    b = cache.solve_mixed(eng.layer_stats(), sysp,
                          QosClass("b", t0=1.3, e0=1.5), b_max=16)
    assert a == b
    assert cache.misses == 1 and cache.hits == 1
    # a keyspace disjoint from the uniform solver's and the decode ones'
    cache.solve(eng.lam, sysp, QosClass("a", t0=1.3, e0=1.5), b_max=16)
    assert cache.misses == 2
    cache.solve_decode_mixed(eng.layer_stats(), 2.0, sysp,
                             QosClass("a", t0=1.3, e0=1.5), b_max=16)
    cache.solve_decode(eng.lam, 2.0, sysp, QosClass("a", t0=1.3, e0=1.5),
                       b_max=16)
    assert cache.misses == 4 and len(cache) == 4


def _traffic(vocab, classes, n=6, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(6, 15))).astype(
        np.int32), classes[i % len(classes)].name) for i in range(n)]


def _serve(model, params, classes, compiled):
    eng = BatchedCoInferenceEngine(model, params, SystemParams(**SYSP),
                                   classes=classes, max_batch=3,
                                   path="kernel", mixed_precision=True,
                                   compiled=compiled, device="cpu")
    n_warm = eng.warmup(16) if compiled else 0
    sent = {eng.submit(t, q): (t, q)
            for t, q in _traffic(model.cfg.vocab_size, classes)}
    return eng, sent, {r.request_id: r for r in eng.drain()}, n_warm


def test_batched_mixed_matches_reference_alone(cut, jengines):
    _, _, model, params, _ = cut
    eng, sent, out, _ = _serve(model, params, CLASSES, compiled=False)
    assert [eng.solution_for(c.name).bits for c in CLASSES] == \
        [(5, 4), (7, 6)]
    assert eng.plan_for("tight").key() != eng.plan_for("loose").key()
    jeng = jengines["kernel"]
    moved = 0
    for rid, (toks, qos) in sent.items():
        sol = eng.solution_for(qos)
        jeng.configure(JQuantPlan.from_layer_bits(sol.bits), sol.f,
                       sol.f_server)
        eng.engine.configure(eng.plan_for(qos), sol.f, sol.f_server)
        want, _ = jeng.serve_batch({"tokens": jnp.asarray(toks)[None]})
        got, _ = eng.engine.serve_batch({"tokens": toks[None]})
        # batched rows against the request alone: at these widths CPU BLAS
        # picks its blocking by M, so the rows are only close (the port's
        # bitwise invariant is held at the smoke widths, below)
        np.testing.assert_allclose(out[rid].logits.numpy(), got[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        n = _hold_stages(jeng, eng.engine, toks[None])
        moved += n
        if n == 0:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       **TOL)
    assert moved < len(sent)
    for b in eng.batch_history:
        sol = eng.solution_for(b.qos)
        assert b.plan_bits == sol.bits
        assert b.agent_path == "kernel-mixed[" + "/".join(
            map(str, sol.bits)) + "]"
        assert b.b_hat == round(sol.mean_bits)
    rep = eng.report()
    assert rep.codesign_misses == 2 and rep.requests_served == len(sent)


@pytest.fixture(scope="module")
def smoke_split2():
    model = DecoderLM(dataclasses.replace(get_smoke("qwen2-0.5b"),
                                          split_layer=2))
    return model, model.init(torch.Generator().manual_seed(0))


def test_batched_mixed_equals_sequential_and_compiled_equals_eager(
        smoke_split2):
    """Port on port, bitwise on the CPU (smoke widths, as
    ``tests/test_torch_serve_batched.py``): every batched response, eager
    and from the compiled forwards, equals the sequential engine's for the
    request alone; a third class's plan is all wider than 8 bits (fake
    matrices in a kernel-path segment)."""
    model, params = smoke_split2
    classes = CLASSES + [QosClass("wide", t0=1.6, e0=1.05)]
    eager, sent, out, _ = _serve(model, params, classes, compiled=False)
    assert [eager.solution_for(c.name).bits for c in classes] == \
        [(5, 4), (7, 6), (12, 11)]
    comp, _, out_c, n_warm = _serve(model, params, classes, compiled=True)
    cc = comp.engine.compile_cache
    assert n_warm == len(cc) == len(classes) * len(seq_ladder(16))
    assert comp.report().compile_misses == n_warm    # none while serving
    seq = CoInferenceEngine(model, params, SystemParams(**SYSP),
                            path="kernel", cache_weights=True, device="cpu")
    for rid, (toks, qos) in sent.items():
        sol = eager.solution_for(qos)
        seq.configure(eager.plan_for(qos), sol.f, sol.f_server)
        want, _ = seq.serve_batch({"tokens": toks[None]})
        assert torch.equal(out[rid].logits, want[0]), rid
        assert torch.equal(out_c[rid].logits, want[0]), rid
    assert {b.agent_path for b in comp.batch_history} == \
        {"kernel-mixed[5/4]", "kernel-mixed[7/6]", "kernel-mixed[12/11]"}
    # the same classes in uniform mode solve (P1) and carry no plan
    uni = BatchedCoInferenceEngine(model, params, SystemParams(**SYSP),
                                   classes=CLASSES, path="kernel",
                                   device="cpu")
    assert uni.plan_for("tight") is None
    assert not hasattr(uni.solution_for("tight"), "bits")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

DEC_CLASSES = (("a", 1.7, 2.0), ("b", 1.6, 1.0))
KV_FULL = 2.0 * 4 * 3 * 40 * 2 * 16 * 4


def _dec_traffic(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 21))).astype(
        np.int32), int(rng.integers(1, 7)), 0.05 * i) for i in range(n)]


def test_decode_mixed_matches_reference():
    jcfg = dataclasses.replace(jget_smoke("qwen2-0.5b"), split_layer=2)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = DecoderLM(dataclasses.replace(get_smoke("qwen2-0.5b"),
                                          split_layer=2))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    kv = dict(kv_bytes_full=KV_FULL, kv_bw_bps=KV_FULL, kv_power_w=2.0)
    jeng = JDecodeEngine(jmodel, jparams, JSystemParams(**SYSP, **kv),
                         classes=[JQosClass(*c) for c in DEC_CLASSES],
                         max_batch=3, max_new_tokens=6, mixed_precision=True,
                         compile_cache=JCompiledForwardCache())
    eng = DecodeEngine(model, params, SystemParams(**SYSP, **kv),
                       classes=[QosClass(*c) for c in DEC_CLASSES],
                       max_batch=3, max_new_tokens=6, mixed_precision=True,
                       device="cpu")
    assert eng.layer_stats() is eng.layer_stats()
    for name, *_ in DEC_CLASSES:
        got, want = eng.solution_for(name), jeng.solution_for(name)
        assert (got.bits, got.b_kv) == (want.bits, want.b_kv)
        np.testing.assert_allclose(got.f, want.f, rtol=1e-12)
        np.testing.assert_allclose(got.f_server, want.f_server, rtol=1e-12)
        assert len(set(got.bits)) > 1 and min(got.bits) > 1
    assert {eng.b_kv_for(n) for n, *_ in DEC_CLASSES} == {4, 8}
    prompts = {}
    for i, (toks, n_new, t) in enumerate(_dec_traffic(jcfg.vocab_size)):
        qos = DEC_CLASSES[i % 2][0]
        rid = eng.submit(toks, qos, max_new_tokens=n_new, arrival_s=t)
        jrid = jeng.submit(toks, qos, max_new_tokens=n_new, arrival_s=t)
        prompts[rid] = (toks, n_new, qos, jrid)
    out = {r.request_id: r for r in eng.drain()}
    jout = {r.request_id: r for r in jeng.drain()}
    for rid, (toks, n_new, qos, jrid) in prompts.items():
        r = out[rid]
        assert r.b_kv == eng.b_kv_for(qos)
        np.testing.assert_array_equal(np.asarray(r.tokens),
                                      np.asarray(jout[jrid].tokens))
        np.testing.assert_array_equal(
            np.asarray(r.tokens),
            greedy_decode_reference(model, eng.class_params(qos), toks, n_new,
                                    b_kv=r.b_kv, device="cpu"))
    rep = eng.report()
    assert {c.qos: c.plan_bits for c in rep.classes} == \
        {n: eng.solution_for(n).bits for n, *_ in DEC_CLASSES}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.snapshot_request(0)
