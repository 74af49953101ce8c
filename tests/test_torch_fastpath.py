"""The port's compiled fast path on the CPU, case for case with the
reference's tests/test_fastpath.py, then held against the reference.

Port against port (bitwise): the compiled engine (on a CPU engine the
forward closure runs uncaptured, through the same cache and keys as the
card's CUDA graphs) equals the eager engine per request across paths,
plans, b_emb and buckets; batched + bucket-padded + compiled equals
sequential eager; the compile count stays within the ladder x plans and
warm traffic never misses.  Unlike the reference (ROADMAP C.5a) the port's
eager path is bitwise padding-invisible at b̂ = 4, so those two cases pass
here as the reference's own tests never have.

Port against the reference, on the same numpy-seeded requests and the
reference's weights carried across by ``bridge.params_from_jax``: the
uplink quantizer bitwise (the C.1 repair), per-request logits of the
compiled batched engine at rtol = atol = 1e-4, and its cache keys, bucket
shapes, batch composition and the report's integer fields equal.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import BatchedCoInferenceEngine as JBatched
from repro.runtime.fastpath import transport_quantize as jtransport
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.core.quantization import QuantPlan
from repro_torch.kernels.bucketing import (next_geometric, seq_bucket,
                                           seq_ladder)
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (BatchedCoInferenceEngine, CoInferenceEngine,
                                 CompiledForwardCache, QosClass)
from repro_torch.runtime.fastpath import CapturedCall, transport_quantize

SYSP = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
CLASSES = [
    QosClass("realtime", t0=1.10, e0=0.9),
    QosClass("interactive", t0=1.30, e0=1.5),
    QosClass("batch", t0=2.50, e0=4.0),
]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke("qwen2-0.5b")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


@pytest.fixture(scope="module")
def qwen_split3():
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), split_layer=3)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _engine(model, params, **kw):
    return CoInferenceEngine(model, params, SYSP, device="cpu", **kw)


def _batched(model, params, **kw):
    return BatchedCoInferenceEngine(model, params, SYSP, device="cpu", **kw)


def _ragged(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


def _assert_compiled_matches_eager(model, params, target, *, path,
                                   b_emb=8, lens=(6, 13, 16, 23)):
    cfg = model.cfg
    toks = _ragged(cfg, lens)
    eager = _engine(model, params, path=path, b_emb=b_emb)
    comp = _engine(model, params, path=path, b_emb=b_emb, compiled=True)
    eager.configure(target)
    comp.configure(target)
    le, se = eager.serve_batch({"tokens": toks}, lengths=list(lens))
    lc, sc = comp.serve_batch({"tokens": toks}, lengths=list(lens))
    assert lc.shape == le.shape  # sliced back from the bucket
    for i, n in enumerate(lens):
        assert torch.equal(le[i, :n], lc[i, :n]), (i, n)
    # per-request uplink accounting is padding-independent
    assert se.emb_row_bytes == sc.emb_row_bytes
    assert len(comp.compile_cache) == 1


# ---------------------------------------------------------------------------
# bitwise identity, port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_hat", [4, 8])
def test_compiled_bitwise_uniform_kernel(qwen, b_hat):
    _, model, params = qwen
    _assert_compiled_matches_eager(model, params, b_hat, path="kernel")


@pytest.mark.parametrize("b_emb", [4, 6, 16])
def test_compiled_bitwise_across_b_emb(qwen, b_emb):
    _, model, params = qwen
    _assert_compiled_matches_eager(model, params, 8, path="kernel",
                                   b_emb=b_emb)


def test_compiled_bitwise_fake_path(qwen):
    _, model, params = qwen
    _assert_compiled_matches_eager(model, params, 6, path="fake")


@pytest.mark.parametrize("bits", [(4, 8, 12), (4, 4, 6)])
def test_compiled_bitwise_mixed_plan(qwen_split3, bits):
    """Mixed plans restack into per-container segments (int4 / int8 /
    > 8-bit fake): every segment combination stays bitwise equal."""
    _, model, params = qwen_split3
    plan = QuantPlan.from_layer_bits(list(bits))
    _assert_compiled_matches_eager(model, params, plan, path="kernel")


def test_batched_compiled_bitwise_vs_sequential_eager(qwen):
    """Batched + bucket-padded + compiled serving returns, per request,
    the exact logits of the sequential eager engine, lengths crossing
    bucket boundaries included."""
    cfg, model, params = qwen
    seq = _engine(model, params, path="kernel", cache_weights=True)
    eng = _batched(model, params, classes=CLASSES, max_batch=4,
                   path="kernel", compiled=True)
    rng = np.random.default_rng(4)
    sent = {}
    for i in range(9):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(5, 60)))
        sent[eng.submit(toks, CLASSES[i % 3].name)] = (toks,
                                                       CLASSES[i % 3].name)
    responses = eng.drain()
    assert len(responses) == 9
    for r in responses:
        toks, qos = sent[r.request_id]
        sol = eng.solution_for(qos)
        seq.configure(sol.b_hat, sol.f, sol.f_server)
        want, _ = seq.serve_batch({"tokens": toks[None]})
        assert torch.equal(r.logits, want[0]), r.request_id


@pytest.mark.parametrize("b_hat", [4, 8])
def test_eager_bucket_padding_invisible(qwen, b_hat):
    """Right-padding a request to its seq bucket cannot change its logits
    (attention blocks snap to the bucket ladder, padded keys are masked
    to exact zeros, the uplink scale is per request over real
    positions)."""
    cfg, model, params = qwen
    eng = _engine(model, params, path="kernel")
    eng.configure(b_hat)
    rng = np.random.default_rng(4)
    for n in (10, 23, 40):
        toks = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        a, _ = eng.serve_batch({"tokens": toks[None]})
        padded = np.zeros((1, seq_bucket(n)), np.int32)
        padded[0, :n] = toks
        b, _ = eng.serve_batch({"tokens": padded}, lengths=[n])
        assert torch.equal(a[0], b[0, :n]), n


# ---------------------------------------------------------------------------
# compile-count bound + warmup
# ---------------------------------------------------------------------------

def test_compile_count_bounded_and_warm_traffic_never_recompiles(qwen):
    cfg, model, params = qwen
    eng = _batched(model, params, classes=CLASSES, max_batch=4,
                   path="kernel", compiled=True)
    max_seq = 64
    warm = eng.warmup(max_seq)
    cc = eng.engine.compile_cache
    bound = len(seq_ladder(max_seq)) * len(CLASSES)
    assert warm <= bound
    miss0 = cc.misses

    # >= 8 distinct raw (batch, seq) shapes: per class, one full batch
    # around each length scale plus a ragged tail batch
    rng = np.random.default_rng(11)
    raw_shapes = set()
    for ci, c in enumerate(CLASSES):
        for group, top in ((4, 12 + ci), (4, 30 + ci), (2, 55 + ci)):
            for j in range(group):
                eng.submit(rng.integers(0, cfg.vocab_size, size=top - j),
                           c.name)
    while eng.pending():
        rs = eng.step()
        raw_shapes.add((len(rs), max(len(r.logits) for r in rs)))
    assert len(raw_shapes) >= 8
    assert cc.misses == miss0          # warm traffic never recompiles
    assert len(cc) <= bound            # <= buckets x active plans
    rep = eng.report()
    assert rep.compile_misses == cc.misses
    assert rep.compiled_variants == len(cc)
    assert rep.compile_hits == cc.hits > 0
    assert cc.replays() == rep.batches_served


def test_warmup_requires_compiled(qwen):
    _, model, params = qwen
    eng = _batched(model, params, classes=CLASSES)
    with pytest.raises(RuntimeError):
        eng.warmup(32)
    assert eng.report().compiled_variants == 0
    with pytest.raises(RuntimeError):
        eng.engine.precompile(4, 32)


def test_shared_compile_cache_across_engines(qwen):
    """Two engines sharing one CompiledForwardCache reuse its forwards:
    the second engine's warmup compiles nothing new."""
    _, model, params = qwen
    cache = CompiledForwardCache()
    a = _batched(model, params, classes=CLASSES, max_batch=4, path="kernel",
                 compiled=True, compile_cache=cache)
    n_a = a.warmup(32)
    assert n_a == len(cache) > 0
    b = _batched(model, params, classes=CLASSES, max_batch=4, path="kernel",
                 compiled=True, compile_cache=cache)
    assert b.warmup(32) == 0
    assert b.report().compile_misses == 0
    assert b.report().compile_hits == n_a


def test_cache_views_list_calls_and_weight_sets(qwen):
    """``items()`` lists each captured call under its key, in capture
    order; ``buffer_keys()`` the agent-weight sets the engines share, to
    which a second engine over the same params adds none."""
    _, model, params = qwen
    cache = CompiledForwardCache()
    a = _batched(model, params, classes=CLASSES, max_batch=4, path="kernel",
                 compiled=True, compile_cache=cache)
    n = a.warmup(32)
    items = cache.items()
    assert len(items) == n == len(cache)
    for key, call in items:
        assert isinstance(call, CapturedCall)
        assert cache.get(key, lambda: pytest.fail("a listed key missed")) \
            is call
    sets = [k for k in cache.buffer_keys() if k[0] == "agent-weights"]
    assert sets
    _batched(model, params, classes=CLASSES, max_batch=4, path="kernel",
             compiled=True, compile_cache=cache).warmup(32)
    assert [k for k, _ in cache.items()] == [k for k, _ in items]
    assert [k for k in cache.buffer_keys() if k[0] == "agent-weights"] \
        == sets


def test_cpu_forward_is_not_captured(qwen):
    """On a CPU engine the compiled forward runs its closure as it
    stands: no graph, no recorded launches."""
    cfg, model, params = qwen
    eng = _engine(model, params, path="kernel", compiled=True)
    eng.serve_batch({"tokens": _ragged(cfg, [9])})
    (cf,) = eng.compile_cache._exe.values()
    assert cf.graph is None and cf.launches == {} and cf.replays == 1
    assert tuple(cf.tokens.shape) == (1, 16)
    assert eng.compile_cache.kernel_launches() == {}


# ---------------------------------------------------------------------------
# bucket ladders
# ---------------------------------------------------------------------------

def test_bucket_ladders():
    assert next_geometric(1, 16) == 16
    assert next_geometric(16, 16) == 16
    assert next_geometric(17, 16) == 32
    assert seq_bucket(40) == 64
    assert seq_ladder(64) == (16, 32, 64)
    assert seq_ladder(65) == (16, 32, 64, 128)
    assert seq_ladder(5, base=4) == (4, 8)
    with pytest.raises(ValueError):
        next_geometric(0, 16)


def test_engine_bucket_shape(qwen):
    _, model, params = qwen
    eng = _engine(model, params, compiled=True, batch_quantum=4)
    assert eng.bucket_shape(1, 5) == (4, 16)
    assert eng.bucket_shape(4, 17) == (4, 32)
    assert eng.bucket_shape(5, 16) == (8, 16)
    free = _engine(model, params, compiled=True)
    assert free.bucket_shape(3, 5) == (4, 16)   # pow-2 batch, no quantum


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_emb", [2, 3, 4, 5, 6, 7, 8])
def test_transport_quantize_bitwise_vs_reference(b_emb):
    """The uplink quantizer (ROADMAP C.1): bitwise the reference's, whose
    per-row loop XLA compiles with the step as amax * fl(1/levels); ragged
    lengths (0 included), n_rows < B, activations from 1e-3 to 1e3."""
    rng = np.random.default_rng(b_emb)
    for scale in (1e-3, 1.0, 1e3):
        for n_rows, lens in ((4, [64, 50, 0, 13]), (3, [1, 64, 33, 64]),
                             (2, [17, 0, 64, 64])):
            x = (rng.standard_normal((4, 64, 96)) * scale).astype(np.float32)
            lens = np.asarray(lens, np.int32)
            want = np.asarray(jtransport(jnp.asarray(x), jnp.asarray(lens),
                                         b_emb, jnp.int32(n_rows)))
            got = transport_quantize(torch.from_numpy(x),
                                     torch.from_numpy(lens), b_emb,
                                     n_rows).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


@pytest.fixture(scope="module")
def bridged():
    jcfg = jget_smoke("qwen2-0.5b")
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    model = DecoderLM(get_smoke("qwen2-0.5b"))
    return jmodel, jparams, model, params


def _workload(cfg_vocab, n, seed, lo=5, hi=60):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg_vocab, size=int(rng.integers(lo, hi))),
             CLASSES[i % 3].name) for i in range(n)]


def test_compiled_batched_matches_reference(bridged):
    """The compiled batched engines of both packages on one workload: the
    same batches in the same order, the same buckets and cache keys (up to
    the config object), equal report integers, and per-request logits
    within 1e-4."""
    jmodel, jparams, model, params = bridged
    jsysp = JSystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    jeng = JBatched(jmodel, jparams, jsysp, classes=CLASSES, max_batch=4,
                    path="kernel", compiled=True)
    teng = _batched(model, params, classes=CLASSES, max_batch=4,
                    path="kernel", compiled=True)
    assert teng.warmup(64) == jeng.warmup(64)
    work = _workload(model.cfg.vocab_size, 10, seed=7)
    for toks, qos in work:
        jeng.submit(toks, qos)
        teng.submit(toks, qos)
    while jeng.pending():
        jr, tr = jeng.step(), teng.step()
        assert [r.request_id for r in tr] == [r.request_id for r in jr]
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.logits.numpy(),
                                       np.asarray(b.logits), **TOL)
            assert a.stats.emb_bytes == b.stats.emb_bytes
            assert a.stats.b_hat == b.stats.b_hat
    assert teng.pending() == 0
    for a, b in zip(teng.batch_history, jeng.batch_history):
        assert (a.qos, a.batch_size, a.b_hat, a.agent_path, a.real_tokens,
                a.padded_tokens, a.emb_bytes) == \
            (b.qos, b.batch_size, b.b_hat, b.agent_path, b.real_tokens,
             b.padded_tokens, b.emb_bytes)
    tr_, jr_ = teng.report(), jeng.report()
    for f in ("requests_served", "batches_served", "codesign_hits",
              "codesign_misses", "compile_hits", "compile_misses",
              "compiled_variants"):
        assert getattr(tr_, f) == getattr(jr_, f), f
    # the port's keys end with the baked-in tensors' addresses (the
    # reference's executables take them as arguments)
    tkeys = sorted(k[1:6] for k in teng.engine.compile_cache._exe)
    jkeys = sorted(k[1:] for k in jeng.engine.compile_cache._exe)
    assert tkeys == jkeys
    for b, s in ((1, 5), (3, 17), (4, 64)):
        assert teng.engine.bucket_shape(b, s) == jeng.engine.bucket_shape(b,
                                                                          s)


@pytest.mark.parametrize("target", [8, 4, (4, 8)])
def test_compiled_kernel_path_matches_reference(bridged, target):
    """The compiled kernel path of both packages on one ragged batch:
    logits within 1e-4 on the real positions, and the same cache key
    (weight key, segment layout, bucket, split, b_emb)."""
    from repro.core.quantization import QuantPlan as JQuantPlan
    from repro.runtime import CoInferenceEngine as JEngine
    jmodel, jparams, model, params = bridged
    jsysp = JSystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    jeng = JEngine(jmodel, jparams, jsysp, path="kernel", compiled=True)
    teng = _engine(model, params, path="kernel", compiled=True)
    if isinstance(target, tuple):
        jeng.configure(JQuantPlan.from_layer_bits(list(target)))
        teng.configure(QuantPlan.from_layer_bits(list(target)))
    else:
        jeng.configure(target)
        teng.configure(target)
    assert teng.agent_path == jeng.agent_path
    lens = [6, 13, 16, 23]
    toks = _ragged(model.cfg, lens, seed=2)
    want, js = jeng.serve_batch({"tokens": jnp.asarray(toks)},
                                lengths=lens)
    got, ts = teng.serve_batch({"tokens": toks}, lengths=lens)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(),
                                   np.asarray(want[i, :n]), **TOL)
    assert ts.emb_row_bytes == js.emb_row_bytes
    np.testing.assert_allclose(ts.total_delay_s, js.total_delay_s,
                               rtol=1e-12)

    def plain(key):
        _, wkey, sig, bucket, split, b_emb = key[:6]
        return (wkey, tuple(d if isinstance(d, str)
                            else (d.kind, d.start, d.length) for d in sig),
                bucket, split, b_emb)

    assert [plain(k) for k in teng.compile_cache._exe] == \
        [plain(k) for k in jeng.compile_cache._exe]
