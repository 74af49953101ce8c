"""The decode engine's captured calls, on the CPU, port on port and
against the JAX reference.

On the CPU the prefill and token-step closures run uncaptured through the
same compile cache and keys as the card's CUDA graphs, so everything here
but the capture itself is the card's code path:

* the static-buffer closures (``_prefill_slot`` and ``_decode_step``
  under ``_decode_chunk``) equal the eager functions they replaced, kept
  below as they stood, bitwise: first tokens, token blocks, steps run,
  and every buffer (codes, scales, positions, last tokens);
* the engine equals ``greedy_decode_reference`` bitwise with and without
  ``warmup()`` and with the compile cache shared with the oracle or not,
  and warm-up changes neither tokens nor the virtual clock;
* one-step rounds equal chunked ones, with and without an eos exit, and
  an operating point pinned after ``warmup()`` serves from slot blocks
  of its own cache container;
* ``warmup()`` returns the reference engine's count where every class has
  its own b_kv and plan, the reference's times the classes sharing a b_kv
  otherwise, and traffic after it never misses, twice over;
* traced == untraced bitwise, and the trace and metrics are the JAX
  engine's on the same traffic: the same events in the same order with the
  same arguments (the reference's ``xla.compile`` is the port's
  ``forward.capture``), the same metric series and counts.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import TickClock as JTickClock
from repro.obs import Tracer as JTracer
from repro.runtime import CompiledForwardCache as JCompiledForwardCache
from repro.runtime import DecodeEngine as JDecodeEngine
from repro.runtime import QosClass as JQosClass
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.kernels.bucketing import seq_bucket, seq_ladder
from repro_torch.kernels.quantize import kv_quantize
from repro_torch.models.lm import DecoderLM
from repro_torch.obs import (MetricsRegistry, TickClock, Tracer,
                             validate_chrome_trace)
from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                 QosClass, greedy_decode_reference)
from repro_torch.runtime import decode_engine as de

SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 3.5, 2.0)


@pytest.fixture(scope="module")
def qwen():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, DecoderLM(get_smoke("qwen2-0.5b")), tparams


def _ragged_traffic(cfg, n, seed, max_prompt=20, max_new=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(4, max_prompt + 1)))
        out.append((toks.astype(np.int32),
                    int(rng.integers(1, max_new + 1)), 0.05 * i))
    return out


def _engine(model, params, target=8, b_kv=8, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_new_tokens", 6)
    eng = DecodeEngine(model, params, SystemParams(**SYSP),
                       classes=[QosClass(*QOS)], auto=False, device="cpu",
                       **kw)
    eng.set_operating_point(QOS[0], target, b_kv)
    return eng


# ---------------------------------------------------------------------------
# the eager functions the closures replaced, as they stood
# ---------------------------------------------------------------------------

@torch.no_grad()
def _old_prefill_slot(model, b_kv, weights, tokens, p_len, slot, buf):
    last = torch.full((1,), p_len - 1, dtype=torch.int32,
                      device=tokens.device)
    logits, cache = model.prefill(weights, {"tokens": tokens},
                                  last_index=last)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    k, v = cache["k"], cache["v"]
    s = k.shape[2]
    if b_kv >= 16:
        buf.k_codes[:, slot:slot + 1, :s] = k.to(buf.k_codes.dtype)
        buf.v_codes[:, slot:slot + 1, :s] = v.to(buf.v_codes.dtype)
        buf.k_scales[:, slot:slot + 1, :s] = 1.0
        buf.v_scales[:, slot:slot + 1, :s] = 1.0
    else:
        kq, ksn = kv_quantize(k, b_kv)
        vq, vsn = kv_quantize(v, b_kv)
        buf.k_codes[:, slot:slot + 1, :s] = kq
        buf.v_codes[:, slot:slot + 1, :s] = vq
        buf.k_scales[:, slot:slot + 1, :s] = ksn
        buf.v_scales[:, slot:slot + 1, :s] = vsn
    buf.pos[slot] = p_len
    buf.tok[slot:slot + 1] = tok0
    return int(tok0[0])


@torch.no_grad()
def _old_decode_chunk(model, b_kv, weights, buf, live, eos, n_steps):
    b = buf.tok.shape[0]
    out = torch.zeros((b, de._CHUNK), dtype=torch.int32)
    live_m = live > 0
    eos_hit = torch.zeros((b,), dtype=torch.bool)
    steps = 0
    while steps < n_steps:
        logits, qc = model.decode_step_q(
            weights, {"k_codes": buf.k_codes, "v_codes": buf.v_codes,
                      "k_scales": buf.k_scales, "v_scales": buf.v_scales,
                      "len": buf.pos},
            {"token": buf.tok[:, None], "pos": buf.pos}, b_kv=b_kv)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        out[:, steps] = nxt
        buf.tok, buf.pos = nxt, qc["len"]
        steps += 1
        if eos >= 0:
            eos_hit |= nxt == eos
            if not bool(torch.any(live_m & ~eos_hit)):
                break
    return out, steps


_STATE = ("k_codes", "v_codes", "k_scales", "v_scales", "pos", "tok")


def _assert_same_state(a, b):
    for name in _STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("b_kv", [4, 8, 16])
def test_closures_equal_the_eager_functions(qwen, b_kv):
    _, _, model, params = qwen
    cfg = model.cfg
    w = _engine(model, params, 8, b_kv).class_params(QOS[0])
    new = de._SlotBuffers(cfg, 64, 3, b_kv, "cpu")
    old = de._SlotBuffers(cfg, 64, 3, b_kv, "cpu")
    rng = np.random.default_rng(b_kv)
    for slot, p_len in ((0, 13), (2, 30), (1, 5)):
        toks = rng.integers(0, cfg.vocab_size, p_len).astype(np.int32)
        s = seq_bucket(p_len)
        padded = np.zeros((1, s), np.int32)
        padded[0, :p_len] = toks
        io = new.prefill_io(s)
        first = de._run_prefill(
            lambda: de._prefill_slot(model, b_kv, w, new, io), io, padded,
            p_len, slot)
        want = _old_prefill_slot(model, b_kv, w, torch.from_numpy(padded),
                                 p_len, slot, old)
        assert first == want
        _assert_same_state(new, old)
    live = np.asarray([1, 0, 1], np.int32)

    def step():
        de._decode_step(model, b_kv, w, new, new.step_io)

    blk, steps = de._decode_chunk(step, new.step_io, live, 9)
    want, want_steps = _old_decode_chunk(model, b_kv, w, old,
                                         torch.from_numpy(live), -1, 9)
    assert steps == want_steps == 9
    assert torch.equal(blk[:, :steps], want[:, :steps])
    _assert_same_state(new, old)
    # an eos that row 0 emits by the third step of the next chunk ends
    # that chunk there once row 0 is the only live row
    probe = de._SlotBuffers(cfg, 64, 3, b_kv, "cpu")
    for name in _STATE:
        getattr(probe, name).copy_(getattr(old, name))
    ahead, _ = _old_decode_chunk(model, b_kv, w, probe,
                                 torch.from_numpy(live), -1, 3)
    eos = int(ahead[0, 2])
    new.step_io = de._StepIO(3, eos, "cpu")
    only0 = np.asarray([1, 0, 0], np.int32)
    blk, steps = de._decode_chunk(step, new.step_io, only0, 9)
    want, want_steps = _old_decode_chunk(model, b_kv, w, old,
                                         torch.from_numpy(only0), eos, 9)
    assert steps == want_steps <= 3
    assert torch.equal(blk[:, :steps], want[:, :steps])
    _assert_same_state(new, old)


# ---------------------------------------------------------------------------
# engine vs oracle, warm-up, chunking
# ---------------------------------------------------------------------------

def _serve(eng, traffic, cap=None):
    rids = {eng.submit(toks, QOS[0], max_new_tokens=n, arrival_s=t): i
            for i, (toks, n, t) in enumerate(traffic)}
    got = {}
    while eng.pending or eng.in_flight:
        for r in eng.step(max_decode_steps=cap):
            got[rids[r.request_id]] = r
    return got


@pytest.mark.parametrize("shared", [False, True])
def test_engine_equals_reference_with_and_without_warmup(qwen, shared):
    _, _, model, params = qwen
    traffic = _ragged_traffic(model.cfg, 6, seed=3)
    runs = []
    for warm in (False, True):
        cache = CompiledForwardCache() if shared else None
        eng = _engine(model, params, 8, 4, compile_cache=cache)
        if warm:
            assert eng.warmup(20) > 0
        got = _serve(eng, traffic)
        hits0 = eng.compile_cache.hits
        for i, r in got.items():
            toks, n_new, _ = traffic[i]
            ref = greedy_decode_reference(
                model, eng.class_params(QOS[0]), toks, n_new, b_kv=4,
                device="cpu", compile_cache=cache)
            np.testing.assert_array_equal(r.tokens, ref)
        if shared:
            # the oracle's batch-1 graphs are reused across its calls
            assert eng.compile_cache.hits > hits0
        runs.append(got)
    cold, warm = runs
    for i in cold:
        np.testing.assert_array_equal(cold[i].tokens, warm[i].tokens)
        assert cold[i].ttft_s == warm[i].ttft_s
        assert cold[i].finished_s == warm[i].finished_s


def test_operating_point_changed_after_warmup(qwen):
    """warmup() makes the class's slot blocks ahead of traffic; a new b_kv
    pinned after it gets blocks of its own container, not the warmed
    ones."""
    _, _, model, params = qwen
    eng = _engine(model, params, 8, 8)
    eng.warmup(20)
    eng.set_operating_point(QOS[0], 4, 16)
    traffic = _ragged_traffic(model.cfg, 4, seed=5)
    for i, r in _serve(eng, traffic).items():
        toks, n_new, _ = traffic[i]
        assert r.b_kv == 16
        np.testing.assert_array_equal(r.tokens, greedy_decode_reference(
            model, eng.class_params(QOS[0]), toks, n_new, b_kv=16,
            device="cpu"))


@pytest.mark.parametrize("eos", [False, True])
def test_one_step_rounds_equal_chunked(qwen, eos):
    _, _, model, params = qwen
    traffic = _ragged_traffic(model.cfg, 5, seed=7, max_new=8)
    kw = {}
    if eos:
        # an id the first request emits mid-stream
        first = greedy_decode_reference(
            model, _engine(model, params).class_params(QOS[0]),
            traffic[0][0], traffic[0][1], b_kv=8, device="cpu")
        kw["eos_id"] = int(first[len(first) // 2])
    outs, reports = [], []
    for cap in (None, 1):
        eng = _engine(model, params, max_new_tokens=8, **kw)
        eng.warmup(20)
        outs.append(_serve(eng, traffic, cap))
        reports.append(eng.report())
    for i in outs[0]:
        np.testing.assert_array_equal(outs[0][i].tokens, outs[1][i].tokens)
        assert outs[0][i].ttft_s == outs[1][i].ttft_s
    assert reports[0].decode_rounds == reports[1].decode_rounds
    assert reports[0].tokens_generated == reports[1].tokens_generated
    assert reports[0].compile_misses == reports[1].compile_misses


# ---------------------------------------------------------------------------
# against the JAX engine: warm-up counts, traces, metrics
# ---------------------------------------------------------------------------

def _pair(qwen, points, jkw=None, tkw=None):
    """The JAX engine and the port's on two classes pinned at
    ``points`` [(b̂, b_kv), ...], each with a fresh compile cache (and
    ``jkw``/``tkw`` passed to each)."""
    jmodel, jparams, tmodel, tparams = qwen
    classes = [("rt", 1.0, 1.0), ("ia", 3.0, 2.0)]
    engines = []
    for Engine, Sysp, Qos, model, params, extra in (
            (JDecodeEngine, JSystemParams, JQosClass, jmodel, jparams,
             dict(compile_cache=JCompiledForwardCache(), **(jkw or {}))),
            (DecodeEngine, SystemParams, QosClass, tmodel, tparams,
             dict(device="cpu", **(tkw or {})))):
        eng = Engine(model, params, Sysp(**SYSP),
                     classes=[Qos(*c) for c in classes[:len(points)]],
                     auto=False, max_batch=2, max_new_tokens=4, **extra)
        for (name, _, _), (b_hat, b_kv) in zip(classes, points):
            eng.set_operating_point(name, b_hat, b_kv)
        engines.append(eng)
    return engines


def _submit_round(eng, cfg, seed):
    rng = np.random.default_rng(seed)
    names = list(eng._classes)
    for i in range(6):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 17))).astype(np.int32)
        eng.submit(toks, names[i % len(names)],
                   max_new_tokens=1 + i % 4, arrival_s=eng.clock_s + 0.01 * i)
    return eng.drain()


@pytest.mark.parametrize("points,factor", [(((4, 4), (8, 8)), 1),
                                           (((4, 8), (8, 8)), 2)])
def test_warmup_count_against_the_reference(qwen, points, factor):
    """Own b_kv per class: the reference's count; a shared b_kv: the
    reference compiles its executables once for both classes, the port
    captures a graph per class's slot block."""
    jeng, teng = _pair(qwen, points)
    n_ref = jeng.warmup(16, 4)
    n = teng.warmup(16, 4)
    t_rungs = seq_ladder(16 + 4)
    pairs = sum(1 for s in seq_ladder(16) for t in t_rungs if t >= s)
    assert n == factor * n_ref == 2 * (pairs + len(t_rungs))
    for seed in (1, 2):
        _submit_round(teng, teng.cfg, seed)
        rep = teng.report()
        assert rep.compile_misses == n and rep.compile_hits > 0
        assert rep.compiled_variants == n


def _events(tracer):
    out = []
    for e in tracer.events:
        name = "forward.capture" if e["name"] == "xla.compile" \
            else e["name"]
        out.append((e["ph"], name, tuple(sorted(e.get("args", {}).items()))))
    return out


def _series(metrics):
    out = {}
    for name, m in metrics.snapshot().items():
        for row in m["series"]:
            key = (name, m["kind"], tuple(sorted(row["labels"].items())))
            out[key] = row["count"] if m["kind"] == "histogram" \
                else row["value"]
    return out


def test_traced_equals_untraced_with_the_reference_names(qwen):
    points = ((4, 4), (8, 8))
    cfg = qwen[2].cfg
    plain = _submit_round(_pair(qwen, points)[1], cfg, 3)
    jtr, tr = JTracer(clock=JTickClock()), Tracer(clock=TickClock())
    jm, m = JMetricsRegistry(), MetricsRegistry()
    engines = _pair(qwen, points, dict(tracer=jtr, metrics=jm),
                    dict(tracer=tr, metrics=m))
    for eng in engines:
        traced = _submit_round(eng, cfg, 3)
        eng.cancel(eng.submit(np.arange(3, 9, dtype=np.int32), "ia"))
    assert [r.request_id for r in plain] == [r.request_id for r in traced]
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert validate_chrome_trace(tr.to_chrome_trace()) == []
    assert _events(tr) == _events(jtr)
    names = {e[1] for e in _events(tr)}
    assert {"decode.admit", "decode.prefill", "decode.chunk",
            "decode.retire", "forward.capture"} <= names
    assert _series(m) == _series(jm)


def _random_block(cfg, b, t, seed):
    """A slot block with a seeded random int8 cache, ragged positions (one
    row past the cache's end, where a step writes at T - 1) and tokens."""
    buf = de._SlotBuffers(cfg, t, b, 8, "cpu")
    g = torch.Generator().manual_seed(seed)
    for c in (buf.k_codes, buf.v_codes):
        c.random_(-127, 128, generator=g)
    for c in (buf.k_scales, buf.v_scales):
        c.uniform_(0.01, 0.03, generator=g)
    buf.pos.copy_(torch.tensor([3, t - 1, t][:b] + [5] * (b - 3),
                               dtype=torch.int32))
    buf.tok.random_(0, cfg.vocab_size, generator=g)
    return buf


@pytest.mark.parametrize("kind", ["prefill", "step", "draft", "verify"])
def test_capture_saves_what_its_warmup_writes(qwen, kind):
    """What a capture saves before its eager warm-up run (ROADMAP C.10:
    each row's entries at its write position, or the prefilled slot's
    rows up to its prompt bucket, and the small tensors; no copy of the
    block) covers everything the run writes: the closure run on the block
    and then the restore give back every written buffer bitwise, while
    the run alone changes the block.  The saved entries are a small part
    of the block."""
    _, _, model, params = qwen
    cfg = model.cfg
    b, t = 4, 32
    buf = _random_block(cfg, b, t, seed=7)
    io = buf.spec_io()
    for x in io.scratch:
        x.copy_(torch.randint(-5, 5, x.shape, generator=torch.Generator()
                              .manual_seed(8)).to(x.dtype))
    io.scratch[4].copy_(torch.tensor([t + 2, 4, 9, t - 1],
                                     dtype=torch.int32))
    io.scratch[5].copy_(buf.tok)
    io.act.copy_(torch.tensor([True, False, True, True]))
    if kind == "prefill":
        pio = buf.prefill_io(16)
        pio.tokens.copy_(torch.arange(16, dtype=torch.int32)[None] * 7)
        pio.last.fill_(11)
        pio.slot.fill_(2)
        run = lambda: de._prefill_slot(model, 8, params, buf, pio)  # noqa
        save = lambda: de._save_prefill(buf, pio)                     # noqa
    elif kind == "step":
        run = lambda: de._decode_step(model, 8, params, buf,          # noqa
                                      buf.step_io)
        save = lambda: de._save_entries(buf, buf.canonical()[:4],     # noqa
                                        buf.pos)
    elif kind == "draft":
        run = lambda: de._spec_draft_step(model, 8, params, io)       # noqa
        save = lambda: de._save_entries(buf, io.scratch[:4],          # noqa
                                        io.scratch[4])
    else:
        run = lambda: de._spec_verify_step(model, 8, params, buf, io)  # noqa
        save = lambda: de._save_entries(buf, buf.canonical()[:4],     # noqa
                                        buf.pos)
    before = [x.clone() for x in buf.written()]
    caches = io.scratch[:4] if kind == "draft" else buf.canonical()[:4]
    cache_before = [x.clone() for x in caches]
    restore = save()
    run()
    assert all(not torch.equal(x, y) for x, y in zip(caches, cache_before))
    restore()
    for x, y in zip(buf.written(), before):
        assert torch.equal(x, y)
    block = sum(x.numel() * x.element_size() for x in buf.canonical()[:4])
    if kind == "prefill":      # one slot of four, 16 of 32 positions
        assert restore.nbytes < block / 8 + 4096
    else:                      # one position of 32 a row
        assert restore.nbytes < block / 32 + 4096
