"""The port's continuous-batching decode engine against its own batch-1
greedy reference, bitwise (port on port; mirrors tests/test_decode.py).

Every per-row op of the decode step is row-independent (the projections
through ``layers.row_matmul``, attention through a kernel whose plain
version reduces each row alone), so a request's tokens do not depend on
its batch-mates, the admission policy, or how the host cuts the steps
into chunks.  Everything here runs on the CPU with the kernels' plain
versions, the captured calls uncaptured.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.core.quantization import QuantPlan
from repro_torch.kernels.bucketing import seq_ladder
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (DecodeEngine, QosClass,
                                 greedy_decode_reference)

SYSP = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = QosClass("interactive", t0=3.5, e0=2.0)


@pytest.fixture(scope="module")
def qwen():
    model = DecoderLM(get_smoke("qwen2-0.5b"))
    params = model.init(torch.Generator().manual_seed(0))
    return model, params


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
    eng = DecodeEngine(model, params, SYSP, classes=[QOS], auto=False,
                       device="cpu", **kw)
    eng.set_operating_point(QOS.name, target, b_kv)
    return eng


def _ref(model, eng, toks, n, b_kv=8, **kw):
    return greedy_decode_reference(model, eng.class_params(QOS.name), toks,
                                   n, b_kv=b_kv, device="cpu", **kw)


def _assert_parity(model, params, target, b_kv, *, n=6, **kw):
    eng = _engine(model, params, target, b_kv, **kw)
    prompts = {}
    for toks, n_new, t in _ragged_traffic(model.cfg, n, seed=3):
        prompts[eng.submit(toks, QOS.name, max_new_tokens=n_new,
                           arrival_s=t)] = (toks, n_new)
    responses = eng.drain()
    assert len(responses) == n
    for r in responses:
        toks, n_new = prompts[r.request_id]
        assert len(r.tokens) == n_new and r.b_kv == b_kv
        np.testing.assert_array_equal(r.tokens,
                                      _ref(model, eng, toks, n_new, b_kv))
    return eng


@pytest.mark.parametrize("b_hat", [4, 8])
@pytest.mark.parametrize("b_kv", [4, 8, 16])
def test_engine_equals_batch1_reference(qwen, b_hat, b_kv):
    _assert_parity(*qwen, b_hat, b_kv)


def test_engine_equals_reference_under_a_plan(qwen):
    model, params = qwen
    _assert_parity(model, params, QuantPlan.from_layer_bits([6]), 4)


def test_barrier_policy_equals_reference(qwen):
    _assert_parity(*qwen, 8, 8, admission="barrier")


def test_continuous_equals_barrier_tokens(qwen):
    model, params = qwen
    outs = {}
    for admission in ("continuous", "barrier"):
        eng = _engine(model, params, admission=admission)
        rids = {}
        for i, (toks, n_new, t) in enumerate(
                _ragged_traffic(model.cfg, 7, seed=11)):
            rids[eng.submit(toks, QOS.name, max_new_tokens=n_new,
                            arrival_s=t)] = i
        outs[admission] = {rids[r.request_id]: r.tokens
                           for r in eng.drain()}
        assert eng.report().admission == admission
    assert outs["continuous"].keys() == outs["barrier"].keys()
    for i in outs["continuous"]:
        np.testing.assert_array_equal(outs["continuous"][i],
                                      outs["barrier"][i])


def test_streaming_matches_response(qwen):
    model, params = qwen
    eng = _engine(model, params, max_batch=2, max_new_tokens=5)
    seen = {}

    def on_token(rid, tok, t_s):
        seen.setdefault(rid, []).append((tok, t_s))

    for toks, n_new, t in _ragged_traffic(model.cfg, 4, seed=5, max_new=5):
        eng.submit(toks, QOS.name, max_new_tokens=n_new, arrival_s=t,
                   on_token=on_token)
    for r in eng.drain():
        toks = [t for t, _ in seen[r.request_id]]
        times = [s for _, s in seen[r.request_id]]
        np.testing.assert_array_equal(np.asarray(toks, np.int32), r.tokens)
        assert times == sorted(times)
        assert times[-1] <= r.finished_s + 1e-9


def test_eos_early_exit(qwen):
    model, params = qwen
    toks = np.arange(3, 15, dtype=np.int32)
    mate = np.arange(5, 25, dtype=np.int32)
    budget = 8
    eng0 = _engine(model, params, max_batch=2, max_new_tokens=budget)
    ref = _ref(model, eng0, toks, budget)
    # an eos the stream emits after its first token and never before
    cut = next(j for j in range(1, budget)
               if ref[j] not in ref[:j].tolist())
    eng = _engine(model, params, max_batch=2, max_new_tokens=budget,
                  eos_id=int(ref[cut]))
    rid_eos = eng.submit(toks, QOS.name, arrival_s=0.0)
    rid_full = eng.submit(mate, QOS.name, arrival_s=0.0)
    got = {r.request_id: r for r in eng.drain()}
    np.testing.assert_array_equal(got[rid_eos].tokens, ref[:cut + 1])
    np.testing.assert_array_equal(
        got[rid_full].tokens,
        _ref(model, eng, mate, len(got[rid_full].tokens)))


def test_one_step_rounds_equal_chunked(qwen):
    model, params = qwen
    traffic = _ragged_traffic(model.cfg, 5, seed=7)
    outs, reports = [], []
    for cap in (None, 1):
        eng = _engine(model, params)
        rids = {eng.submit(toks, QOS.name, max_new_tokens=n, arrival_s=t): i
                for i, (toks, n, t) in enumerate(traffic)}
        got = {}
        while eng.pending or eng.in_flight:
            for r in eng.step(max_decode_steps=cap):
                got[rids[r.request_id]] = r
        outs.append(got)
        reports.append(eng.report())
    for i in outs[0]:
        np.testing.assert_array_equal(outs[0][i].tokens, outs[1][i].tokens)
        assert outs[0][i].ttft_s == outs[1][i].ttft_s
        assert outs[0][i].finished_s == pytest.approx(outs[1][i].finished_s,
                                                      rel=1e-12)
    assert reports[0].decode_rounds == reports[1].decode_rounds
    assert reports[0].tokens_generated == reports[1].tokens_generated


def test_cancel_frees_the_slot_and_leaves_mates_exact(qwen):
    model, params = qwen
    eng = _engine(model, params, max_batch=2, max_new_tokens=6)
    # equal prompt lengths: all three share one bucket of two slots
    a = eng.submit(np.arange(4, 12, dtype=np.int32), QOS.name)
    b = eng.submit(np.arange(9, 17, dtype=np.int32), QOS.name)
    queued = eng.submit(np.arange(2, 10, dtype=np.int32), QOS.name)
    eng.step(max_decode_steps=1)
    assert eng.in_flight == 2 and eng.pending == 1
    part = eng.cancel(a)
    assert part.cancelled and len(part.tokens) == 2
    np.testing.assert_array_equal(
        part.tokens, _ref(model, eng, np.arange(4, 12, dtype=np.int32), 2))
    assert eng.in_flight == 1
    assert eng.cancel(a) is None and eng.cancel(12345) is None
    got = {r.request_id: r for r in eng.drain()}
    assert set(got) == {b, queued}
    for rid, toks in ((b, np.arange(9, 17)), (queued, np.arange(2, 10))):
        np.testing.assert_array_equal(
            got[rid].tokens, _ref(model, eng, toks.astype(np.int32), 6))
    rep = eng.report()
    assert rep.cancelled == 1 and rep.requests_served == 2
    # a queued request is dropped before it is admitted
    eng2 = _engine(model, params, max_batch=1)
    eng2.submit(np.arange(4, 9, dtype=np.int32), QOS.name)
    late = eng2.submit(np.arange(4, 9, dtype=np.int32), QOS.name,
                       arrival_s=5.0)
    dropped = eng2.cancel(late)
    assert dropped.cancelled and dropped.tokens.size == 0
    assert len(eng2.drain()) == 1


def test_resume_from_state_equals_uninterrupted(qwen):
    model, params = qwen
    eng = _engine(model, params, b_kv=4)
    toks = np.arange(7, 20, dtype=np.int32)
    full = _ref(model, eng, toks, 9, b_kv=4)
    head, state = _ref(model, eng, toks, 4, b_kv=4, reserve_tokens=9,
                       return_state=True)
    assert all(isinstance(v, np.ndarray) or np.isscalar(v)
               for v in state.values())
    tail = _ref(model, eng, None, 5, b_kv=4, state=state)
    np.testing.assert_array_equal(np.concatenate([head, tail]), full)


def test_dead_slot_past_the_cache_end(qwen):
    """A slot that stays dead keeps stepping with its batch-mates, and its
    position grows past the cache bucket; the write clamps to the last
    position (as the reference's dynamic_update_slice does) and the live
    rows stay exact."""
    model, params = qwen
    eng = _engine(model, params, max_batch=2, max_new_tokens=6)
    toks = np.arange(4, 8, dtype=np.int32)           # bucket 16
    for i in range(5):
        eng.submit(toks + i, QOS.name, arrival_s=1000.0 * i)
    got = eng.drain()
    assert eng.report().decode_rounds == 25 > 16
    for r in got:
        np.testing.assert_array_equal(
            r.tokens, _ref(model, eng, toks + r.request_id, 6))


def test_report_and_warmup(qwen):
    """warmup() makes one token step per cache bucket and one prefill per
    (prompt bucket, cache bucket) pair with s <= t; traffic inside its
    bounds then only hits."""
    model, params = qwen
    eng = _engine(model, params)
    n = eng.warmup(20)
    t_rungs = seq_ladder(20 + 6)
    pairs = sum(1 for s in seq_ladder(20) for t in t_rungs if t >= s)
    assert n == pairs + len(t_rungs) > 0
    for toks, n_new, t in _ragged_traffic(model.cfg, 4, seed=3):
        eng.submit(toks, QOS.name, max_new_tokens=n_new, arrival_s=t)
    eng.drain()
    rep = eng.report()
    assert rep.requests_served == 4 and rep.prefills == 4
    assert rep.compile_misses == rep.compiled_variants == n
    assert rep.compile_hits > 0
    assert rep.kv_bytes < rep.kv_bytes_full
    assert rep.classes[0].b_kv == 8 and rep.classes[0].requests == 4


def test_rejects_non_decoder_model():
    class _NoCache:
        pass

    with pytest.raises(TypeError):
        DecodeEngine(_NoCache(), {}, SYSP, classes=[QOS], device="cpu")


def test_rejects_bad_args(qwen):
    model, params = qwen
    with pytest.raises(ValueError):
        DecodeEngine(model, params, SYSP, classes=[QOS], auto=False,
                     admission="fifo", device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(model, params, SYSP, classes=[], auto=False,
                     device="cpu")
    eng = DecodeEngine(model, params, SYSP, classes=[QOS], auto=False,
                       device="cpu")
    with pytest.raises(KeyError):
        eng.submit(np.ones(4, np.int32), "no-such-class")
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32), QOS.name)
    with pytest.raises(ValueError):
        eng.submit(np.ones(4, np.int32), QOS.name, max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.set_operating_point(QOS.name, 8, 1)
    with pytest.raises(ValueError):
        greedy_decode_reference(model, params, [], 3, b_kv=8, device="cpu")


def test_unported_options_raise(qwen):
    model, params = qwen
    eng = _engine(model, params)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.snapshot_request(0)


def test_entry_points_need_a_device(qwen, monkeypatch):
    """Without a card, the engine and the reference raise unless the CPU
    is asked for by name."""
    model, params = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(model, params, SYSP, classes=[QOS], auto=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy_decode_reference(model, params, [1, 2, 3], 2, b_kv=8)
