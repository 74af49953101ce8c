"""Speculative decode in the port against the JAX reference, on the CPU
(mirrors tests/test_speculative.py's seven tests and their cases).

The reference's parameters cross over through ``repro_torch.bridge``; the
same traffic goes through the JAX ``SpeculativeDecodeEngine`` and the
port's.  Delivered tokens are bitwise the JAX engine's and the port's own
batch-1 ``greedy_decode_reference``'s; ``spec_stats()`` and the report's
counts are equal; the virtual clock and energy agree at rtol 1e-12 (the
same float64 host arithmetic).  The draft and verify steps run as the
closures the card captures, uncaptured.

The rejection tests drive the port's verify chain with crafted draft
blocks, as the reference drives its ``_build_spec_verify``: delivered
block, counts, codes, positions and last tokens bitwise the JAX verify's
on the same state; the committed scales within one float32 rounding of
the JAX verify's (the fresh K/V projections are f32 sums in another
framework) and bitwise everywhere else; and the whole canonical block,
every position, bitwise the port's own batch-1 reference state after the
same tokens (commit-on-verify, port on port).
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
from repro.core import mixed_precision as jmp
from repro.core.cost_model import SystemParams as JSystemParams
from repro.core.quantization import QuantPlan as JQuantPlan
from repro.models.registry import build_model
from repro.runtime import CompiledForwardCache as JCompiledForwardCache
from repro.runtime import QosClass as JQosClass
from repro.runtime import SpeculativeDecodeEngine as JSpecEngine
from repro.runtime import greedy_decode_reference as jgreedy
from repro.runtime.decode_engine import _build_spec_verify
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import codesign as cd
from repro_torch.core import mixed_precision as mp
from repro_torch.core.cost_model import SystemParams
from repro_torch.core.quantization import QuantPlan
from repro_torch.kernels.bucketing import seq_ladder
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (CodesignCache, CompiledForwardCache,
                                 QosClass, SpeculativeDecodeEngine,
                                 greedy_decode_reference)
from repro_torch.runtime import decode_engine as de
from repro_torch.runtime.decode_engine import _SPEC_MAX_K

SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 3.5, 2.0)
SCALE_RTOL = 1e-6           # one float32 rounding of a committed scale
COUNTS = ("requests_served", "prefills", "decode_rounds",
          "tokens_generated", "kv_bytes", "kv_bytes_full", "h2d_bytes",
          "d2h_bytes")


def _pair(cfg_j, cfg_t):
    jmodel = build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, DecoderLM(cfg_t), tparams


@pytest.fixture(scope="module")
def qwen():
    return _pair(jget_smoke("qwen2-0.5b"), get_smoke("qwen2-0.5b"))


@pytest.fixture(scope="module")
def qwen_split3():
    return _pair(dataclasses.replace(jget_smoke("qwen2-0.5b"), split_layer=3),
                 dataclasses.replace(get_smoke("qwen2-0.5b"), split_layer=3))


@pytest.fixture(scope="module")
def caches():
    """One compile cache per package for the module: the reference keys
    its fused round on (cfg, batch, bucket, b_kv), the port its draft and
    verify steps on the weight trees and slot blocks, so the matrix reuses
    what it can on both sides."""
    return JCompiledForwardCache(), CompiledForwardCache()


def _ragged_traffic(cfg, n, seed, max_prompt=20, max_new=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(4, max_prompt + 1)))
        out.append((toks.astype(np.int32),
                    int(rng.integers(1, max_new + 1)), 0.05 * i))
    return out


def _spec_engines(pair, caches, target, b_kv, b_draft, k, *, max_batch=3,
                  max_new=6, **kw):
    jmodel, jparams, tmodel, tparams = pair
    jcache, tcache = caches
    jtarget = JQuantPlan.from_layer_bits(
        list(target.layer_bit_list(tmodel.cfg.split_layer))) \
        if isinstance(target, QuantPlan) else target
    jeng = JSpecEngine(jmodel, jparams, JSystemParams(**SYSP),
                       classes=[JQosClass(*QOS)], auto=False,
                       max_batch=max_batch, max_new_tokens=max_new,
                       draft_bits=b_draft, lookahead=k,
                       compile_cache=jcache)
    teng = SpeculativeDecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                                   classes=[QosClass(*QOS)], auto=False,
                                   max_batch=max_batch,
                                   max_new_tokens=max_new,
                                   draft_bits=b_draft, lookahead=k,
                                   compile_cache=tcache, device="cpu", **kw)
    jeng.set_operating_point(QOS[0], jtarget, b_kv, b_draft=b_draft, k=k)
    teng.set_operating_point(QOS[0], target, b_kv, b_draft=b_draft, k=k)
    return jeng, teng


def _assert_like_reference(jeng, teng):
    """spec_stats() and the report's counts equal, clock and energy at
    rtol 1e-12."""
    assert dataclasses.astuple(teng.spec_stats()) \
        == dataclasses.astuple(jeng.spec_stats())
    want, got = jeng.report(), teng.report()
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("total_delay_s", "total_energy_j"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12)


def _assert_parity(pair, caches, target, b_kv, b_draft, k, *, n=6):
    """The same ragged stream through both engines: tokens bitwise the JAX
    engine's and the port's batch-1 reference's, counters equal."""
    jmodel, _, tmodel, _ = pair
    jeng, teng = _spec_engines(pair, caches, target, b_kv, b_draft, k)
    prompts = {}
    for toks, n_new, t in _ragged_traffic(tmodel.cfg, n, seed=3):
        for eng in (jeng, teng):
            rid = eng.submit(toks, QOS[0], max_new_tokens=n_new,
                             arrival_s=t)
        prompts[rid] = (toks, n_new)
    want = {r.request_id: np.asarray(r.tokens) for r in jeng.drain()}
    responses = teng.drain()
    assert len(responses) == n
    for r in responses:
        toks, n_new = prompts[r.request_id]
        assert len(r.tokens) == n_new and r.b_kv == b_kv
        np.testing.assert_array_equal(r.tokens, want[r.request_id])
        ref = greedy_decode_reference(
            tmodel, teng.class_params(QOS[0]), toks, n_new, b_kv=b_kv,
            compile_cache=caches[1], device="cpu")
        np.testing.assert_array_equal(r.tokens, ref)
    _assert_like_reference(jeng, teng)
    st = teng.spec_stats()
    assert st.rounds > 0 and 0.0 <= st.acceptance_rate <= 1.0
    return teng


# ---------------------------------------------------------------------------
# parity matrix: draft rungs x cache rungs x plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_draft", [2, 4, 8])
@pytest.mark.parametrize("b_kv", [4, 8, 16])
def test_spec_parity_matrix(qwen, caches, b_draft, b_kv):
    """The (b_draft, b_kv) grid delivers the reference stream bitwise:
    draft fidelity moves acceptance, never content."""
    _assert_parity(qwen, caches, 8, b_kv, b_draft, 4)


@pytest.mark.parametrize("k", [1, 2, _SPEC_MAX_K])
def test_spec_parity_lookahead_extremes(qwen, caches, k):
    """k = 1 and k = _SPEC_MAX_K (the full drafts block) bound the
    host-driven loops; both stay bitwise."""
    _assert_parity(qwen, caches, 8, 8, 4, k)


@pytest.mark.parametrize("bits,b_kv", [((4, 8, 12), 8), ((4, 4, 6), 4)])
def test_spec_parity_mixed_plan(qwen_split3, bits, b_kv):
    """A per-layer target plan changes only the verify weight tree; the
    draft stays a uniform rung."""
    _assert_parity(qwen_split3,
                   (JCompiledForwardCache(), CompiledForwardCache()),
                   QuantPlan.from_layer_bits(list(bits)), b_kv, 4, 3)


def test_spec_fixed_verify_replays_equal_flag_reads(qwen):
    """A fixed n_draft + 1 verify steps a round (no flag read back) changes
    no delivered bit, count or buffer: the steps after every row went
    inactive restore what they write."""
    _, _, tmodel, tparams = qwen
    cfg = tmodel.cfg
    rng = np.random.default_rng(2)
    states = [greedy_decode_reference(
        tmodel, tparams, rng.integers(0, cfg.vocab_size, size=p), 1,
        b_kv=8, reserve_tokens=32 - p, return_state=True, device="cpu")[1]
        for p in (9, 14, 5)]
    live = np.asarray([1, 1, 0], np.int32)
    rem = np.asarray([5, 2, 0], np.int32)
    outs = []
    for read_flags in (True, False):
        buf = _slot_block(cfg, states, 8)
        io = buf.spec_io()
        out = de._spec_round(
            lambda: de._spec_draft_step(tmodel, 8, tparams, io),
            lambda: de._spec_verify_step(tmodel, 8, tparams, buf, io),
            buf, live, rem, 4, read_flags)
        outs.append((out, [t.clone() for t in buf.canonical()]))
    (got, gbuf), (fixed, fbuf) = outs
    assert fixed[3] == 5 >= got[3]
    for a, b in zip(got[1:3], fixed[1:3]):
        np.testing.assert_array_equal(a, b)
    for i, n in enumerate(got[1]):
        np.testing.assert_array_equal(got[0][i, :n], fixed[0][i, :n])
    for a, b in zip(gbuf, fbuf):
        assert torch.equal(a, b)


def test_spec_cancel_mid_stream(qwen, caches):
    """cancel() between rounds frees the slot, and the survivors deliver
    what they would alone and what the JAX engine delivers."""
    _, _, tmodel, _ = qwen
    jeng, teng = _spec_engines(qwen, caches, 8, 8, 4, 4, max_batch=2,
                               max_new=10)
    rng = np.random.default_rng(5)
    prompts = {}
    for i in range(3):
        toks = rng.integers(0, tmodel.cfg.vocab_size, size=20 + i)
        for eng in (jeng, teng):
            rid = eng.submit(toks, QOS[0], arrival_s=0.0)
        prompts[rid] = toks
    rids = list(prompts)
    for eng in (jeng, teng):
        for _ in range(3):
            eng.step(max_decode_steps=2)
    assert teng.in_flight == jeng.in_flight == 2
    dead = teng.cancel(rids[0])
    jdead = jeng.cancel(rids[0])
    assert dead is not None and dead.cancelled
    assert len(dead.tokens) < teng.max_new_tokens
    np.testing.assert_array_equal(dead.tokens, np.asarray(jdead.tokens))
    assert teng.cancel(rids[0]) is None
    want = {r.request_id: np.asarray(r.tokens) for r in jeng.drain()}
    survivors = {r.request_id: r for r in teng.drain()}
    assert set(survivors) == set(rids[1:]) == set(want)
    w = teng.class_params(QOS[0])
    for rid, r in survivors.items():
        assert not r.cancelled
        np.testing.assert_array_equal(r.tokens, want[rid])
        np.testing.assert_array_equal(r.tokens, greedy_decode_reference(
            tmodel, w, prompts[rid], len(r.tokens), b_kv=8,
            compile_cache=caches[1], device="cpu"))
    if len(dead.tokens):
        np.testing.assert_array_equal(dead.tokens, greedy_decode_reference(
            tmodel, w, prompts[rids[0]], len(dead.tokens), b_kv=8,
            compile_cache=caches[1], device="cpu"))
    assert teng.report().cancelled == 1
    _assert_like_reference(jeng, teng)


# ---------------------------------------------------------------------------
# rollback at every rejection position, and the clamp at pos = T
# ---------------------------------------------------------------------------

def _slot_block(cfg, states, b_kv):
    """A port slot block holding ``states`` (batch-1 states) row by row."""
    t = int(states[0]["t_bucket"])
    buf = de._SlotBuffers(cfg, t, len(states), b_kv, "cpu")
    for name in ("k_codes", "v_codes", "k_scales", "v_scales"):
        getattr(buf, name).copy_(torch.from_numpy(np.concatenate(
            [np.asarray(st[name]) for st in states], axis=1)))
    buf.pos.copy_(torch.tensor([int(st["pos"]) for st in states]))
    buf.tok.copy_(torch.tensor([int(st["last_token"]) for st in states]))
    return buf


def _verify_both(jmodel, jparams, tmodel, tparams, buf, drafts, live, rem,
                 n_draft, b_kv):
    """The JAX verify and the port's verify chain (eager closures) from the
    same state; returns the JAX outputs and the port's steps run.

    JAX gets copies of the block: on the CPU ``jnp.asarray`` of a
    tensor's ``.numpy()`` shares the tensor's memory, and JAX dispatches
    asynchronously, so the port's in-place verify could otherwise change
    the JAX verify's inputs before it read them (seen under the test
    runner's parallel workers).  Its outputs are read back before the
    port's chain runs."""
    state = [jnp.asarray(t.numpy().copy()) for t in buf.canonical()]
    jout = [np.asarray(a) for a in _build_spec_verify(jmodel, b_kv)(
        jparams, *state[:4], state[5], state[4],
        jnp.asarray(live, jnp.int32), jnp.asarray(drafts),
        jnp.asarray(n_draft, jnp.int32), jnp.asarray(rem, jnp.int32),
        jnp.asarray(-1, jnp.int32))]
    io = buf.spec_io()
    io.drafts.copy_(torch.from_numpy(drafts))
    steps = de._spec_verify_chain(
        lambda: de._spec_verify_step(tmodel, b_kv, tparams, buf, io), io,
        live, rem, n_draft)
    return jout, steps


def _assert_cache_like_jax(jout, buf, written):
    """Codes, positions and tokens bitwise the JAX verify's; scales
    bitwise outside ``written`` (row, positions) and within SCALE_RTOL on
    it."""
    _, _, _, kc, vc, ks, vs, tok, pos = jout
    np.testing.assert_array_equal(buf.k_codes.numpy(), kc)
    np.testing.assert_array_equal(buf.v_codes.numpy(), vc)
    np.testing.assert_array_equal(buf.pos.numpy(), pos)
    np.testing.assert_array_equal(buf.tok.numpy(), tok)
    for got, want in ((buf.k_scales.numpy(), ks), (buf.v_scales.numpy(), vs)):
        mask = np.zeros(got.shape, bool)
        for row, at in written:
            mask[:, row, at] = True
        np.testing.assert_array_equal(got[~mask], want[~mask])
        np.testing.assert_allclose(got[mask], want[mask], rtol=SCALE_RTOL)


@pytest.mark.parametrize("j", [0, 1, 3, 4])
def test_spec_rollback_at_rejection_positions(qwen, j):
    """Crafted drafts diverging at position j (j = k: all accepted, the
    bonus token): the delivered block is the accepted prefix plus the
    correction, as the JAX verify delivers it, and the canonical block is
    bitwise the batch-1 reference's state after those tokens at every
    position: rejected entries reverted, nothing stale."""
    jmodel, jparams, tmodel, tparams = qwen
    cfg = tmodel.cfg
    b_kv, k, budget = 8, 4, 8
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=12).astype(np.int32)
    kw = dict(b_kv=b_kv, reserve_tokens=budget, device="cpu")
    full = greedy_decode_reference(tmodel, tparams, prompt, budget, **kw)
    np.testing.assert_array_equal(full, jgreedy(
        jmodel, jparams, prompt, budget, b_kv=b_kv, reserve_tokens=budget))
    _, st = greedy_decode_reference(tmodel, tparams, prompt, 1,
                                    return_state=True, **kw)
    drafts = np.zeros((1, _SPEC_MAX_K), np.int32)
    drafts[0, :j] = full[1:j + 1]
    if j < k:
        drafts[0, j] = (full[j + 1] + 1) % cfg.vocab_size
    buf = _slot_block(cfg, [st], b_kv)
    jout, steps = _verify_both(jmodel, jparams, tmodel, tparams, buf,
                               drafts, np.ones(1, np.int32),
                               np.asarray([budget - 1], np.int32), k, b_kv)
    io = buf.spec_io()
    n_out = int(io.cnt[0])
    assert steps == n_out == j + 1 == int(jout[1][0])
    assert int(io.acc[0]) == int(jout[2][0]) == j
    np.testing.assert_array_equal(io.out[0, :n_out].numpy(), full[1:j + 2])
    np.testing.assert_array_equal(io.out[0, :n_out].numpy(),
                                  jout[0][0, :n_out])
    p0 = int(st["pos"])
    _assert_cache_like_jax(jout, buf, [(0, slice(p0, p0 + n_out))])
    _, want = greedy_decode_reference(tmodel, tparams, prompt, 1 + n_out,
                                      return_state=True, **kw)
    for name in ("k_codes", "v_codes", "k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      want[name])
    assert int(buf.pos[0]) == int(want["pos"])
    assert int(buf.tok[0]) == int(want["last_token"])


def test_spec_clamp_at_the_cache_end(qwen):
    """A row at pos = T (a request that finished at its bucket's end, or a
    draft past it) writes at T - 1 with no error: in the verify, as an
    inactive row, its write is reverted and the block equals the JAX
    verify's (whose dynamic_update_slice clamps the same way); in the
    draft chain it writes the scratch only."""
    jmodel, jparams, tmodel, tparams = qwen
    cfg = tmodel.cfg
    b_kv, k = 8, 2
    rng = np.random.default_rng(4)
    states = []
    for p_len in (10, 14):                     # both in bucket 16
        prompt = rng.integers(0, cfg.vocab_size, size=p_len).astype(np.int32)
        states.append(greedy_decode_reference(
            tmodel, tparams, prompt, 1, b_kv=b_kv,
            reserve_tokens=16 - p_len, return_state=True, device="cpu")[1])
    t = int(states[0]["t_bucket"])
    assert t == int(states[1]["t_bucket"]) == 16
    buf = _slot_block(cfg, states, b_kv)
    buf.pos[1] = t                            # row 1 sits past the cache
    before = [x.clone() for x in buf.canonical()]
    drafts = np.zeros((2, _SPEC_MAX_K), np.int32)
    jout, _ = _verify_both(jmodel, jparams, tmodel, tparams, buf, drafts,
                           np.asarray([1, 0], np.int32),
                           np.asarray([3, 0], np.int32), k, b_kv)
    p0 = int(states[0]["pos"])
    _assert_cache_like_jax(jout, buf, [(0, slice(p0, p0 + 1))])
    for now, was in zip(buf.canonical(), before):
        assert torch.equal(now[:, 1] if now.dim() > 1 else now[1],
                           was[:, 1] if was.dim() > 1 else was[1])
    # the draft chain at pos = T: the scratch's last position is written,
    # the canonical block is not
    before = [x.clone() for x in buf.canonical()]
    io = buf.spec_io()
    de._spec_draft_chain(
        lambda: de._spec_draft_step(tmodel, b_kv, tparams, io), buf, io, 3)
    for now, was in zip(buf.canonical(), before):
        assert torch.equal(now, was)
    assert io.scratch[4][1] == t + 3
    assert not torch.equal(io.scratch[0][:, 1, t - 1],
                           buf.k_codes[:, 1, t - 1])


# ---------------------------------------------------------------------------
# capture count
# ---------------------------------------------------------------------------

def test_spec_compile_count_bounded_and_warm_traffic_never_recompiles(qwen):
    """warmup() captures per class the prefill pairs and one draft and one
    verify step per cache bucket (the reference's ladder x {draft,
    verify} allowance; it fuses the two into one executable), and warm
    traffic never captures; the accounting adds up as the reference's."""
    _, _, tmodel, tparams = qwen
    cache = CompiledForwardCache()
    classes = [QosClass("rt", t0=1.0, e0=1.0),
               QosClass("ia", t0=3.0, e0=2.0)]
    eng = SpeculativeDecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                                  classes=classes, auto=False, max_batch=4,
                                  max_new_tokens=8, compile_cache=cache,
                                  device="cpu")
    eng.set_operating_point("rt", 4, 4, b_draft=4, k=2)
    eng.set_operating_point("ia", 8, 8, b_draft=8, k=4)
    max_prompt = 40
    warm = eng.warmup(max_prompt)
    t_rungs = seq_ladder(max_prompt + 8)
    pairs = sum(1 for s in seq_ladder(max_prompt) for t in t_rungs
                if t >= s)
    assert warm == (pairs + 2 * len(t_rungs)) * len(classes)
    miss0 = cache.misses
    rng = np.random.default_rng(11)
    for i in range(14):
        toks = rng.integers(0, tmodel.cfg.vocab_size,
                            size=int(rng.integers(4, max_prompt + 1)))
        eng.submit(toks, classes[i % 2].name,
                   max_new_tokens=int(rng.integers(1, 9)),
                   arrival_s=0.02 * i)
    responses = eng.drain()
    assert len(responses) == 14
    assert cache.misses == miss0
    assert len(cache) == warm
    rep = eng.report()
    assert rep.compile_misses == cache.misses
    assert rep.compiled_variants == len(cache)
    assert rep.tokens_generated == sum(len(r.tokens) for r in responses)
    st = eng.spec_stats()
    assert st.delivered == rep.tokens_generated - rep.prefills
    assert st.accepted <= st.drafted


def test_spec_engine_rejects_bad_schedule(qwen):
    _, _, tmodel, tparams = qwen
    with pytest.raises(ValueError, match="lookahead"):
        SpeculativeDecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                                classes=[QosClass(*QOS)], auto=False,
                                lookahead=0, device="cpu")
    eng = SpeculativeDecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                                  classes=[QosClass(*QOS)], auto=False,
                                  lookahead=2, device="cpu")
    with pytest.raises(ValueError, match="b_draft"):
        eng.set_operating_point(QOS[0], 8, 8, b_draft=1)
    with pytest.raises(ValueError, match="lookahead"):
        eng.set_operating_point(QOS[0], 8, 8, k=_SPEC_MAX_K + 1)


# ---------------------------------------------------------------------------
# the speculative codesign
# ---------------------------------------------------------------------------

# (T0, E0) per delivered token over the decode CLI's smoke workload
SPEC_POINTS = [(3.5, 2.0), (1.17, 1.0), (0.6, 0.5), (0.05, 0.05)]


def _spec_sysp(S):
    return S(n_flop_agent=6.4e10, n_flop_server=1.92e11,
             kv_bytes_full=1.6e9, kv_bw_bps=3.2e9, kv_power_w=2.0,
             emb_bytes_full=4.0e5, link_bps=2.5e6, tx_power_w=0.25)


def _assert_solutions_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for f in ("b_draft", "k", "b_kv"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("alpha", "tokens_per_round", "objective", "delay", "energy",
              "f", "f_server"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-9)


@pytest.mark.parametrize("t0,e0", SPEC_POINTS)
def test_solve_speculative_matches_reference(t0, e0):
    """The same λ, λ_kv and menus: the same (b̂, b_kv, b_draft, k),
    floats at rtol 1e-9, through the codesign cache's "spec" keyspace."""
    lam, lam_kv = 10.93, 1.29
    menus = dict(b_emb=8, kv_ladder=(4, 8, 16), draft_ladder=(2, 4, 8),
                 lookahead=(2, 4, 8))
    want = jcd.solve_speculative(lam, lam_kv, _spec_sysp(JSystemParams),
                                 t0, e0, **menus)
    cache = CodesignCache()
    got = cache.solve_speculative(lam, lam_kv, _spec_sysp(SystemParams),
                                  QosClass("q", t0, e0), 16, **menus)
    assert got == cd.solve_speculative(lam, lam_kv, _spec_sysp(SystemParams),
                                       t0, e0, **menus)
    _assert_solutions_equal(got, want)
    if got is not None:
        assert got.b_hat == want.b_hat
        assert got.feasible == want.feasible
    cache.solve_speculative(lam, lam_kv, _spec_sysp(SystemParams),
                            QosClass("other", t0, e0), 16, **menus)
    assert (cache.misses, cache.hits) == (1, 1)


@pytest.mark.parametrize("t0,e0", SPEC_POINTS)
def test_solve_speculative_mixed_matches_reference(t0, e0):
    """The same ``LayerStats``: the same per-layer bits and schedule."""
    lam = (9.5, 10.9, 12.3)
    sens = (1.4, 1.0, 0.7)
    want = jmp.allocate_bits_speculative(
        jmp.LayerStats(lam=lam, sens=sens), 1.29, _spec_sysp(JSystemParams),
        t0, e0, b_emb=8)
    got = CodesignCache().solve_speculative_mixed(
        mp.LayerStats(lam=lam, sens=sens), 1.29, _spec_sysp(SystemParams),
        QosClass("q", t0, e0), 16, b_emb=8)
    _assert_solutions_equal(got, want)
    if got is not None:
        assert got.bits == want.bits
        np.testing.assert_allclose(got.mean_bits, want.mean_bits,
                                   rtol=1e-9)


def test_auto_engine_resolves_like_reference(qwen):
    """``auto=True`` through ``solve_speculative`` (the engine's own λ and
    λ_kv, as the reference fits them) picks the reference's schedule and
    operating point."""
    jmodel, jparams, tmodel, tparams = qwen
    classes = [("realtime", 1.17, 1.0), ("interactive", 3.5, 2.0)]
    jeng = JSpecEngine(jmodel, jparams, _spec_sysp(JSystemParams),
                       classes=[JQosClass(*c) for c in classes],
                       compile_cache=JCompiledForwardCache())
    teng = SpeculativeDecodeEngine(tmodel, tparams, _spec_sysp(SystemParams),
                                   classes=[QosClass(*c) for c in classes],
                                   device="cpu")
    np.testing.assert_allclose(teng.lam, jeng.lam, rtol=1e-5)
    np.testing.assert_allclose(teng.lam_kv, jeng.lam_kv, rtol=1e-5)
    for name, *_ in classes:
        assert teng.draft_schedule(name) == jeng.draft_schedule(name)
        got, want = teng.solution_for(name), jeng.solution_for(name)
        assert (got.b_hat, got.b_kv) == (want.b_hat, want.b_kv)
        np.testing.assert_allclose(got.f, want.f, rtol=1e-4)
