"""The port's layer-wise mixed precision against the JAX reference's
(``core/mixed_precision.py``), with the paper's proxy models and the
quantizer at every kernel bit-width.

* Layer statistics: qwen2-0.5b cut to widths that reach the reference's
  Pallas kernels, and its smoke config, both with the reference's
  parameters crossed over; λ^(l) and A^(l) at rtol = 1e-5 (float32
  reductions over each layer in another order).
* The allocators, given the same :class:`LayerStats`: integers equal and
  floats at rtol = 1e-12 (both float64 host math) over a (T0, E0) grid
  with infeasible corners, with and without the uplink and KV terms.
* Allocations from each package's own statistics agree where the greedy
  margin (the relative gap between the last gain spent and the best gain
  left) is wider than the statistics' measured difference; the test
  asserts that margin.
* ``group_quantize`` at bits 1-8 is bitwise the reference's, bits = 1
  included: levels = 2^0 - 1 = 0 gives codes 0 and scales +inf (ROADMAP
  C.5(c): on the kernel path a 1-bit layer serves NaN in both packages).
* The paper's proxies (blip2-proxy, git-proxy) forward at smoke size, on
  tokens and on tokens + vision embeddings, at rtol = 1e-4.
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_IDS as JPAPER_IDS
from repro.configs import get_smoke as jget_smoke
from repro.configs.qwen2_0_5b import FULL as JFULL
from repro.core import baselines as jbl
from repro.core import codesign as jcd
from repro.core import cost_model as jcm
from repro.core import mixed_precision as jmp
from repro.kernels import ops as jops
from repro.models.registry import build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import baselines as tbl
from repro_torch.core import codesign as tcd
from repro_torch.core import cost_model as tcm
from repro_torch.core import mixed_precision as tmp
from repro_torch.kernels import ops as tops
from repro_torch.models.lm import DecoderLM

RTOL = 1e-12
STATS_RTOL = 1e-5
CUT = dict(n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
           d_ff=512, vocab_size=512, split_layer=2)
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
LINK = dict(SYSP, emb_bytes_full=4.0e5, link_bps=2.0e6, tx_power_w=0.25)
KV = dict(SYSP, kv_bytes_full=3.0e4, kv_bw_bps=6.0e4, kv_power_w=2.0)
GRID = list(itertools.product([0.4, 1.1, 1.15, 1.3, 3.5],
                              [0.3, 0.95, 1.5, 4.0]))
# heterogeneous hand-made statistics beside the models' near-uniform ones
HETERO = dict(lam=(21.4, 35.0, 12.5, 18.0), sens=(1.3, 1.0, 2.1, 1.05))


def _cross(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _params(cut=None, arch="qwen2-0.5b", split=None, seed=0):
    jcfg = dataclasses.replace(JFULL, **cut) if cut \
        else jget_smoke(arch)
    if split is not None:
        jcfg = dataclasses.replace(jcfg, split_layer=split)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, jparams, _cross(jparams)


@pytest.fixture(scope="module")
def cut_stats():
    jcfg, jparams, params = _params(CUT)
    return (jmp.decoder_layer_stats(jparams, jcfg.split_layer),
            tmp.decoder_layer_stats(params, jcfg.split_layer))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


# ---------------------------------------------------------------------------
# per-layer statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["cut", "smoke-split3"])
def test_decoder_layer_stats_match_reference(which):
    if which == "cut":
        jcfg, jparams, params = _params(CUT)
    else:
        jcfg, jparams, params = _params(split=3)
    split = jcfg.split_layer
    want = jmp.decoder_layer_stats(jparams, split)
    got = tmp.decoder_layer_stats(params, split)
    assert got.n_layers == want.n_layers == split
    np.testing.assert_allclose(got.lam, want.lam, rtol=STATS_RTOL)
    np.testing.assert_allclose(got.sens, want.sens, rtol=STATS_RTOL)
    assert min(got.sens) == 1.0


def test_agent_layer_matrices_follow_the_reference_leaf_order():
    """Sorted keys, every stacked floating leaf, [out, in*] per layer."""
    jcfg, jparams, params = _params(CUT)
    want = jmp.agent_layer_matrices(jparams, 2)
    got = tmp.agent_layer_matrices(params, 2)
    assert [len(m) for m in got] == [len(m) for m in want]
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tmp.layer_lambdas(got),
                               jmp.layer_lambdas(want), rtol=STATS_RTOL)
    with pytest.raises(ValueError):
        tmp.agent_layer_matrices({"layers": {}}, 2)


def test_layer_stats_validation_and_key():
    with pytest.raises(ValueError):
        tmp.LayerStats(lam=(1.0,), sens=(1.0, 2.0))
    with pytest.raises(ValueError):
        tmp.LayerStats(lam=(), sens=())
    s = tmp.LayerStats(lam=[np.float32(2.5), 3], sens=(1, 1.5))
    assert s.lam == (2.5, 3.0) and s.n_layers == 2
    assert s.key() == jmp.LayerStats(lam=(2.5, 3.0), sens=(1.0, 1.5)).key()


# ---------------------------------------------------------------------------
# the allocators, fed the same statistics
# ---------------------------------------------------------------------------

def _same_mixed(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.bits, a.uniform_b, a.feasible, a.b_hat) == \
        (b.bits, b.uniform_b, b.feasible, b.b_hat)
    for f in ("f", "f_server", "objective", "uniform_objective",
              "mean_bits", "delay", "energy"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL,
                                   err_msg=f)


def _same_decode(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.b_kv == b.b_kv and a.bits == b.bits
    _same_mixed(a.inner, b.inner)
    for f in ("objective", "kv_gap", "delay", "energy", "f", "f_server",
              "mean_bits"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("sysp", [SYSP, LINK], ids=["compute", "link"])
@pytest.mark.parametrize("stats_kind", ["model", "hetero"])
def test_allocate_bits_matches_reference(cut_stats, sysp, stats_kind):
    stats = cut_stats[0] if stats_kind == "model" \
        else jmp.LayerStats(**HETERO)
    tstats = tmp.LayerStats(lam=stats.lam, sens=stats.sens)
    tp, jp = tcm.SystemParams(**sysp), jcm.SystemParams(**sysp)
    n_feasible = 0
    for t0, e0 in GRID:
        for b_emb in (None, 8):
            want = jmp.allocate_bits(stats, jp, t0, e0, b_emb=b_emb)
            got = tmp.allocate_bits(tstats, tp, t0, e0, b_emb=b_emb)
            _same_mixed(got, want)
            n_feasible += want is not None
            assert tmp.max_mean_bits(tp, t0, e0, b_emb=b_emb) == \
                jmp.max_mean_bits(jp, t0, e0, b_emb=b_emb)
            assert tmp.best_uniform_bits(tp, t0, e0, b_emb=b_emb) == \
                jmp.best_uniform_bits(jp, t0, e0, b_emb=b_emb)
        for b_max in (4, 8):
            _same_mixed(tmp.allocate_bits(tstats, tp, t0, e0, b_max=b_max),
                        jmp.allocate_bits(stats, jp, t0, e0, b_max=b_max))
    # the grid holds infeasible corners and feasible points
    assert 0 < n_feasible < 2 * len(GRID)
    assert tmp.allocation_objective(tstats, [3] * tstats.n_layers) == \
        jmp.allocation_objective(stats, [3] * stats.n_layers)
    assert tmp.uniform_objective(tstats, 5) == jmp.uniform_objective(stats, 5)


@pytest.mark.parametrize("stats_kind", ["model", "hetero"])
def test_allocate_bits_decode_matches_reference(cut_stats, stats_kind):
    stats = cut_stats[0] if stats_kind == "model" \
        else jmp.LayerStats(**HETERO)
    tstats = tmp.LayerStats(lam=stats.lam, sens=stats.sens)
    tp, jp = tcm.SystemParams(**KV), jcm.SystemParams(**KV)
    rungs = set()
    for t0, e0 in GRID + [(2.0, 1.2), (2.0, 6.0)]:
        for b_emb, ladder, w in ((None, (4, 8, 16), 1.0), (8, (4, 8), 0.3)):
            want = jmp.allocate_bits_decode(stats, 2.7, jp, t0, e0,
                                            b_emb=b_emb, kv_ladder=ladder,
                                            kv_weight=w)
            got = tmp.allocate_bits_decode(tstats, 2.7, tp, t0, e0,
                                           b_emb=b_emb, kv_ladder=ladder,
                                           kv_weight=w)
            _same_decode(got, want)
            rungs.add(None if want is None else want.b_kv)
    assert None in rungs and len(rungs) >= 3, rungs


@pytest.mark.parametrize("t0,e0", [(0.4, 0.3), (1.3, 1.5), (3.5, 4.0),
                                   (2.0, 1.2)])
def test_allocate_bits_speculative_matches_reference(cut_stats, t0, e0):
    stats = cut_stats[0]
    tstats = tmp.LayerStats(lam=stats.lam, sens=stats.sens)
    tp, jp = tcm.SystemParams(**KV), jcm.SystemParams(**KV)
    for b_emb in (None, 8):
        want = jmp.allocate_bits_speculative(stats, 2.7, jp, t0, e0,
                                             b_emb=b_emb)
        got = tmp.allocate_bits_speculative(tstats, 2.7, tp, t0, e0,
                                            b_emb=b_emb)
        if want is None:
            assert got is None
            continue
        assert (got.b_draft, got.k, got.b_kv, got.bits) == \
            (want.b_draft, want.k, want.b_kv, want.bits)
        _same_decode(got.inner, want.inner)
        for f in ("alpha", "tokens_per_round", "objective", "delay",
                  "energy", "f", "f_server", "mean_bits"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, err_msg=f)


def test_speculative_cost_terms_match_reference():
    tp, jp = tcm.SystemParams(**LINK, kv_bytes_full=3e4, kv_bw_bps=6e4,
                              kv_power_w=2.0), \
        jcm.SystemParams(**LINK, kv_bytes_full=3e4, kv_bw_bps=6e4,
                         kv_power_w=2.0)
    for b, f, fs, k, tau in itertools.product([2, 4, 8], [0.5e9, 2e9],
                                              [1e9, 10e9], [2, 4], [1.5]):
        for name, args in (("draft_delay", (b, k)), ("draft_energy", (b, k)),
                           ("verify_delay", (b, f, fs, k)),
                           ("verify_energy", (b, f, fs, k)),
                           ("rollback_delay", (b, 1.7)),
                           ("rollback_energy", (b, 1.7))):
            np.testing.assert_allclose(getattr(tcm, name)(*args, tp),
                                       getattr(jcm, name)(*args, jp),
                                       rtol=RTOL)
        for name in ("speculative_round_delay", "speculative_round_energy"):
            for kw in ({}, dict(b_emb=8, b_kv=8)):
                np.testing.assert_allclose(
                    getattr(tcm, name)(b, f, fs, 4, k, tau, tp, **kw),
                    getattr(jcm, name)(b, f, fs, 4, k, tau, jp, **kw),
                    rtol=RTOL)
        for name in ("total_delay", "total_energy"):
            np.testing.assert_allclose(
                getattr(tcm, name)(b, f, fs, tp, b_emb=8, b_kv=4),
                getattr(jcm, name)(b, f, fs, jp, b_emb=8, b_kv=4),
                rtol=RTOL)
    for b in (2, 4, 8):
        assert tcd.acceptance_rate(b, 23.0) == jcd.acceptance_rate(b, 23.0)
        for k in (2, 4, 8):
            a = tcd.acceptance_rate(b, 23.0)
            assert tcd.expected_tokens_per_round(a, k) == \
                jcd.expected_tokens_per_round(a, k)
    assert tcd.expected_tokens_per_round(1.0, 4) == 5.0
    for d in (-1.0, 0.0, 0.3, 5.0):
        assert tcd.acceptance_from_distortion(d) == \
            jcd.acceptance_from_distortion(d)


@pytest.mark.parametrize("t0,e0", [(0.4, 0.3), (1.1, 1.5), (3.5, 4.0)])
def test_solve_feasible_random_matches_reference(t0, e0):
    tp, jp = tcm.SystemParams(**SYSP), jcm.SystemParams(**SYSP)
    got = tbl.solve_feasible_random(23.7, tp, t0, e0, trials=120, seed=3)
    want = jbl.solve_feasible_random(23.7, jp, t0, e0, trials=120, seed=3)
    assert [s.b_hat for s in got] == [s.b_hat for s in want]
    for a, b in zip(got, want):
        for f in ("f", "f_server", "objective", "delay", "energy"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL)


@pytest.mark.parametrize("bits", [(5, 4), (16,), (1, 3, 8, 12)])
@pytest.mark.parametrize("scheme", ["uniform", "pot-log"])
def test_plan_from_bits_key_matches_reference(bits, scheme):
    got = tmp.plan_from_bits(bits, scheme=scheme)
    want = jmp.plan_from_bits(bits, scheme=scheme)
    assert got.key() == want.key()
    assert got.layer_bit_list(len(bits) + 1) == \
        want.layer_bit_list(len(bits) + 1)


# ---------------------------------------------------------------------------
# allocations from each package's own statistics
# ---------------------------------------------------------------------------

def _greedy_margin(stats, sol, b_max=16):
    """Relative gap between the smallest gain the allocator spent and the
    largest it left: a perturbation of the gains below it cannot change
    the allocation."""
    def gain(l, b):
        return stats.sens[l] * (tcd._d_upper(b - 1.0, stats.lam[l])
                                - tcd._d_upper(float(b), stats.lam[l]))
    spent = [gain(l, b - 1) for l, b in enumerate(sol.bits) if b > 1]
    left = [gain(l, b) for l, b in enumerate(sol.bits) if b < b_max]
    if not spent or not left:
        return math.inf
    return (min(spent) - max(left)) / min(spent)


@pytest.mark.parametrize("t0,e0", [(1.12, 1.05), (1.1, 1.5), (1.18, 0.9),
                                   (1.6, 1.05)])
def test_own_stats_allocations_match_reference(cut_stats, t0, e0):
    jstats, tstats = cut_stats
    tp, jp = tcm.SystemParams(**SYSP), jcm.SystemParams(**SYSP)
    diff = max(_rel(tstats.lam, jstats.lam), _rel(tstats.sens, jstats.sens))
    got = tmp.allocate_bits(tstats, tp, t0, e0, b_emb=8)
    want = jmp.allocate_bits(jstats, jp, t0, e0, b_emb=8)
    margin = _greedy_margin(tstats, got)
    # a gain moves by at most ~ (|d sens| + |d lam|) relative
    assert margin > 10 * 2 * diff, (margin, diff)
    assert got.bits == want.bits and len(set(got.bits)) > 1
    for f in ("f", "f_server", "mean_bits", "delay", "energy"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-5)


# ---------------------------------------------------------------------------
# the reference's own properties, on the port
# ---------------------------------------------------------------------------

def test_max_mean_bits_monotone_and_uniform_floor():
    p = tcm.SystemParams(**SYSP)
    prev = 0.0
    for t0 in (1.1, 1.2, 1.4, 1.8):
        b = tmp.max_mean_bits(p, t0, 2.0)
        assert b is None or b >= prev
        prev = b or prev
    for t0, e0 in ((1.15, 0.95), (1.3, 1.5), (1.6, 2.5)):
        assert tmp.best_uniform_bits(p, t0, e0) == \
            tcd.solve_oracle(30.0, p, t0, e0).b_hat
    assert tmp.max_mean_bits(p, 1e-9, 1e-9) is None


def test_allocator_infeasible_and_degenerate():
    p = tcm.SystemParams(**SYSP)
    stats = tmp.LayerStats(lam=(30.0,), sens=(1.0,))
    assert tmp.allocate_bits(stats, p, 1e-9, 1e-9) is None
    sol = tmp.allocate_bits(stats, p, 1.3, 1.5)
    assert sol.bits == (sol.uniform_b,)
    assert sol.objective == pytest.approx(sol.uniform_objective)


def test_allocator_never_worse_and_strictly_better_somewhere():
    _, _, params = _params(split=3)
    stats = tmp.decoder_layer_stats(params, 3)
    p = tcm.SystemParams(**SYSP)
    strict = 0
    for t0, e0 in ((1.12, 0.92), (1.18, 1.05), (1.3, 1.5), (1.6, 2.5)):
        sol = tmp.allocate_bits(stats, p, t0, e0)
        assert sol.mean_bits <= tmp.max_mean_bits(p, t0, e0) + 1e-9
        assert sol.delay <= t0 * (1 + 1e-6)
        assert sol.energy <= e0 * (1 + 1e-6)
        assert all(1 <= b <= 16 for b in sol.bits)
        assert sol.objective <= sol.uniform_objective * (1 + 1e-9)
        strict += sol.objective < sol.uniform_objective * (1 - 1e-6)
    assert strict >= 1


# ---------------------------------------------------------------------------
# the quantizer at every kernel bit-width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("shape", [(256, 384), (200, 130)])
def test_quantize_linear_matches_reference_at_every_bit_width(bits, shape):
    """Codes (nibble-packed at <= 4 bits) and scales bitwise, on the
    reference's Pallas route (256 x 384) and its fallback (200 x 130)."""
    w = np.random.default_rng(bits).standard_normal(shape).astype(
        np.float32)
    w[:, 0] = 0.0                                  # an all-zero group
    want = jops.quantize_linear(jnp.asarray(w), bits=bits)
    got = tops.quantize_linear(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    if bits == 1:
        # ROADMAP C.5(c): levels = 0, so every code is 0 and every scale of
        # a nonzero group +inf, in both packages (the kernel path then
        # computes 0 * inf = NaN: no serving run allocates 1 bit)
        assert not got.codes.any()
        s = got.scales.numpy()
        assert np.isposinf(s[:, 1:]).all() and (s[:, 0] == 1.0).all()


# ---------------------------------------------------------------------------
# the paper's evaluation models
# ---------------------------------------------------------------------------

def test_paper_ids_registered():
    assert tconfigs.PAPER_IDS == JPAPER_IDS
    assert tconfigs.get_config("fcdnn-16") is None
    assert tconfigs.get_smoke("fcdnn-16") is None
    for arch in ("blip2-proxy", "git-proxy"):
        from repro.configs import get_config as jget_config
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(tconfigs.get_smoke(arch)) == \
            dataclasses.asdict(jget_smoke(arch))


@pytest.mark.parametrize("arch", ["blip2-proxy", "git-proxy"])
@pytest.mark.parametrize("with_embeds", [False, True])
def test_proxy_smoke_forward_matches_reference(arch, with_embeds):
    jcfg = jget_smoke(arch)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    batch = {"tokens": tokens}
    if with_embeds:
        batch["embeds"] = rng.standard_normal(
            (2, 6, jcfg.d_model)).astype(np.float32)
    want, _ = jmodel.forward(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    model = DecoderLM(tconfigs.get_smoke(arch))
    got, _ = model.forward(_cross(jparams),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == want.shape == (2, 16 if with_embeds else 10,
                                       jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # and its agent statistics, over the proxy's LayerNorm/GELU layers
    stats = tmp.decoder_layer_stats(_cross(jparams), jcfg.split_layer)
    want_stats = jmp.decoder_layer_stats(jparams, jcfg.split_layer)
    np.testing.assert_allclose(stats.lam, want_stats.lam, rtol=STATS_RTOL)
    np.testing.assert_allclose(stats.sens, want_stats.sens, rtol=STATS_RTOL)


def test_git_proxy_takes_per_element_groups():
    """git-proxy's d_model = 192 does not tile into G = 128: the reference
    falls to per-element groups, and so does the port's layout."""
    d = tconfigs.get_config("git-proxy").d_model
    assert tops.group_layout(d, 128) == 1
    w = np.random.default_rng(0).standard_normal((d, 256)).astype(np.float32)
    want = jops.group_quantize(jnp.asarray(w), bits=8)
    got = tops.group_quantize(torch.from_numpy(w), bits=8)
    assert got[1].shape == (d, 256)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
