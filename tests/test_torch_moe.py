"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe``, on the CPU.

The reference's parameters cross through ``repro_torch.bridge``; inputs
come from a numpy seed.  The same tokens pick the same experts and keep
or drop the same assignments, so outputs agree to float32 rounding (the
combine adds a token's k weighted outputs in another order than XLA's
contraction): rtol = atol = 1e-5, the aux loss at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.models import moe as jM
from repro.models.registry import build_model
from repro.runtime.qat import fake_quantize_agent as jfake_quantize_agent
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.quantization import QuantConfig
from repro_torch.models import moe as M
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime.qat import fake_quantize_agent

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """(JAX, port) smoke configs of qwen3-moe, ``kw`` replaced on both."""
    return (dataclasses.replace(jget_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke(ARCH), **kw))


def _layer(jcfg, seed):
    """One layer's ffn params: the JAX tree and its bridged copy."""
    params = build_model(jcfg).init(jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ffn"])
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _drops(cfg, p, x, group_size):
    """(dropped, total) (token, slot) assignments of one dispatch: the
    reference's queue rule recomputed in numpy from the port's routing."""
    b, s, d = x.shape
    g_sz = min(group_size, b * s)
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(int(-(-k * g_sz * cfg.capacity_factor // e)), 1)
    probs, _ = M._router_probs(cfg, p, torch.from_numpy(x).reshape(
        -1, g_sz, d))
    _, topi = M.top_k(probs, k)
    dropped = 0
    for grp in topi.numpy():                     # [Sg, k]
        seen = np.zeros(e, np.int64)
        for j in range(k):                       # slot-major order
            for t in range(g_sz):
                dropped += seen[grp[t, j]] >= cap
                seen[grp[t, j]] += 1
    return int(dropped), b * s * k


@pytest.mark.parametrize("n_experts", [8, 16])
@pytest.mark.parametrize("path", ["dense", "dispatch"])
def test_moe_matches_reference(n_experts, path):
    """``apply_moe_dense`` / ``apply_moe_dispatch`` (group 16, so two groups
    of 16 tokens) against the JAX functions: outputs and aux loss, at the
    smoke config's 8 experts and a 16-expert cut (top-2)."""
    jcfg, cfg = _cfgs(n_experts=n_experts)
    jp, tp = _layer(jcfg, 3)
    x = _x(4, (2, 16, cfg.d_model))
    if path == "dense":
        want = jM.apply_moe_dense(jcfg, jp, jnp.asarray(x))
        got = M.apply_moe_dense(cfg, tp, torch.from_numpy(x))
    else:
        want = jM.apply_moe_dispatch(jcfg, jp, jnp.asarray(x), group_size=16)
        got = M.apply_moe_dispatch(cfg, tp, torch.from_numpy(x),
                                   group_size=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_moe_dispatch_drops_like_reference(cf):
    """A capacity factor small enough that tokens are dropped (asserted):
    the port drops the same (token, slot) assignments as the reference,
    so the outputs and aux loss still agree."""
    jcfg, cfg = _cfgs(n_experts=16, capacity_factor=cf)
    jp, tp = _layer(jcfg, 5)
    x = _x(6, (2, 32, cfg.d_model))
    dropped, total = _drops(cfg, tp, x, 32)
    assert 0 < dropped < total, (dropped, total)
    want = jM.apply_moe_dispatch(jcfg, jp, jnp.asarray(x), group_size=32)
    got = M.apply_moe_dispatch(cfg, tp, torch.from_numpy(x), group_size=32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


def test_moe_chunked_dispatch_matches_reference():
    """The sequence-chunked dispatch (``max_chunk_tokens`` 32 over 2 x 64
    tokens: four chunks, aux averaged) against the reference's scan, and
    against the single-shot dispatch when nothing drops (the reference's
    tests/test_models.py check)."""
    jcfg, cfg = _cfgs(n_experts=16)
    jp, tp = _layer(jcfg, 7)
    x = _x(8, (2, 64, cfg.d_model))
    want = jM.apply_moe_dispatch(jcfg, jp, jnp.asarray(x), group_size=16,
                                 max_chunk_tokens=32)
    got = M.apply_moe_dispatch(cfg, tp, torch.from_numpy(x), group_size=16,
                               max_chunk_tokens=32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    jcfg8, cfg8 = _cfgs(capacity_factor=8.0)
    _, tp8 = _layer(jcfg8, 11)
    one = M._dispatch_one(cfg8, tp8, torch.from_numpy(x), group_size=32)[0]
    chunked = M.apply_moe_dispatch(cfg8, tp8, torch.from_numpy(x),
                                   group_size=32, max_chunk_tokens=64)[0]
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), atol=1e-5)


def test_moe_dispatch_equals_dense_when_nothing_drops():
    """At capacity factor 8 no assignment drops (asserted), and dispatch
    equals the dense oracle (the reference's tests/test_models.py:127)."""
    _, cfg = _cfgs(capacity_factor=8.0)
    jcfg, _ = _cfgs(capacity_factor=8.0)
    _, tp = _layer(jcfg, 9)
    x = _x(10, (2, 32, cfg.d_model))
    assert _drops(cfg, tp, x, 32)[0] == 0
    y_dense, a_dense = M.apply_moe_dense(cfg, tp, torch.from_numpy(x))
    y_disp, a_disp = M.apply_moe_dispatch(cfg, tp, torch.from_numpy(x),
                                          group_size=32)
    np.testing.assert_allclose(y_disp.numpy(), y_dense.numpy(), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(float(a_disp), float(a_dense), rtol=1e-6)


def test_top_k_orders_ties_like_lax():
    """Tied probabilities: descending, the lower index first, as
    ``jax.lax.top_k``; on untied rows the same as ``torch.topk``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.5, 0.0, 0.5],
                      [0.05, 0.4, 0.1, 0.15, 0.2, 0.1]], np.float32)
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = M.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tv, ti = M.top_k(torch.from_numpy(probs[3:]), 3)
    want = torch.topk(torch.from_numpy(probs[3:]), 3)
    assert torch.equal(ti, want.indices) and torch.equal(tv, want.values)


def test_moe_decode_step_q_matches_reference():
    """``decode_step_q`` at 16 experts (the dispatch path: the whole
    4-slot block one group) against the JAX ``decode_step_q`` on the same
    block and weights: logits at 1e-4, positions and every entry but the
    ones the step writes bitwise; the written entries quantize a fresh
    K/V that is an f32 sum in another framework, so their scales agree at
    1e-5 and their codes within one step."""
    from repro.kernels.quantize import kv_quantize as jkv_quantize
    jcfg, cfg = _cfgs(n_experts=16)
    jmodel, tmodel = build_model(jcfg), DecoderLM(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(13))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    b, t = 4, 32
    rng = np.random.default_rng(14)
    kv = rng.standard_normal((2, cfg.n_layers, b, t, cfg.n_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    kc, ks = (np.asarray(a) for a in jkv_quantize(jnp.asarray(kv[0]), 8))
    vc, vs = (np.asarray(a) for a in jkv_quantize(jnp.asarray(kv[1]), 8))
    pos = np.array([3, 17, 31, 9], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jc = jmodel.decode_step_q(
        jparams, {"k_codes": jnp.asarray(kc), "v_codes": jnp.asarray(vc),
                  "k_scales": jnp.asarray(ks), "v_scales": jnp.asarray(vs),
                  "len": jnp.asarray(pos)},
        {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}, b_kv=8)
    qc = {"k_codes": torch.from_numpy(kc.copy()),
          "v_codes": torch.from_numpy(vc.copy()),
          "k_scales": torch.from_numpy(ks.copy()),
          "v_scales": torch.from_numpy(vs.copy()),
          "len": torch.from_numpy(pos.copy())}
    tl, tc = tmodel.decode_step_q(
        tparams, qc, {"token": torch.from_numpy(tok),
                      "pos": torch.from_numpy(pos.copy())}, b_kv=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    written = np.zeros((cfg.n_layers, b, t), bool)
    written[:, np.arange(b), pos] = True
    for name in ("k_codes", "v_codes", "k_scales", "v_scales"):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        np.testing.assert_array_equal(got[~written], want[~written])
        if name.endswith("codes"):
            step = np.abs(got[written].astype(np.int32)
                          - want[written].astype(np.int32))
            assert step.max() <= 1, name
        else:
            np.testing.assert_allclose(got[written], want[written],
                                       rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_agent_on_expert_stacks(bits):
    """``fake_quantize_agent`` over an MoE tree (expert stacks [L, E, D, F]
    flattened to [L, E*D, F] per layer, the router [L, D, E]) equals the
    reference's for the agent layers and passes the server layers
    through, at the serving quantizer (``ste=False``)."""
    jcfg, cfg = _cfgs(n_experts=16, split_layer=2)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(15))
    want = jfake_quantize_agent(jparams, jmodel.logical_axes(), jcfg,
                                JQuantConfig(bits=bits), ste=False)
    tmodel = DecoderLM(cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    got = fake_quantize_agent(tparams, tmodel.logical_axes(), cfg,
                              QuantConfig(bits=bits), ste=False)
    for name in ("router", "wi_gate", "wi_up", "wo"):
        g = got["layers"]["ffn"][name].numpy()
        w = np.asarray(want["layers"]["ffn"][name])
        src = tparams["layers"]["ffn"][name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        assert not np.array_equal(g[:2], src[:2]), name
        np.testing.assert_array_equal(g[2:], src[2:])


def test_moe_params_cross_and_axes_match():
    """``params_from_jax`` carries the ``ffn`` subtree {router, wi_gate,
    wi_up, wo} leaf for leaf, and the port's init and logical axes have
    the reference's keys, shapes and axis names."""
    jcfg, cfg = _cfgs()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(17))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    for name, leaf in jparams["layers"]["ffn"].items():
        np.testing.assert_array_equal(tparams["layers"]["ffn"][name].numpy(),
                                      np.asarray(leaf))
    tmodel = DecoderLM(cfg)
    ours = tmodel.init(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)

    def tshapes(t):
        return {k: tshapes(v) for k, v in t.items()} \
            if isinstance(t, dict) else tuple(t.shape)
    assert tshapes(ours) == shapes
    jaxes = jmodel.logical_axes()
    assert tmodel.logical_axes()["layers"]["ffn"] == \
        jaxes["layers"]["ffn"]
    with pytest.raises(ValueError, match="moe_every=1"):
        DecoderLM(dataclasses.replace(cfg, moe_every=2))
