"""The port's tree quantizers (``repro_torch.core.quantization``) against
the JAX reference's, called eagerly, on the CPU.

Inputs come from a numpy seed; model parameters from the reference's
``init`` through ``repro_torch.bridge``.  Codes, scales and their dtypes
are ``torch.equal`` to the reference's at every bit-width and granularity
(both divide eagerly, ``absmax / levels`` and ``x / step``, and round half
to even), for single configs and mixed plans, through ``quantize``,
``quantize_tree`` and ``quantize_tree_stacked``; ``pack_int4`` /
``unpack_int4`` are bitwise.  ``max_quant_error`` and the fake quantizer
agree at rtol 1e-6 (pot-log's ``log2``/``exp2`` are each framework's
own).  The int8-resident forward of the dense decoders (and the MoE
decoder, whose expert choices agree here) is within rtol = atol = 1e-4 of
the reference's (f32 sums in another order) and bitwise the port's
forward over the dequantized tree; the recurrent, hybrid and
encoder-decoder families refuse the tree in one line, as the reference's
forwards do.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import quantization as jq
from repro.models.registry import build_model as jbuild_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import quantization as tq
from repro_torch.models.registry import build_model

BITS = (1, 2, 4, 8, 12, 16)
GRANULARITIES = ("per-tensor", "per-channel", "per-group")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, shape):
    """Seeded weights with one all-zero column (its step is 0 -> 1)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05
    x[..., 3] = 0.0
    return x


def _assert_qt_equal(got, want):
    """A port QuantizedTensor against the reference's, bitwise."""
    assert isinstance(got, tq.QuantizedTensor)
    assert isinstance(want, jq.QuantizedTensor)
    assert (got.bits, got.scheme) == (want.bits, want.scheme)
    assert str(got.codes.dtype).split(".")[-1] == str(want.codes.dtype)
    assert torch.equal(got.codes, torch.from_numpy(np.array(want.codes)))
    assert got.scale.dtype == torch.float32
    assert torch.equal(got.scale, torch.from_numpy(
        np.array(want.scale, dtype=np.float32)))


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_matches_reference(bits, granularity):
    """Codes, scales and container dtype (int8 to 8 bits, int16 above)
    bitwise; per-group at 64 rows a group over 256 rows."""
    x = _weights(bits, (256, 24))
    cfg = dict(bits=bits, granularity=granularity, group_size=64)
    got = tq.quantize(torch.from_numpy(x.copy()), tq.QuantConfig(**cfg))
    want = jq.quantize(jnp.asarray(x), jq.QuantConfig(**cfg))
    _assert_qt_equal(got, want)
    assert got.codes.dtype == (torch.int8 if bits <= 8 else torch.int16)
    assert got.shape == x.shape and got.ndim == 2
    assert got.nbytes_effective() == want.nbytes_effective()
    deq = got.dequantize()
    assert torch.equal(deq, torch.from_numpy(np.array(want.dequantize())))
    assert torch.equal(got.to(torch.float32), deq)
    assert torch.equal(got.astype(torch.float32), deq)


def test_per_group_falls_back_to_per_channel():
    """100 rows do not tile by 64: per-channel scales, as the reference."""
    x = _weights(5, (100, 24))
    cfg = dict(bits=8, granularity="per-group", group_size=64)
    got = tq.quantize(torch.from_numpy(x.copy()), tq.QuantConfig(**cfg))
    _assert_qt_equal(got, jq.quantize(jnp.asarray(x), jq.QuantConfig(**cfg)))
    assert got.scale.shape == (1, 24)


def test_quantize_raises_as_the_reference():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match=r"no integer container for "
                       r"bits=17 \(>16\)"):
        tq.quantize(x, tq.QuantConfig(bits=17))
    with pytest.raises(NotImplementedError) as got:
        tq.quantize(x, tq.QuantConfig(bits=4, scheme="pot-log"))
    with pytest.raises(NotImplementedError) as want:
        jq.quantize(jnp.zeros((4, 4)), jq.QuantConfig(bits=4,
                                                      scheme="pot-log"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="last axis must be even"):
        tq.pack_int4(torch.zeros(3, 5, dtype=torch.int8))


def test_pack_int4_matches_reference():
    """Nibbles along the last axis bitwise the reference's, and the round
    trip sign-extends every code in [-8, 7]."""
    codes = np.random.default_rng(3).integers(-8, 8, (6, 5, 32)).astype(
        np.int8)
    got = tq.pack_int4(torch.from_numpy(codes.copy()))
    want = np.array(jq.pack_int4(jnp.asarray(codes)))
    assert got.dtype == torch.int8 and got.shape == (6, 5, 16)
    assert torch.equal(got, torch.from_numpy(want))
    back = tq.unpack_int4(got)
    assert torch.equal(back, torch.from_numpy(codes))
    assert torch.equal(back, torch.from_numpy(np.array(
        jq.unpack_int4(jnp.asarray(want)))))


@pytest.mark.parametrize("scheme", ("uniform", "pot-log"))
@pytest.mark.parametrize("bits", (1, 2, 4, 8))
def test_max_quant_error_matches_reference(bits, scheme):
    x = _weights(11, (128, 16))
    for gran in GRANULARITIES:
        cfg = dict(bits=bits, scheme=scheme, granularity=gran, group_size=32)
        got = tq.max_quant_error(torch.from_numpy(x.copy()),
                                 tq.QuantConfig(**cfg))
        want = jq.max_quant_error(jnp.asarray(x), jq.QuantConfig(**cfg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        # the bound holds for the fake quantizer's realized error (uniform
        # rounds to nearest; pot-log's bound is the reference's own form)
        if scheme == "uniform" and bits > 1:
            err = (tq.quantize_dequantize(torch.from_numpy(x.copy()),
                                          tq.QuantConfig(**cfg))
                   - torch.from_numpy(x)).abs().max()
            assert float(err) <= float(got) * (1 + 1e-6)


def _tree():
    """Nested dicts and a list, 2-D and 3-D weights, a 1-D bias and an
    int leaf; the same numbers as numpy (reference) and torch (port)."""
    rng = np.random.default_rng(9)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return {"embed": {"tok": w(32, 16)},
            "enc": {"w": w(16, 16), "b": w(16)},
            "dec": {"w": w(16, 32), "blocks": [w(16, 8), w(8, 16)]},
            "layers": {"attn": {"wq": w(4, 16, 16), "bq": w(4, 16)},
                       "ffn": {"wo": w(4, 32, 16)}},
            "steps": np.arange(6, dtype=np.int32).reshape(2, 3)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _compare(got, want, exact=True):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _compare(got[k], want[k], exact)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w, exact)
    elif isinstance(want, jq.QuantizedTensor):
        _assert_qt_equal(got, want)
    elif exact:
        assert torch.equal(got, torch.from_numpy(np.array(want)))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


PLANS = {
    "uniform-8": dict(cfg=("config", dict(bits=8))),
    "per-tensor-4": dict(cfg=("config", dict(bits=4,
                                             granularity="per-tensor"))),
    "mixed": dict(cfg=("plan", dict(entries=(("enc", 4), ("dec/w", 6),
                                             ("dec/blocks/1", 2),
                                             ("layers", 3)),
                                    default_bits=8))),
    "mixed-int16": dict(cfg=("plan", dict(entries=(("enc", 12),
                                                   ("dec", 16)),
                                          default_bits=5,
                                          granularity="per-tensor"))),
}


def _cfgs(name):
    kind, kw = PLANS[name]["cfg"]
    if kind == "config":
        return tq.QuantConfig(**kw), jq.QuantConfig(**kw)
    return tq.QuantPlan(**kw), jq.QuantPlan(**kw)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_quantize_tree_matches_reference(name):
    """Every leaf by the plan's longest-prefix path match: codes and
    scales bitwise, the rest passed through; lists index by position."""
    tcfg, jcfg = _cfgs(name)
    tree = _tree()
    got = tq.quantize_tree(_to_torch(tree), tcfg)
    want = jq.quantize_tree(_to_jax(tree), jcfg)
    _compare(got, want)
    assert isinstance(got["dec"]["blocks"][1], tq.QuantizedTensor)
    assert not isinstance(got["enc"]["b"], tq.QuantizedTensor)
    assert not isinstance(got["steps"], tq.QuantizedTensor)
    # fake quantization over the same plan: the same eager division
    _compare(tq.fake_quantize_tree(_to_torch(tree), tcfg),
             jq.fake_quantize_tree(_to_jax(tree), jcfg), exact=False)


def test_tree_paths_and_plans_match_reference():
    """``tree_path_str`` of every leaf's keys, ``as_plan`` and
    ``plan_hash`` equal the reference's."""
    tree = _tree()
    jpaths = [jq.tree_path_str(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]

    def keys(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from keys(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from keys(v, path + (i,))
        else:
            yield path
    assert [tq.tree_path_str(p) for p in keys(tree)] == jpaths
    assert "dec/blocks/1" in jpaths
    for name in PLANS:
        tcfg, jcfg = _cfgs(name)
        tp, jp = tq.as_plan(tcfg), jq.as_plan(jcfg)
        assert tp.key() == jp.key()
        assert tp.plan_hash() == jp.plan_hash()
        assert tq.as_plan(tp) is tp


@pytest.fixture(scope="module")
def qwen():
    jmodel = jbuild_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    device="cpu")


STACKED = {
    "int8-per-channel": ("config", dict(bits=8)),
    "int4-per-tensor": ("config", dict(bits=4, granularity="per-tensor")),
    "int8-per-group": ("config", dict(bits=8, granularity="per-group",
                                      group_size=32)),
    "mixed-2-8": ("layers", dict(bits=(2, 4, 6, 8))),
    "mixed-int16": ("layers", dict(bits=(4, 12, 8, 16),
                                   granularity="per-group", group_size=32)),
}


def _stacked_cfgs(name):
    kind, kw = STACKED[name]
    if kind == "config":
        return tq.QuantConfig(**kw), jq.QuantConfig(**kw)
    kw = dict(kw)
    bits = kw.pop("bits")
    return (tq.QuantPlan.from_layer_bits(bits, **kw),
            jq.QuantPlan.from_layer_bits(bits, **kw))


@pytest.mark.parametrize("name", sorted(STACKED))
def test_quantize_tree_stacked_matches_reference(qwen, name):
    """qwen2-0.5b's smoke tree: the 7 stacked matrices quantized with
    per-layer scales (the reference's ``vmap``), layer i of a mixed plan
    at its own bits in one container wide enough for the widest layer,
    ``bits`` the max; the 2-D embedding and stacked vectors stay float."""
    jparams, tparams = qwen
    tcfg, jcfg = _stacked_cfgs(name)
    got = tq.quantize_tree_stacked(tparams, tcfg)
    want = jq.quantize_tree_stacked(jparams, jcfg)
    _compare(got, want)
    n = sum(isinstance(a, tq.QuantizedTensor) for a in _leaves(got))
    assert (n, len(list(_leaves(got)))) == (7, 14)
    wq = got["layers"]["attn"]["wq"]
    if name == "mixed-int16":
        assert wq.codes.dtype == torch.int16 and wq.bits == 16
    # layer i of the stack is the layer quantized alone at its bits
    plan = tq.as_plan(tcfg)
    for i, layer in enumerate(wq.unbind(0)):
        alone = tq.quantize(tparams["layers"]["attn"]["wq"][i],
                            plan.config_for_layer(i))
        assert torch.equal(layer.codes, alone.codes.to(wq.codes.dtype))
        assert torch.equal(layer.scale, alone.scale)
        assert torch.equal(wq[i].to(torch.float32), alone.dequantize())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _dequantized(tree):
    if isinstance(tree, dict):
        return {k: _dequantized(v) for k, v in tree.items()}
    if isinstance(tree, tq.QuantizedTensor):
        return tree.dequantize()
    return tree


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend != "none" or cfg.n_enc_layers:
        out["embeds"] = rng.standard_normal((b, 8, cfg.d_model)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module", params=("qwen2-0.5b", "stablelm-3b",
                                        "llava-next-mistral-7b",
                                        "qwen3-moe-235b-a22b"))
def family(request):
    """(reference config, model, params; the port's params and model) of
    one decoder at its smoke config, built once for both plans."""
    jcfg = jget_smoke(request.param)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jmodel, jparams, tparams, build_model(
        get_smoke(request.param))


@pytest.mark.parametrize("plan", ("int8-per-channel", "mixed-2-8"))
def test_int8_resident_forward_matches_reference(family, plan):
    """The forward over ``quantize_tree_stacked``'s tree (qwen2-0.5b,
    stablelm-3b, llava-next-mistral-7b, qwen3-moe-235b-a22b): within 1e-4
    of the reference's over its own, and bitwise the port's forward over
    the dequantized tree (each layer's weights dequantize on read to the
    same numbers).  qwen3-moe's smoke config routes the same tokens to the
    same experts in both frameworks here (asserted through the logits)."""
    jcfg, jmodel, jparams, tparams, model = family
    kind, kw = STACKED[plan]
    if kind == "layers":
        bits = tuple(kw["bits"][i % 4] for i in range(jcfg.n_layers))
        tcfg = tq.QuantPlan.from_layer_bits(bits)
        jqcfg = jq.QuantPlan.from_layer_bits(bits)
    else:
        tcfg, jqcfg = tq.QuantConfig(**kw), jq.QuantConfig(**kw)
    tqp = tq.quantize_tree_stacked(tparams, tcfg)
    batch = _batch(jcfg, 1)
    want, _ = jmodel.forward(jq.quantize_tree_stacked(jparams, jqcfg),
                             jax.tree_util.tree_map(jnp.asarray, batch))
    want = np.asarray(want)
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    with torch.no_grad():
        got, _ = model.forward(tqp, tb)
        deq, _ = model.forward(_dequantized(tqp), tb)
        clean, _ = model.forward(tparams, tb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, deq)
    assert torch.isfinite(got).all()
    assert float((got - clean).abs().max()) > 0.0


@pytest.mark.parametrize("arch", ("xlstm-350m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"))
def test_other_families_refuse_the_quantized_tree(arch):
    """The reference's forwards raise ``TypeError: 'QuantizedTensor'
    object is not subscriptable`` over such a tree (they index their
    weights); the port's raise the same type, in one line naming the
    config.  (The reference's own init of these three takes most of a
    minute eagerly, so the port's init supplies the weights here.)"""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v.copy()) for k, v in _batch(cfg, 2).items()}
    with pytest.raises(TypeError) as err:
        model.forward(tq.quantize_tree_stacked(params,
                                               tq.QuantConfig(bits=8)), tb)
    msg = str(err.value)
    assert "'QuantizedTensor' object is not subscriptable" in msg
    assert "\n" not in msg and msg.startswith(cfg.name)
    # the float tree still runs
    with torch.no_grad():
        assert torch.isfinite(model.forward(params, tb)[0]).all()
