"""Tensor-parallel compute over the mesh's ``model`` axis on gloo ranks,
against the JAX reference's one-device fit on the global batch, on the
CPU.

The ranks (``tests/_torch_ranks.py``, torch only) start once for the
module, a world of four, from the reference's initial state (qwen2-0.5b
smoke, the linear schedule, three steps):

* (data 2, model 2), a global batch of 12 x 32: the heads (4 over 2 KV
  heads) split by whole KV groups, the MLP and the vocabulary split, the
  gradients summed over ``data``; within 1e-4 of the reference (loss,
  grad norm, lr, final parameters).  Under ``activation_sharding`` with
  the sequence on ``model`` (the residual held sequence-sharded between
  blocks) the same run is bitwise the run without it;
* (data 1, model 4): qwen2's 2 KV heads do not divide 4, so attention
  computes replicated on its leaves gathered whole, while the MLP and the
  vocabulary stay split; every product of a forward shows which;
* (data 2, model 2) at 4 x 512, a multiple of the chunked
  cross-entropy's 256: the vocabulary-parallel head and loss per chunk,
  under the chunk's checkpoint.  This batch gives some of the tied
  table's elements a first gradient at Adam's eps (1e-8), rounding alone,
  so their updates follow the rounding: its parameters are held at the
  training tolerance (``_torch_fits.within_training``), and every
  element within 2e-4 of the reference's (two elements pass 1e-4, at
  1.07e-4 and 1.13e-4);
* the vocabulary-parallel lookup and cross-entropy alone at model 2 and
  4: the lookup bitwise the whole table's, the loss within 1e-6
  relative of the reference's (its chunked and unchunked forms, masked),
  the hidden states' gradient within 1e-5.

Every rank ends each fit with the same parameters, bitwise.  The case
(data 1, model 2) is ``tests/test_torch_parallel.py``'s.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_fits import (LR, leaves, ref_fit, replicas_equal, within_1e4,
                         within_training)
from _torch_ranks import join_world, put_inputs, start_world
from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jL

ARCH = "qwen2-0.5b"
B, S = 12, 32
LONG = (4, 512)
SEQ_SPEC = (("data",), "model")


def _ce_inputs(seed):
    """Hidden states, labels, a mask and the tied table at S = 32 and S =
    512 (the chunked form), from a numpy seed."""
    cfg = jget_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tok = (rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02
           ).astype(np.float32)
    out = {"tok": tok}
    for s in (S, 512):
        out[s] = {"x": rng.standard_normal((2, s, cfg.d_model)).astype(
                      np.float32),
                  "labels": rng.integers(0, cfg.vocab_size, (2, s)),
                  "mask": (rng.random((2, s)) < 0.7).astype(np.float32)}
    return out


def _serve_inputs(seed):
    """Prompts, a cache of T = 24 positions, a decode token and its
    positions, from a numpy seed (qwen2-0.5b smoke's widths)."""
    cfg = jget_smoke(ARCH)
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                np.int32),
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "token": rng.integers(0, cfg.vocab_size, (2, 1)).astype(
                np.int32),
            "pos": np.asarray([16, 21], np.int32)}


def _ref_serve(state, inp):
    """The reference's prefill and one decode step from ``state``."""
    from repro.models.registry import build_model as jbuild
    model = jbuild(jget_smoke(ARCH))
    params = jax.tree_util.tree_map(jnp.asarray, state[0])
    logits, cache = model.prefill(params, {"tokens": inp["tokens"]})
    step, _ = model.decode_step(
        params, {"k": jnp.asarray(inp["k"]), "v": jnp.asarray(inp["v"]),
                 "len": jnp.asarray(inp["pos"])},
        {"token": inp["token"], "pos": inp["pos"]})
    return {"prefill": np.asarray(logits), "k": np.asarray(cache["k"]),
            "v": np.asarray(cache["v"]), "decode": np.asarray(step)}


def _ref_ce(inp):
    """The reference's chunked CE and its gradient in x, per length."""
    cfg = jget_smoke(ARCH)
    out = {}
    for s in (S, 512):
        d = inp[s]

        def f(x):
            return jL.chunked_cross_entropy(
                cfg, x, {"tok": jnp.asarray(inp["tok"])},
                jnp.asarray(d["labels"]), jnp.asarray(d["mask"]))
        loss, g = jax.value_and_grad(f)(jnp.asarray(d["x"]))
        out[s] = (float(loss), np.asarray(g))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    cfg = jget_smoke(ARCH)
    ce = _ce_inputs(7)
    put_inputs(tmp, "ce", ce)
    state, _, _ = ref_fit(cfg, ARCH, B, S, steps=0)
    put_inputs(tmp, "plain", {"state": state, "tc": {}, "lr": LR})
    serve = _serve_inputs(8)
    put_inputs(tmp, "serve", serve)
    fit = dict(axes=("data", "model"), steps=3, inputs="plain")
    world = start_world(4, [
        ("fit_mesh", dict(shape=(2, 2), **fit)),
        ("fit_mesh", dict(shape=(2, 2), spec=SEQ_SPEC, **fit)),
        ("fit_mesh", dict(shape=(1, 4), record=True, **fit)),
        ("fit_mesh", dict(shape=(2, 2), batch=LONG[0], seq=LONG[1],
                          **fit)),
        ("vocab_ce", dict(model=2, ranks=[0, 1])),
        ("vocab_ce", dict(model=4)),
        ("serve_tp", dict(model=2, ranks=[0, 1])),
        ("serve_tp", dict(model=4))], tmp, "tp4")
    # the reference beside the ranks
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fits = {"short": pool.submit(ref_fit, cfg, ARCH, B, S),
                "long": pool.submit(ref_fit, cfg, ARCH, *LONG)}
        ranks = join_world(world, timeout=600)
        ref = {k: f.result()[1:] for k, f in fits.items()}
    ref["ce"] = _ref_ce(ce)
    ref["serve"] = _ref_serve(state, serve)
    return ref, ranks


def test_data_and_model_within_1e4_of_the_global_batch(run):
    """(data 2, model 2): every rank within 1e-4 of the reference's
    one-device fit; replicas bitwise equal."""
    ref, ranks = run
    for r in ranks:
        within_1e4(r[0], *ref["short"])
    replicas_equal(ranks, 0)


def test_activation_sharding_bitwise_its_absence(run):
    """The same (data 2, model 2) fit with the residual sequence-sharded
    between blocks (all-gather before attention and the MLP, the partial
    sums reduce-scattered: here all-reduce and a chunk) is bitwise the run
    without it: losses, grad norms and every parameter after each step."""
    _, ranks = run
    for r in ranks:
        a, b = r[0], r[1]
        assert [h["loss"] for h in a["hist"]] == [h["loss"] for h in b["hist"]]
        assert [h["grad_norm"] for h in a["hist"]] == \
            [h["grad_norm"] for h in b["hist"]]
        for pa, pb in zip(a["params"], b["params"]):
            for x, y in zip(leaves(pa), leaves(pb)):
                np.testing.assert_array_equal(x, y)


def test_model_four_attention_falls_back(run):
    """(data 1, model 4): 2 KV heads over 4 ranks would split a head, so
    the four attention leaves are gathered whole (the full 64 / 32 / 32 /
    64 columns) and attention runs replicated; the MLP (160 -> 40) and the
    tied head (512 -> 128) stay split.  Within 1e-4 of the reference;
    replicas bitwise equal."""
    ref, ranks = run
    b, s = B, S
    layer = [((b, s, 64), (64, 64)), ((b, s, 64), (64, 32)),
             ((b, s, 64), (64, 32)), ((b, s, 64), (64, 64)),
             ((b, s, 64), (64, 40)), ((b, s, 64), (64, 40)),
             ((b, s, 40), (40, 64))]
    for rank, r in enumerate(ranks):
        got = r[2]
        assert got["plan"] == dict(size=4, rank=rank, attn=False, mlp=True,
                                   vocab=True, experts=False)
        assert got["products"] == layer * 4 + [((b, s, 64), (64, 128))]
        within_1e4(got, *ref["short"])
    replicas_equal(ranks, 2)


def test_chunked_vocab_parallel_cross_entropy_fit(run):
    """(data 2, model 2) at 4 x 512: two 256-long chunks of the
    vocabulary-parallel head and loss, each checkpointed: loss, grad norm
    and lr within 1e-4 of the reference's fit, its parameters within the
    training tolerance (the port's own one-device fit comes within 0.41
    of 1e-4 there), each element within 2e-4; replicas bitwise equal."""
    ref, ranks = run
    for r in ranks:
        within_training(r[3], *ref["long"], max_diff=2e-4)
    replicas_equal(ranks, 3)


@pytest.mark.parametrize("index,model", [(4, 2), (5, 4)])
def test_vocab_parallel_lookup_and_loss(run, index, model):
    """Each rank holds 512 / model rows of the tied table: its lookup
    (own rows, zeros elsewhere, summed over ``model``) is bitwise the
    whole table's; the cross-entropy from its logit columns (max, sum of
    exponentials and the label's logit reduced) is within 1e-6 relative
    of the reference's, unchunked (S = 32) and chunked (S = 512), masked;
    the gradient in the hidden states within 1e-5."""
    ref, ranks = run
    outs = [r[index] for r in ranks if r[index] is not None]
    assert len(outs) == model
    for out in outs:
        assert out["lookup_equal"]
        for s in (S, 512):
            loss, grad = ref["ce"][s]
            got_loss, got_grad = out[s]
            np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
            np.testing.assert_allclose(got_grad, grad, rtol=1e-5,
                                       atol=1e-5 * np.abs(grad).max())


@pytest.mark.parametrize("index,model", [(6, 2), (7, 4)])
def test_tensor_parallel_prefill_and_decode(run, index, model):
    """``prefill`` and ``decode_step`` with ``tp`` (the dry-run's serving
    steps): at model 2 attention splits by KV groups, each rank's prefill
    cache its own KV head; at model 4 attention is replicated and the
    cache whole; the MLP and the vocabulary split in both.  Logits (the
    vocabulary gathered whole) and caches within 1e-4 of the reference's
    one-device prefill and decode step."""
    ref, ranks = run
    want = ref["serve"]
    outs = [r[index] for r in ranks if r[index] is not None]
    assert len(outs) == model
    for rank, out in enumerate(outs):
        assert out["attn"] == (model == 2)
        for key in ("prefill", "decode"):
            np.testing.assert_allclose(out[key], want[key], rtol=1e-4,
                                       atol=1e-4)
        for key in ("k", "v"):
            full = want[key]
            mine = (np.split(full, model, axis=3)[rank] if out["attn"]
                    else full)
            np.testing.assert_allclose(out[key], mine, rtol=1e-4,
                                       atol=1e-4)
