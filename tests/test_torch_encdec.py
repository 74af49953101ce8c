"""``repro_torch.models.encdec.EncDecModel`` against the JAX reference's,
on the CPU, at seamless-m4t-large-v2's smoke config (2 encoder and 3
decoder layers of 64, 4 heads, GELU MLP of 160, vocab 512).

The reference's parameters cross through ``repro_torch.bridge``; inputs
(stub frame embeddings too) come from a numpy seed.  Tolerances: the loss
at rtol 1e-4; logits, gradients, caches at rtol 1e-4 with an absolute
floor of the larger of 1e-4 x the output's scale and twice the
reference's own movement under a one-ulp change of its weights
(``_torch_recurrent.spread``).  Encoder lengths on the ``seq_bucket``
grid (16, 32) compare with the reference; off it the reference attends to
the zero keys it pads onto its last block (ROADMAP C.7(b)) and the port
masks them, so a length of 20 compares with the port run through an
exact float64 numpy attention instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_recurrent import (FramesDataset, assert_streams_equal_where_clear,
                              assert_within, cache_to_numpy, flat_grads,
                              greedy_streams, make_batch, model_pair,
                              port_loss_and_grads, spread, to_jax, to_torch,
                              trainer_step_histories)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.encdec import EncDecModel

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


@pytest.mark.parametrize("s_enc,s", [(16, 24), (32, 8)])
def test_forward_matches_reference(pair, s_enc, s):
    """Logits over S_enc frames and S tokens (cross-attention S != T)."""
    jmodel, jparams, tmodel, tparams = pair
    assert isinstance(tmodel, EncDecModel)
    batch = make_batch(tmodel.cfg, 1, s=s, s_enc=s_enc)
    want, _ = jmodel.forward(jparams, to_jax(batch))
    floor = spread(lambda p: jmodel.forward(p, to_jax(batch))[0], jparams,
                   want)
    got, aux = tmodel.forward(tparams, to_torch(batch))
    assert got.shape == (2, s, tmodel.cfg.vocab_size) and aux == 0.0
    assert_within(got.numpy(), want, floor, "logits")


def _exact_attend(q, k, v, causal):
    """Float64 numpy softmax attention over every real key (GQA)."""
    qn, kn, vn = (t.detach().numpy().astype(np.float64) for t in (q, k, v))
    g = qn.shape[2] // kn.shape[2]
    kn, vn = np.repeat(kn, g, axis=2), np.repeat(vn, g, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", qn, kn) * qn.shape[-1] ** -0.5
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return torch.from_numpy(np.einsum("bhqk,bkhd->bqhd", p, vn).astype(
        np.float32))


def test_forward_off_the_bucket_grid_is_exact_attention(pair):
    """At 20 frames (off the 16/32 grid) the port's blockwise attention
    masks the keys it pads onto its last block: its logits equal the same
    model run through an exact float64 attention at 1e-4 of their scale,
    and every attention call (encoder, causal self, cross) is one
    call of :meth:`EncDecModel.attend`."""
    _, _, tmodel, tparams = pair
    calls = []

    class Exact(EncDecModel):
        def attend(self, q, k, v, causal):
            calls.append((q.shape[1], k.shape[1], causal))
            return _exact_attend(q, k, v, causal)

    batch = to_torch(make_batch(tmodel.cfg, 2, s=12, s_enc=20))
    got, _ = tmodel.forward(tparams, batch)
    want, _ = Exact(tmodel.cfg).forward(tparams, batch)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
    cfg = tmodel.cfg
    assert calls == [(20, 20, False)] * cfg.n_enc_layers \
        + [(12, 12, True), (12, 20, False)] * cfg.n_layers


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(pair, remat):
    """``loss`` at rtol 1e-4 and its gradient for every leaf."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 3, labels=True)
    want, jgrads = jmodel.value_and_grad(jparams, to_jax(batch))
    flat = flat_grads(jgrads)
    floors = spread(lambda p: flat_grads(jmodel.grad(p, to_jax(batch))),
                    jparams, flat)
    got, grads = port_loss_and_grads(tmodel, tparams, batch, remat=remat)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)
    assert set(flat) == set(grads)
    for path, g in flat.items():
        assert bool(np.isfinite(grads[path]).all()), path
        assert_within(grads[path], g, floors[path], str(path))


def _grow(model, cache, side, extra=8):
    """The self cache copied into a fresh one ``extra`` positions longer;
    the cross K/V as they are (their length is the encoder's)."""
    t = cache["k"].shape[2]
    b = cache["len"].shape[0]
    big = model.init_cache(b, 2 * (t + extra))
    if side == "jax":
        for k in ("k", "v"):
            big[k] = big[k].at[:, :, :t].set(cache[k])
        return {**big, "ek": cache["ek"], "ev": cache["ev"],
                "len": cache["len"]}
    for k in ("k", "v"):
        big[k][:, :, :t] = cache[k]
    return {**big, "ek": cache["ek"].clone(), "ev": cache["ev"].clone(),
            "len": cache["len"].clone()}


def test_prefill_matches_reference(pair):
    """``prefill``: the last position's logits, the decoder's self K/V,
    the cross K/V of the encoded frames, ``len`` the prompt length."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 4, s=12, s_enc=32)

    def ref(p):
        logits, cache = jmodel.prefill(p, to_jax(batch))
        return {"logits": logits, **cache_to_numpy(cache)}

    want = ref(jparams)
    floors = spread(ref, jparams, want)
    tlog, tcache = tmodel.prefill(tparams, to_torch(batch))
    got = {"logits": tlog, **tcache}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert_within(got[k].numpy(), v, floors[k], k)
    np.testing.assert_array_equal(tcache["len"].numpy(), [12, 12])
    # init_cache's halves: the reference's cells split a length in two
    assert tuple(tmodel.init_cache(2, 40)["ek"].shape) \
        == tuple(jmodel.init_cache(2, 40)["ek"].shape)


def test_decode_steps_match_reference(pair):
    """Four ``decode_step``s into a fresh self cache 8 positions longer
    than the prompt, each side carrying its own: logits and caches."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 5, s=12, s_enc=16)
    toks = np.random.default_rng(6).integers(0, 512, (4, 2, 1)).astype(
        np.int32)
    steps = [{"token": toks[t], "pos": np.full((2,), 12 + t, np.int32)}
             for t in range(4)]

    def run(p):
        _, cache = jmodel.prefill(p, to_jax(batch))
        cache = _grow(jmodel, cache, "jax")
        out = []
        for step in steps:
            logits, cache = jmodel.decode_step(p, cache, to_jax(step))
            out.append({"logits": logits, **cache_to_numpy(cache)})
        return out

    want = run(jparams)
    floors = [spread(lambda p, t=t: run(p)[t], jparams, want[t])
              for t in range(len(steps))]
    _, tcache = tmodel.prefill(tparams, to_torch(batch))
    tcache = _grow(tmodel, tcache, "torch")
    for t, step in enumerate(steps):
        tlog, tcache = tmodel.decode_step(tparams, tcache, to_torch(step))
        got = {"logits": tlog, **tcache}
        for k, v in want[t].items():
            assert_within(got[k].numpy(), v, floors[t][k], f"step {t} {k}")
    np.testing.assert_array_equal(tcache["len"].numpy(), [16, 16])


def test_greedy_decode_matches_reference(pair):
    """Eight greedy tokens after ``prefill``: the streams agree wherever
    the reference's top-2 margin exceeds twice the logits' difference."""
    jmodel, jparams, tmodel, tparams = pair
    steps = greedy_streams(jmodel, jparams, tmodel, tparams,
                           make_batch(tmodel.cfg, 7, s=12, s_enc=16), 8,
                           _grow)
    assert_streams_equal_where_clear(steps)


def test_axes_and_config_are_the_references(pair):
    jmodel, _, tmodel, _ = pair
    assert tmodel.logical_axes() == jmodel.logical_axes()
    assert EncDecModel(get_smoke(ARCH)).logical_axes() \
        == jmodel.logical_axes()
    assert tmodel.cache_axes() == jmodel.cache_axes()
    for ours, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke(ARCH), jget_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("tc", [{}, dict(qat_bits=8,
                                         grad_compression="int8_ef")])
def test_trainer_steps_match_reference(tc):
    """``Trainer`` trains the encoder-decoder from batches that hold
    ``embeds`` (16 seeded frames, 16 tokens): three steps, each taken by
    both trainers from one state, log the reference's loss, gradient norm
    and learning rate at rtol 1e-4."""
    data = FramesDataset(get_smoke(ARCH))
    for step, (h, jh) in enumerate(
            trainer_step_histories(ARCH, tc, dataset=data), 1):
        assert h["step"] == jh["step"] == step
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], jh[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")


ALL_ARCHS = ("stablelm-3b", "qwen2-0.5b", "granite-34b", "internlm2-20b",
             "xlstm-350m", "llava-next-mistral-7b", "seamless-m4t-large-v2",
             "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
             "fcdnn-16", "blip2-proxy", "git-proxy")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_build_model_picks_the_references_class(arch):
    """``get_config`` and ``get_smoke`` hold all 13 of the reference's
    configs, and ``models.registry.build_model`` builds the class the
    reference's does for each (fcdnn-16 has no ``ModelConfig`` on either
    side: the paper's FC model)."""
    from repro.configs import ARCH_IDS, PAPER_IDS
    from repro.models.registry import build_model as jbuild_model
    from repro_torch.models.registry import build_model
    assert set(ALL_ARCHS) == set(ARCH_IDS) | set(PAPER_IDS)
    for ours, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke(arch), jget_smoke(arch))):
        if ref is None:
            assert ours is None
            continue
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert type(build_model(ours)).__name__ \
            == type(jbuild_model(ref)).__name__
