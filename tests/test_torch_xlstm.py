"""``repro_torch.models.xlstm_model.XLSTMModel`` against the JAX
reference's, on the CPU, at xlstm-350m's smoke config (8 layers of 64 in
two super-blocks of 3 mLSTM + 1 sLSTM, vocab 512).

The reference's parameters cross through ``repro_torch.bridge``; inputs
come from a numpy seed.  Tolerances: the loss at rtol 1e-4; the logits,
gradients and decode logits at rtol 1e-4 with an absolute floor of the
larger of 1e-4 x the output's scale and twice the reference's own
movement when its weights move by one unit in the last place (the most
over three seeded perturbations, ``_torch_recurrent.spread``).  The floor
matters here: at random weights the mLSTM's normalizer divides by small
dot products, and a one-ulp change of the reference's own weights moves
its logits by ~4.5e-4 of ~4.2 (measured), more than 1e-4 x 4.2; the
port's float32 sums in another order move them by about as much.
``prefill`` returns the reference's fresh zero-state cache (ROADMAP
C.7(d)) bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_recurrent import (assert_streams_equal_where_clear,
                              assert_within, cache_to_numpy, flat_grads,
                              greedy_streams, make_batch, model_pair,
                              port_loss_and_grads, spread, to_jax,
                              to_torch, trainer_step_histories)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.xlstm_model import XLSTMModel

ARCH = "xlstm-350m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


def test_forward_matches_reference(pair):
    jmodel, jparams, tmodel, tparams = pair
    assert isinstance(tmodel, XLSTMModel)
    batch = make_batch(tmodel.cfg, 1)
    want, _ = jmodel.forward(jparams, to_jax(batch))
    floor = spread(lambda p: jmodel.forward(p, to_jax(batch))[0], jparams,
                   want)
    got, aux = tmodel.forward(tparams, to_torch(batch))
    assert got.shape == (2, 24, tmodel.cfg.vocab_size) and aux == 0.0
    assert_within(got.numpy(), want, floor, "logits")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(pair, remat):
    """``loss`` at rtol 1e-4 and its gradient for every leaf (the
    per-leaf floor from the reference's gradient at perturbed weights)."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 2, labels=True)
    want, jgrads = jmodel.value_and_grad(jparams, to_jax(batch))
    flat = flat_grads(jgrads)
    floors = spread(lambda p: flat_grads(jmodel.grad(p, to_jax(batch))), jparams, flat)
    got, grads = port_loss_and_grads(tmodel, tparams, batch, remat=remat)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)
    assert set(flat) == set(grads)
    for path, g in flat.items():
        assert bool(np.isfinite(grads[path]).all()), path
        assert_within(grads[path], g, floors[path], str(path))


def test_remat_backward_is_bitwise_the_plain_one(pair):
    """Recomputing each super-block in the backward pass changes no bit."""
    _, _, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 3, labels=True)
    a, ga = port_loss_and_grads(tmodel, tparams, batch, remat=False)
    b, gb = port_loss_and_grads(tmodel, tparams, batch, remat=True)
    assert a == b
    for path in ga:
        np.testing.assert_array_equal(ga[path], gb[path], err_msg=str(path))


def test_prefill_returns_the_references_fresh_cache(pair):
    """``prefill``: the last position's logits, and a cache of *zero*
    states (stabilizers at -1e30) with ``len`` the prompt length, equal
    to the reference's bit for bit: the prompt's states are not kept
    (ROADMAP C.7(d))."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 4)
    jlog, jcache = jmodel.prefill(jparams, to_jax(batch))
    floor = spread(lambda p: jmodel.prefill(p, to_jax(batch))[0], jparams,
                   jlog)
    tlog, tcache = tmodel.prefill(tparams, to_torch(batch))
    assert_within(tlog.numpy(), jlog, floor, "prefill logits")
    want = cache_to_numpy(jcache)
    assert sorted(tcache) == sorted(want)
    for k, v in want.items():
        assert tcache[k].dtype == getattr(torch, str(v.dtype)), k
        np.testing.assert_array_equal(tcache[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(tcache["len"].numpy(), [24, 24])
    fresh = tmodel.init_cache(2, 0)
    for k in fresh:
        if k != "len":
            assert torch.equal(tcache[k], fresh[k]), k


def test_decode_steps_match_reference(pair):
    """Four ``decode_step``s from prefill's cache (O(1): the same for any
    cache length), each side carrying its own: logits and every state
    leaf, ``len`` counting up."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 5)
    toks = np.random.default_rng(6).integers(0, 512, (4, 2, 1)).astype(
        np.int32)
    steps = [{"token": toks[t], "pos": np.full((2,), 24 + t, np.int32)}
             for t in range(4)]

    def run(p):
        """The reference's logits and cache after each step."""
        _, cache = jmodel.prefill(p, to_jax(batch))
        out = []
        for step in steps:
            logits, cache = jmodel.decode_step(p, cache, to_jax(step))
            out.append({"logits": logits, **cache_to_numpy(cache)})
        return out

    want = run(jparams)
    floors = [spread(lambda p, t=t: run(p)[t], jparams, want[t])
              for t in range(len(steps))]
    _, tcache = tmodel.prefill(tparams, to_torch(batch))
    for t, step in enumerate(steps):
        tlog, tcache = tmodel.decode_step(tparams, tcache, to_torch(step))
        got = {"logits": tlog, **tcache}
        assert sorted(got) == sorted(want[t])
        for k, v in want[t].items():
            assert_within(got[k].numpy(), v, floors[t][k], f"step {t} {k}")
    np.testing.assert_array_equal(tcache["len"].numpy(), [28, 28])


def test_greedy_decode_matches_reference(pair):
    """Eight greedy tokens after ``prefill``: the streams agree wherever
    the reference's top-2 margin exceeds twice the logits' difference."""
    jmodel, jparams, tmodel, tparams = pair
    steps = greedy_streams(jmodel, jparams, tmodel, tparams,
                           make_batch(tmodel.cfg, 7), 8,
                           lambda m, c, side: c)
    assert_streams_equal_where_clear(steps)


def test_axes_and_config_are_the_references(pair):
    """``logical_axes``/``cache_axes`` and the full and smoke configs,
    field for field."""
    jmodel, _, tmodel, _ = pair
    assert tmodel.logical_axes() == jmodel.logical_axes()
    assert XLSTMModel(get_smoke(ARCH)).logical_axes() \
        == jmodel.logical_axes()
    assert tmodel.cache_axes() == jmodel.cache_axes()
    for ours, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke(ARCH), jget_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("tc", [{}, dict(qat_bits=8,
                                         grad_compression="int8_ef")])
def test_trainer_steps_match_reference(tc):
    """``Trainer`` drives ``XLSTMModel.loss`` as it drives
    ``DecoderLM``'s: three steps, each taken by both trainers from one
    state (QAT of the agent's super-block at 8 bits, int8 error
    feedback; ``_torch_recurrent.trainer_step_histories``), log the
    reference's loss and learning rate at rtol 1e-4 and its gradient norm
    at 5e-4: the norm is the embedding gradient's, which moves by up to
    1.4e-4 of its scale when the reference's own weights move by one ulp
    (measured)."""
    for step, (h, jh) in enumerate(trainer_step_histories(ARCH, tc), 1):
        assert h["step"] == jh["step"] == step
        for key, rtol in (("loss", 1e-4), ("grad_norm", 5e-4),
                          ("lr", 1e-4)):
            np.testing.assert_allclose(h[key], jh[key], rtol=rtol,
                                       err_msg=f"step {step} {key}")
