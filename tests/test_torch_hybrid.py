"""``repro_torch.models.hybrid.HybridLM`` against the JAX reference's
``HybridLM``, on the CPU, at jamba-1.5-large-398b's smoke config (one
super-block: 7 Mamba layers and 1 attention layer of 4 heads over 2 KV
heads, MoE of 4 experts top-2 on the odd slots, vocab 512).

The reference's parameters cross through ``repro_torch.bridge``; inputs
come from a numpy seed.  Tolerances: the loss at rtol 1e-4 and the MoE
aux loss at rtol 1e-6; logits, gradients, caches at rtol 1e-4 with an
absolute floor of the larger of 1e-4 x the output's scale and twice the
reference's own movement under a one-ulp change of its weights
(``_torch_recurrent.spread``; ~1.1e-4 of the logits' 4.4, measured).
``prefill`` keeps the prompt's K/V and returns *zero* Mamba states, as
the reference's (ROADMAP C.7(d)).  On the CPU the attention layer runs
the plain blockwise attention; on the card it is one flash-kernel launch
per forward, which :meth:`HybridLM.attend` counts here too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_recurrent import (assert_streams_equal_where_clear,
                              assert_within, cache_to_numpy, flat_grads,
                              greedy_streams, make_batch, model_pair,
                              port_loss_and_grads, spread, to_jax, to_torch,
                              trainer_step_histories)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.hybrid import HybridLM

ARCH = "jamba-1.5-large-398b"


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
    """Logits, and the MoE layers' load-balancing loss at rtol 1e-6."""
    jmodel, jparams, tmodel, tparams = pair
    assert isinstance(tmodel, HybridLM)
    batch = make_batch(tmodel.cfg, 1)
    want, jaux = jmodel.forward(jparams, to_jax(batch))
    floor = spread(lambda p: jmodel.forward(p, to_jax(batch))[0], jparams,
                   want)
    got, aux = tmodel.forward(tparams, to_torch(batch))
    assert got.shape == (2, 24, tmodel.cfg.vocab_size)
    assert_within(got.numpy(), want, floor, "logits")
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_forward_attends_once_per_super_block(pair):
    """Every full-sequence pass attends through :meth:`HybridLM.attend`
    once per super-block (one flash launch each on the card), causally
    over the whole sequence."""
    _, _, tmodel, tparams = pair
    calls = []

    class Counting(HybridLM):
        def attend(self, q, k, v):
            calls.append((tuple(q.shape), tuple(k.shape)))
            return super().attend(q, k, v)

    model = Counting(tmodel.cfg)
    cfg = tmodel.cfg
    batch = to_torch(make_batch(cfg, 2, s=20))
    model.forward(tparams, batch)
    model.prefill(tparams, batch)
    shape = (2, 20, cfg.n_heads, cfg.head_dim)
    kv = (2, 20, cfg.n_kv_heads, cfg.head_dim)
    assert calls == [(shape, kv)] * (2 * model.n_blocks)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(pair, remat):
    """``loss`` (CE + 0.01 x aux) at rtol 1e-4 and its gradient for every
    leaf."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 3, labels=True)
    want, jgrads = jmodel.value_and_grad(jparams, to_jax(batch))
    flat = flat_grads(jgrads)
    floors = spread(lambda p: flat_grads(jmodel.grad(p, to_jax(batch))), jparams, flat)
    got, grads = port_loss_and_grads(tmodel, tparams, batch, remat=remat)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)
    assert set(flat) == set(grads)
    for path, g in flat.items():
        assert bool(np.isfinite(grads[path]).all()), path
        assert_within(grads[path], g, floors[path], str(path))


def _grow(model, cache, side, extra=8):
    """``cache`` copied into a fresh one ``extra`` positions longer (the
    Mamba states, zero after prefill, as they are)."""
    t = cache["k"].shape[2]
    b = cache["len"].shape[0]
    if side == "jax":
        big = model.init_cache(b, t + extra)
        for k in ("k", "v"):
            big[k] = big[k].at[:, :, :t].set(cache[k])
        return {**big, "ssm": cache["ssm"], "conv": cache["conv"],
                "len": cache["len"]}
    big = model.init_cache(b, t + extra)
    for k in ("k", "v"):
        big[k][:, :, :t] = cache[k]
    return {**big, "ssm": cache["ssm"].clone(),
            "conv": cache["conv"].clone(), "len": cache["len"].clone()}


def test_prefill_matches_reference(pair):
    """``prefill``: the last position's logits; the attention layers' K/V
    of the prompt; zero Mamba states (the prompt's are not kept, ROADMAP
    C.7(d)); ``len`` the prompt length."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 4)
    jlog, jcache = jmodel.prefill(jparams, to_jax(batch))
    want = {"logits": jlog, **cache_to_numpy(jcache)}
    floors = spread(lambda p: {"logits": jmodel.prefill(p, to_jax(batch))[0],
                               **cache_to_numpy(jmodel.prefill(
                                   p, to_jax(batch))[1])}, jparams, want)
    tlog, tcache = tmodel.prefill(tparams, to_torch(batch))
    got = {"logits": tlog, **tcache}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert_within(got[k].numpy(), v, floors[k], k)
    for k in ("ssm", "conv"):
        assert not bool(tcache[k].any()), k
    np.testing.assert_array_equal(tcache["len"].numpy(), [24, 24])


def test_decode_steps_match_reference(pair):
    """Four ``decode_step``s into a fresh cache 8 positions longer than
    the prompt, each side carrying its own: logits, K/V, the Mamba
    ``ssm``/``conv`` states and ``len``; then one step at ``pos`` past
    the cache, which writes its last entry on both sides (the reference's
    ``dynamic_update_slice`` clamps)."""
    jmodel, jparams, tmodel, tparams = pair
    batch = make_batch(tmodel.cfg, 5)
    toks = np.random.default_rng(6).integers(0, 512, (5, 2, 1)).astype(
        np.int32)
    poss = [24, 25, 26, 27, 40]
    steps = [{"token": toks[t], "pos": np.full((2,), p, np.int32)}
             for t, p in enumerate(poss)]

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
    np.testing.assert_array_equal(tcache["len"].numpy(), [29, 29])


def test_greedy_decode_matches_reference(pair):
    """Eight greedy tokens after ``prefill`` into a grown cache: the
    streams agree wherever the reference's top-2 margin exceeds twice the
    logits' difference."""
    jmodel, jparams, tmodel, tparams = pair
    steps = greedy_streams(jmodel, jparams, tmodel, tparams,
                           make_batch(tmodel.cfg, 7), 8, _grow)
    assert_streams_equal_where_clear(steps)


def test_axes_and_config_are_the_references(pair):
    jmodel, _, tmodel, _ = pair
    assert tmodel.logical_axes() == jmodel.logical_axes()
    assert HybridLM(get_smoke(ARCH)).logical_axes() == jmodel.logical_axes()
    assert tmodel.cache_axes() == jmodel.cache_axes()
    for ours, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke(ARCH), jget_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_init_draws_the_references_leaves(pair):
    """``init`` on a seeded generator: the reference's leaf paths, shapes
    and dtypes, and its constant leaves (the norms, Mamba's conv, A_log,
    D, dt_bias and norm) bitwise."""
    jmodel, jparams, _, _ = pair
    got = HybridLM(get_smoke(ARCH)).init(torch.Generator().manual_seed(1))
    want = flat_grads(jparams)
    leaves = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            leaves[path] = t
    walk(got)
    assert set(leaves) == set(want)
    for path, w in want.items():
        assert tuple(leaves[path].shape) == w.shape, path
        assert str(leaves[path].dtype) == f"torch.{w.dtype}", path
    for path in [("blocks", "mamba", n) for n in
                 ("conv_x", "A_log", "D", "dt_bias", "norm")] + \
            [("blocks", "ln_mix"), ("blocks", "ln_ffn"),
             ("final_norm", "scale")]:
        np.testing.assert_array_equal(leaves[path].numpy(), want[path],
                                      err_msg=str(path))


@pytest.mark.parametrize("tc", [{}, dict(qat_bits=8,
                                         grad_compression="int8_ef")])
def test_trainer_steps_match_reference(tc):
    """``Trainer`` drives ``HybridLM.loss``: three steps, each taken by
    both trainers from one state (``_torch_recurrent
    .trainer_step_histories``), log the reference's loss and learning
    rate at rtol 1e-4 and its gradient norm at 5e-4 (the gradients, held
    leaf by leaf above at the reference's own float32 spread, move their
    norm by 3e-4 relative at step 2, measured)."""
    for step, (h, jh) in enumerate(trainer_step_histories(ARCH, tc), 1):
        assert h["step"] == jh["step"] == step
        for key, rtol in (("loss", 1e-4), ("grad_norm", 5e-4),
                          ("lr", 1e-4)):
            np.testing.assert_allclose(h[key], jh[key], rtol=rtol,
                                       err_msg=f"step {step} {key}")


def test_moe_hook_replays_expert_choices(pair):
    """:meth:`HybridLM.moe` is the one place the MoE layers run, so a
    subclass can log and replay the router's choices (the card's
    kernel-vs-plain check does): a replayed forward is bitwise the
    logged one."""
    from repro_torch.models import moe as M
    _, _, tmodel, tparams = pair

    class Routed(HybridLM):
        def __init__(self, cfg, replay=None):
            super().__init__(cfg)
            self.log, self.replay = [], replay

        def moe(self, p, h):
            n = len(self.log)

            def topk(probs, k):
                v, i = M.top_k(probs, k)
                if self.replay is not None:
                    i = self.replay[n]
                    v = torch.gather(probs, -1, i)
                self.log.append(i)
                return v, i
            return M.apply_moe(self.cfg, p, h, router_topk=topk)

    batch = to_torch(make_batch(tmodel.cfg, 8))
    rec = Routed(tmodel.cfg)
    a, aux_a = rec.forward(tparams, batch)
    rep = Routed(tmodel.cfg, replay=rec.log)
    b, aux_b = rep.forward(tparams, batch)
    want, _ = tmodel.forward(tparams, batch)
    assert len(rec.log) == len(tmodel.moe_slots) * tmodel.n_blocks
    assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(aux_a, aux_b)
