"""Shared helpers of the port-vs-reference tests of the recurrent, hybrid
and encoder-decoder models (``tests/test_torch_xlstm.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py``): the model pair with
the reference's parameters carried across, seeded numpy batches, and the
comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models.registry import build_model as jbuild_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models.lm import tree_map
from repro_torch.models.registry import build_model


class Jitted:
    """The reference's model with ``forward``, ``loss``, ``prefill`` and
    ``decode_step`` each compiled once (``jax.jit``).  Called eagerly,
    the reference's ``lax.scan`` bodies are new closures at every call and
    compile anew each time: a test that calls them a few dozen times grew
    XLA's caches until the process aborted."""

    def __init__(self, model):
        self.model = model
        self.forward = jax.jit(model.forward)
        self.loss = jax.jit(model.loss)
        self.grad = jax.jit(jax.grad(model.loss))
        self.value_and_grad = jax.jit(jax.value_and_grad(model.loss))
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self.model, name)


def model_pair(arch):
    """(jmodel, jparams, tmodel, tparams): the reference's model
    (:class:`Jitted`) and parameters, and the port's model on the same
    parameters (CPU)."""
    jmodel = jbuild_model(jget_smoke(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return Jitted(jmodel), jparams, build_model(get_smoke(arch)), tparams


def make_batch(cfg, seed, b=2, s=24, s_enc=16, labels=False):
    """Tokens (labels), and for an encoder-decoder ``s_enc`` frames of
    stub embeddings, from a numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.n_enc_layers:
        out["embeds"] = rng.standard_normal((b, s_enc, cfg.d_model)).astype(
            np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def perturbed(jparams, seed=9):
    """The reference's parameters with each element moved by -1, 0 or +1
    units in the last place (seeded): a change no float32 computation can
    tell from rounding.  How far the reference's own outputs move under it
    measures how much float32 rounding a model amplifies."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        step = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), x.shape)
        return jnp.asarray(x * (1 + np.float32(2 ** -23) * step))
    return jax.tree_util.tree_map(one, jparams)


SPREAD_SEEDS = (9, 10, 11)


def spread(fn, jparams, want):
    """max over :data:`SPREAD_SEEDS` of max|fn(perturbed) - want|, per
    key when ``fn`` returns a dict of arrays (else one number): the
    reference's own float32 movement, the floor of :func:`assert_within`.
    One perturbation underestimates it (the four seeds 9-12 moved the
    xLSTM's gradients by up to 5x apart, measured)."""
    outs = [fn(perturbed(jparams, seed)) for seed in SPREAD_SEEDS]
    if isinstance(want, dict):
        return {k: max(float(np.abs(np.asarray(o[k]) - np.asarray(w)).max())
                       for o in outs) for k, w in want.items()}
    return max(float(np.abs(np.asarray(o) - np.asarray(want)).max())
               for o in outs)


def flat_grads(jgrads):
    return {tuple(k.key for k in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}


def port_loss_and_grads(tmodel, tparams, batch, remat=False):
    """(loss, {leaf path: gradient}) of the port's ``loss``."""
    leaves = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        leaf = t.clone().requires_grad_(True)
        leaves[path] = leaf
        return leaf
    params = walk(tparams)
    loss = tmodel.loss(params, to_torch(batch), remat=remat)
    loss.backward()
    return float(loss.detach()), {p: l.grad.numpy() for p, l in
                                  leaves.items()}


def assert_within(got, want, spread, what, rtol=1e-4):
    """``got`` within rtol x |want| + max(rtol x max|want|, 2 x spread)
    of ``want``: the usual relative tolerance, widened to twice the
    reference's own movement under :func:`perturbed` (:func:`spread`)
    where the model amplifies rounding more than that."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(rtol * scale, 2.0 * spread),
                               err_msg=what)


def cache_to_numpy(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def greedy_streams(jmodel, jparams, tmodel, tparams, batch, n, grow):
    """``n`` greedy tokens after ``prefill``, each side feeding back its
    own tokens, from caches grown by ``grow`` (a function of (model,
    cache, side) -> larger cache).  Returns [(port token [B], reference
    token [B], reference top-2 margin [B], max|logit diff|)] per step."""
    jlog, jcache = jmodel.prefill(jparams, to_jax(batch))
    tlog, tcache = tmodel.prefill(tparams, to_torch(batch))
    jcache, tcache = grow(jmodel, jcache, "jax"), grow(tmodel, tcache,
                                                       "torch")
    s = batch["tokens"].shape[1]
    out = []
    for t in range(n):
        jl, tl = np.asarray(jlog), tlog.numpy()
        top2 = np.sort(jl, axis=-1)[:, -2:]
        out.append((tl.argmax(-1), jl.argmax(-1), top2[:, 1] - top2[:, 0],
                    float(np.abs(tl - jl).max())))
        pos = np.full((jl.shape[0],), s + t, np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jcache, {
            "token": jnp.asarray(jl.argmax(-1)[:, None].astype(np.int32)),
            "pos": jnp.asarray(pos)})
        tlog, tcache = tmodel.decode_step(tparams, tcache, {
            "token": torch.from_numpy(tl.argmax(-1)[:, None]),
            "pos": torch.from_numpy(pos)})
    return out


def assert_streams_equal_where_clear(steps):
    """The two greedy streams agree at every step until the reference's
    top-2 margin of some row is within twice the logits' difference; past
    that a row may legitimately diverge, and the comparison stops.  At
    least the first step must be clear."""
    for i, (tok, jtok, margin, diff) in enumerate(steps):
        if not bool((margin > 2 * diff).all()):
            assert i > 0, "the first token's margin is not clear"
            return
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {i}")


def _state_to_jax(state):
    """The port's (params, AdamWState, err) as the reference's."""
    from repro.optim.adamw import AdamWState as JAdamWState

    def arr(t):
        return jnp.asarray(t.detach().numpy())
    params, opt, err = state
    return (tree_map(arr, params),
            JAdamWState(step=arr(opt.step), m=tree_map(arr, opt.m),
                        v=tree_map(arr, opt.v)),
            tree_map(arr, err))


class FramesDataset:
    """Seeded encoder-decoder batches (``embeds`` [B, S_enc, D] stub
    frames, ``tokens``, ``labels``) under the datasets' ``batch_at``
    protocol, for both packages' loaders."""

    def __init__(self, cfg, batch=4, s_enc=16, s=16):
        self.cfg, self.b, self.s_enc, self.s = cfg, batch, s_enc, s

    def batch_at(self, step):
        return make_batch(self.cfg, 100 + step, b=self.b, s=self.s,
                          s_enc=self.s_enc, labels=True)


def trainer_step_histories(arch, tc, steps=3, seq=32, batch=4,
                           dataset=None):
    """``steps`` training steps of ``Trainer`` on Markov data, each taken
    by both trainers (the port's and the reference's, ``tc`` their
    ``TrainConfig`` fields) from the port's state, on Markov data or
    ``dataset``'s batches; returns [(port
    metrics, reference metrics)] per step.  Starting every step from one
    state keeps the comparison to one step's function: at lr 3e-3 two
    float32 trajectories of these models part after a step, as Adam's
    sign-like updates follow the gradients' rounding."""
    from repro.data.loader import ShardedLoader as JLoader
    from repro.data.synthetic import MarkovLMConfig as JMarkovConfig
    from repro.data.synthetic import MarkovLMDataset as JMarkovDataset
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adamw as jadamw
    from repro.runtime import TrainConfig as JTrainConfig
    from repro.runtime import Trainer as JTrainer
    from repro_torch.bridge import train_state_from_jax
    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainConfig, Trainer

    jtr = JTrainer(jbuild_model(jget_smoke(arch)),
                   jadamw.AdamW(learning_rate=3e-3), make_host_mesh(),
                   JTrainConfig(log_every=1, **tc))
    state = train_state_from_jax(*jax.tree_util.tree_map(
        np.asarray, jtr.init_state(jax.random.PRNGKey(0))), device="cpu")
    if dataset is None:
        kw = dict(vocab_size=get_smoke(arch).vocab_size, seq_len=seq,
                  batch_size=batch)
        jl = JLoader(JMarkovDataset(JMarkovConfig(**kw)))
        tl = ShardedLoader(MarkovLMDataset(MarkovLMConfig(**kw)),
                           device="cpu")
    else:
        jl, tl = JLoader(dataset), ShardedLoader(dataset, device="cpu")
    tr = Trainer(build_model(get_smoke(arch)), AdamW(learning_rate=3e-3),
                 "cpu", TrainConfig(log_every=1, **tc))
    out = []
    for _ in range(steps):
        _, (jh,) = jtr.fit(jl, 1, state=_state_to_jax(state))
        state, (h,) = tr.fit(tl, 1, state=state)
        out.append((h, jh))
    return out
