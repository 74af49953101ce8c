"""The test process's side of the port's multi-rank fits: the reference's
one-device ``Trainer.fit`` on the global batch, and the comparisons of a
rank's fit with it (``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_moe_parallel.py``).  The ranks themselves run
``tests/_torch_ranks.py`` and never import JAX."""

import jax
import numpy as np

from _torch_ranks import markov
from repro.data.loader import ShardedLoader as JLoader
from repro.launch.mesh import make_host_mesh
from repro.models.registry import build_model
from repro.optim import adamw as jadamw
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro_torch.models.lm import tree_leaves

LR = (3e-3, 2, 20)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    """numpy leaves of nested dicts in sorted-key order."""
    return [np.asarray(x) for x in tree_leaves(tree)]


def ref_fit(cfg, arch, batch, seq, steps=3, masked=False):
    """The reference's one-device ``Trainer.fit`` of ``cfg`` on the
    global batch (``arch``'s Markov data, the linear schedule ``LR``,
    clipping at 1): (its initial state as numpy, the history, the final
    parameters)."""
    opt = jadamw.AdamW(learning_rate=jadamw.linear_schedule(*LR),
                       clip_norm=1.0)
    jtr = JTrainer(build_model(cfg), opt, make_host_mesh(),
                   JTrainConfig(log_every=1))
    state = jtr.init_state(jax.random.PRNGKey(0))
    state0 = np_tree(state)          # the fit donates the state
    (params, _, _), hist = jtr.fit(
        JLoader(markov(batch, seq, masked, arch=arch)), steps, state=state)
    return state0, hist, np_tree(params)


def ref_step_states(cfg, arch, batch, seq, steps=3):
    """The reference's one-device ``Trainer.fit`` of ``cfg`` on the global
    batch as :func:`ref_fit`, a step at a time: (its state before each
    step and after the last, as numpy, the history).  The hybrid's and
    the xLSTM's smoke fits part from any other float32 run after a step
    (clipped Adam at lr 3e-3 follows the gradients' rounding, the port's
    own one-device fit too), so their mesh fits are held a step at a
    time from these states."""
    opt = jadamw.AdamW(learning_rate=jadamw.linear_schedule(*LR),
                       clip_norm=1.0)
    jtr = JTrainer(build_model(cfg), opt, make_host_mesh(),
                   JTrainConfig(log_every=1))
    state = jtr.init_state(jax.random.PRNGKey(0))
    loader = JLoader(markov(batch, seq, arch=arch))
    states, hist = [np_tree(state)], []
    for _ in range(steps):
        state, h = jtr.fit(loader, 1, state=state)
        states.append(np_tree(state))   # the next fit donates the state
        hist += h
    return states, hist


def ref_podwise_fit(cfg, arch, batch, seq, pods, steps=2):
    """The reference's pod-wise step with int8 error feedback
    (``_podwise_step``: each pod's loss and gradients on its slice of the
    global batch, codes exchanged over ``pod``), its per-pod body under
    ``jax.vmap(axis_name="pod")`` and jitted: the reference's ``Trainer``
    over a pod mesh does not run on the installed JAX (ROADMAP C.7(f)).
    Returns (its initial state as numpy, the history, the final
    parameters), as :func:`ref_fit`."""
    import jax.numpy as jnp
    from repro.optim import grad_compress as jgc
    opt = jadamw.AdamW(learning_rate=jadamw.linear_schedule(*LR),
                       clip_norm=1.0)
    jtr = JTrainer(build_model(cfg), opt, make_host_mesh(),
                   JTrainConfig(log_every=1, grad_compression="int8_ef"))

    def per_pod(params, opt_state, err, b):
        loss, grads = jax.value_and_grad(jtr._loss_fn)(params, b)
        grads, err = jgc.compress_tree(grads, err, axis_name="pod")
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = jax.lax.pmean(loss, "pod")
        return params, opt_state, err, metrics

    body = jax.jit(jax.vmap(per_pod, in_axes=(None, None, 0, 0),
                            axis_name="pod"))
    first = lambda tree: jax.tree_util.tree_map(lambda a: a[0], tree)
    state0 = np_tree(jtr.init_state(jax.random.PRNGKey(0)))
    params, ostate, err = state0
    err = jax.tree_util.tree_map(
        lambda a: np.zeros((pods,) + a.shape, np.float32), err)
    data, hist = markov(batch, seq, arch=arch), []
    for step in range(steps):
        split = {k: jnp.asarray(v).reshape((pods, -1) + v.shape[1:])
                 for k, v in data.batch_at(step).items()}
        params, ostate, err, metrics = body(params, ostate, err, split)
        params, ostate = first(params), first(ostate)
        hist.append({"step": step + 1,
                     **{k: float(v[0]) for k, v in metrics.items()}})
    return state0, hist, np_tree(params)


def within_1e4(got, hist, params):
    """A rank's fit against the reference's history and final parameters:
    loss, grad norm and lr at 1e-4 relative, parameters at rtol = atol =
    1e-4."""
    assert [h["step"] for h in got["hist"]] == [h["step"] for h in hist]
    for h, w in zip(got["hist"], hist):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], w[key], rtol=1e-4)
    for g, w in zip(leaves(got["state"][0]), leaves(params)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def steps_within_training(got, states, hist):
    """A rank's stepwise fit (each step from the reference's state before
    it) against :func:`ref_step_states`: each step's loss, grad norm and
    lr at 1e-4 relative, and the parameters after it at rtol = atol =
    1e-4 of the reference's after the same step but for at most 0.1 % of
    them (the repo's training tolerance's share), each of those within
    twice that step's lr: an element whose gradient sits near Adam's eps
    takes an update that follows the rounding.  The port's own
    one-device step from the same state leaves 52 of jamba-smoke's
    764,180 elements and 470 of xlstm-smoke's 2,085,040 beyond 1e-4 at
    step 1, by up to 1.96 lr (measured)."""
    assert [h["step"] for h in got["hist"]] == [h["step"] for h in hist]
    for h, w in zip(got["hist"], hist):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], w[key], rtol=1e-4,
                                       err_msg=f"step {w['step']} {key}")
    for i, (params, want) in enumerate(zip(got["params"], states[1:])):
        bad = n = 0
        for g, w in zip(leaves(params), leaves(want[0])):
            bad += int((~np.isclose(g, w, rtol=1e-4, atol=1e-4)).sum())
            n += g.size
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2.0 * hist[i]["lr"])
        assert bad <= 1e-3 * n, (i, bad, n)


def within_training(got, hist, params, max_diff=None):
    """A rank's fit against the reference's where the global batch gives
    some parameter a gradient at Adam's eps (1e-8) at a step, pure
    rounding there, so that its update follows the rounding (the port's
    own one-device fit then comes within 0.4-1.0 of 1e-4 of the
    reference on such elements), or where int8 codes may round the other
    way: loss, grad norm and lr at 1e-4 relative every step, and the
    repo's training tolerance on the parameters (at most 0.1 % of them
    beyond 1e-3 x the last step's lr, as the card's phase 9 and
    ``tests/test_torch_parallel.py``'s pod-wise fit hold a step).
    ``max_diff`` also bounds every element's distance from the
    reference, so that a fault confined to a few elements (a small leaf,
    a shard's edge) cannot pass."""
    assert [h["step"] for h in got["hist"]] == [h["step"] for h in hist]
    for h, w in zip(got["hist"], hist):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], w[key], rtol=1e-4)
    lr = hist[-1]["lr"]
    moved = n = 0
    for g, w in zip(leaves(got["state"][0]), leaves(params)):
        moved += int((np.abs(g - w) > 1e-3 * lr).sum())
        n += g.size
        if max_diff is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=max_diff)
    assert moved <= 1e-3 * n, (moved, n)


def replicas_equal(ranks, index):
    """Every rank ended scenario ``index`` with the same parameters."""
    first = leaves(ranks[0][index]["state"][0])
    for r in ranks[1:]:
        for a, b in zip(first, leaves(r[index]["state"][0])):
            np.testing.assert_array_equal(a, b)
