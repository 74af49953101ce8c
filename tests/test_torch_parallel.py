"""Training over a mesh of gloo ranks against the JAX reference, on the CPU.

The ranks (``tests/_torch_ranks.py``, torch only) start once for the
module, a world of four and one of two side by side (meshes over fewer
ranks inside them leave the others out), from the reference's initial state
(qwen2-0.5b smoke, QAT 8, int8 error feedback, the linear schedule, a
global batch of 12 x 32):

* the pod-wise step at P = 2, 3 and 4 given the reference's per-pod
  gradients: codes, scales, ``g_hat``, residuals and the AdamW state
  bitwise the reference's per-pod body under ``jax.vmap(axis_name="pod")``
  (jitted, as the reference's step is; clipping off there, so that the
  global norm, an f32 sum in another order, does not enter: the norm
  itself at 1e-6).  The reference's ``Trainer`` over a pod mesh does not
  run on the installed JAX (ROADMAP C.7(f)), so its body is run so;
* ``Trainer.fit`` at (pod 2, data 2) against that body over two steps,
  within the training tolerances of ``chip_smoke.py`` phase 9 (loss
  1e-4, grad norm 1e-3, at most 0.1 % of the parameters beyond 1e-3 lr:
  an int8 gradient code that rounds the other way moves an element and
  the norm differently);
* one rank (pod 1): bitwise the one-device trainer over three steps;
* data 2 without a pod axis, plain and masked: within 1e-4 of the
  reference's one-device step on the global batch (its ``Trainer.fit``
  from the same state), and of the port's; model 2: tensor-parallel
  compute (each rank's products on its shards, the collectives inside
  the forward and backward), within 1e-4 of the reference;
* every rank ends with the same parameters, bitwise; each rank's batch is
  its (pod, data) slice of the global batch.

Then the CLI under ``torchrun`` on two CPU ranks.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import concurrent.futures
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import (join_world, markov, put_inputs, start_world)
from repro.configs import get_smoke as jget_smoke
from repro.data.loader import ShardedLoader as JLoader
from repro.launch.mesh import make_host_mesh
from repro.models.registry import build_model
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models.lm import DecoderLM, tree_leaves
from repro_torch.optim import AdamW, linear_schedule
from repro_torch.runtime import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen2-0.5b"
B, S = 12, 32
LR = (3e-3, 2, 20)
QAT = dict(qat_bits=8, grad_compression="int8_ef")
PODS = (2, 3, 4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """numpy leaves of nested dicts in sorted-key order."""
    return [np.asarray(x) for x in tree_leaves(tree)]


def _split(batch, p):
    return {k: jnp.asarray(v).reshape((p, -1) + v.shape[1:])
            for k, v in batch.items()}


def _jtrainer(tc, clip_norm=1.0):
    opt = jadamw.AdamW(learning_rate=jadamw.linear_schedule(*LR),
                       clip_norm=clip_norm)
    return JTrainer(build_model(jget_smoke(ARCH)), opt, make_host_mesh(),
                    JTrainConfig(**tc)), opt


def _fed_body(opt):
    """The reference's per-pod body after ``value_and_grad``
    (``src/repro/runtime/train_loop.py:_podwise_step``), and each pod's
    codes and scales of its gradients plus residual."""
    def body(params, opt_state, err, grads):
        codes = jax.tree_util.tree_map(
            lambda g, e: jgc._quantize_leaf(g.astype(jnp.float32) + e),
            grads, err)
        g_hat, err = jgc.compress_tree(grads, err, axis_name="pod")
        params, opt_state, metrics = opt.update(g_hat, opt_state, params)
        return codes, g_hat, err, params, opt_state, metrics
    return jax.jit(jax.vmap(body, in_axes=(None, None, 0, 0),
                            axis_name="pod"))


def _pod_body(jtr, opt):
    """The reference's per-pod body, whole."""
    def per_pod(params, opt_state, err, batch):
        loss, grads = jax.value_and_grad(jtr._loss_fn)(params, batch)
        grads, err = jgc.compress_tree(grads, err, axis_name="pod")
        loss = jax.lax.pmean(loss, "pod")
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, err, metrics
    return jax.jit(jax.vmap(per_pod, in_axes=(None, None, 0, 0),
                            axis_name="pod"))


def _first(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _ref_fit(steps, masked):
    """The reference's one-device ``Trainer.fit`` (its plain GSPMD step)
    on the global batch, from the state the ranks start from."""
    jtr, _ = _jtrainer(dict(log_every=1))
    state = jtr.init_state(jax.random.PRNGKey(0))
    (params, _, _), hist = jtr.fit(JLoader(markov(B, S, masked)), steps,
                                   state=state)
    return hist, _np(params)


def _port_fit(tc, steps, masked=False, model=1):
    """The one-device trainer from the same state on the global batch."""
    from repro_torch.data import ShardedLoader
    jtr, _ = _jtrainer(tc)
    state = train_state_from_jax(*_np(jtr.init_state(jax.random.PRNGKey(0))),
                                 device="cpu")
    tr = Trainer(DecoderLM(get_smoke(ARCH)),
                 AdamW(learning_rate=linear_schedule(*LR)), "cpu",
                 TrainConfig(log_every=1, **tc))
    loader = ShardedLoader(markov(B, S, masked), device="cpu")
    (p, o, e), hist = tr.fit(loader, steps, state=state)
    return hist, (p, o, e)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("ranks"))
    ref = {}
    data = markov(B, S)
    batches = [data.batch_at(s) for s in range(2)]

    # the inputs: the reference's initial states and per-pod gradients
    jtr, opt = _jtrainer(QAT, clip_norm=0.0)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    vg = jax.jit(jax.value_and_grad(jtr._loss_fn))
    fed = {"state": _np(jstate), "tc": QAT, "lr": LR}
    per_pod = [[_np(vg(jstate[0], {k: v[4 * p:4 * p + 4]
                                   for k, v in markov(16, S).batch_at(
                                       s).items()}))
                for p in range(max(PODS))] for s in range(2)]
    for p in PODS:       # pod q's gradients: rows 4q..4q+3 of a step
        fed[f"grads{p}"] = [(jax.tree_util.tree_map(
            lambda *g: np.stack(g), *[g for _, g in step[:p]]),
            np.array([loss for loss, _ in step[:p]])) for step in per_pod]
    put_inputs(tmp, "fed", fed)
    put_inputs(tmp, "whole", {"state": _np(jstate), "tc": QAT, "lr": LR})
    jplain, _ = _jtrainer({})
    put_inputs(tmp, "plain", {"state": _np(jplain.init_state(
        jax.random.PRNGKey(0))), "tc": {}, "lr": LR})

    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--steps", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    mesh3 = ("pod", "data", "model")
    plain2 = dict(axes=("data", "model"), steps=3, inputs="plain")
    worlds = [
        start_world(4, [("fed_podwise", dict(pod=4, model=1)),
                        ("fed_podwise", dict(pod=2, model=2)),
                        ("fed_podwise", dict(pod=3, model=1,
                                             ranks=[0, 1, 2])),
                        ("fit_mesh", dict(shape=(2, 2, 1), axes=mesh3,
                                          steps=2))], tmp, "w4"),
        start_world(2, [("fit_mesh", dict(shape=(2, 1), **plain2)),
                        ("fit_mesh", dict(shape=(2, 1), masked=True,
                                          **plain2)),
                        ("fit_mesh", dict(shape=(1, 2), record=True,
                                          **plain2)),
                        ("fit_mesh", dict(shape=(1, 1, 1), axes=mesh3,
                                          steps=3, ranks=[0]))], tmp, "w2")]

    # the ranks first: beside them the reference's compiles run slower
    # than after them, on a machine of a few cores; but for the one-device
    # fits, which would otherwise leave the machine half idle
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jfits = {tag: pool.submit(_ref_fit, 3, masked)
                 for tag, masked in (("plain", False), ("masked", True))}
        results = {h[0]: join_world(h) for h in worlds}
        ref["jax"] = {tag: f.result() for tag, f in jfits.items()}
    try:
        results["cli"] = (*cli.communicate(timeout=300), cli.returncode)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()

    torch.set_num_threads(n)

    # the reference
    fed_body, update = _fed_body(opt), jax.jit(opt.update)
    for p in PODS:      # numpy in and out: one compile per P
        params, ostate = _np(jstate[0]), _np(jstate[1])
        err = jax.tree_util.tree_map(
            lambda a: np.zeros((p,) + a.shape, np.float32), params)
        steps = []
        for grads, _ in fed[f"grads{p}"]:
            out = _np(fed_body(params, ostate, err, grads))
            qs, g_hat, err, fused_p, fused_o, metrics = out
            params, ostate, _ = _np(update(_first(g_hat), ostate, params))
            steps.append({"codes": qs, "g_hat": g_hat, "err": err,
                          "params": params, "opt": ostate,
                          "fused": (_first(fused_p), _first(fused_o)),
                          "metrics": metrics})
        ref[f"fed{p}"] = steps
    jtr2, opt2 = _jtrainer(QAT)
    body = _pod_body(jtr2, opt2)
    params, ostate = _np(jstate[0]), _np(jstate[1])
    err = jax.tree_util.tree_map(
        lambda a: np.zeros((2,) + a.shape, np.float32), params)
    hist, after = [], []
    for b in batches:
        params, ostate, err, metrics = _np(body(params, ostate, err,
                                                _split(b, 2)))
        params, ostate = _first(params), _first(ostate)
        hist.append({k: float(v[0]) for k, v in metrics.items()})
        after.append(_np(params))
    ref["whole"] = (hist, after)
    # one thread, as the ranks: a CPU reduction's order follows the
    # thread count, and these are held bitwise
    torch.set_num_threads(1)
    ref["one"] = {tag: _port_fit(tc, 3, masked=masked)
                  for tag, tc, masked in (("qat", QAT, False),
                                          ("plain", {}, False),
                                          ("masked", {}, True))}
    torch.set_num_threads(n)

    return ref, results


@pytest.mark.parametrize("pods,index", [(2, 1), (3, 2), (4, 0)])
def test_podwise_fed_bitwise_the_reference_body(run, pods, index):
    """Two steps given the reference's per-pod gradients; at P = 2 the
    state is also sharded over model = 2.  The AdamW state is bitwise the
    reference's jitted ``AdamW.update`` of the body's ``g_hat``, and
    within 1e-6 of the body's own: jitted as one function, XLA recomputes
    the new moment inside the parameter update's fusion with the other
    multiply-add contracted, and at P = 3 folds fl(1/3) into (1 - b1)
    (ROADMAP C.7(f))."""
    ref, results = run
    ranks = [r for r in results["w4"] if r[index] is not None]
    per_pod = len(ranks) // pods
    for rank, res in enumerate(ranks):
        p = rank // per_pod
        for got, want in zip(res[index], ref[f"fed{pods}"]):
            wl = _leaves(want["codes"])           # (codes, scales) a leaf
            for q, s, wq, ws in zip(_leaves(got["codes"]),
                                    _leaves(got["scales"]), wl[0::2],
                                    wl[1::2]):
                np.testing.assert_array_equal(q, wq[p])
                assert s == float(ws[p])
            for key in ("g_hat", "err"):
                for g, w in zip(_leaves(got[key]), _leaves(want[key])):
                    np.testing.assert_array_equal(g, w[p])
            params, (step, m, v), err = got["state"]
            assert int(step) == int(want["opt"][0])
            fp, fo = want["fused"]
            for g, w, f in zip(
                    _leaves(params) + _leaves(m) + _leaves(v),
                    _leaves(want["params"]) + _leaves(want["opt"][1])
                    + _leaves(want["opt"][2]),
                    _leaves(fp) + _leaves(fo[1]) + _leaves(fo[2])):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_allclose(g, f, rtol=1e-6,
                                           atol=1e-6 * np.abs(f).max())
            for g, w in zip(_leaves(err), _leaves(want["err"])):
                np.testing.assert_array_equal(g, w[p])
            np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                       want["metrics"]["grad_norm"][p],
                                       rtol=1e-6)
            assert got["metrics"]["lr"] == float(want["metrics"]["lr"][p])
    # the residual is each pod's own
    errs = [_leaves(r[index][-1]["err"])[0] for r in ranks]
    assert not np.array_equal(errs[0], errs[-1])


def _moved(got, want, lr):
    """(elements beyond 1e-3 lr, elements) between two parameter trees."""
    moved = n = 0
    for g, w in zip(_leaves(got), _leaves(want)):
        moved += int((np.abs(g - w) > 1e-3 * lr).sum())
        n += g.size
    return moved, n


def test_podwise_fit_within_training_tolerances(run):
    """(pod 2, data 2): each pod's loss over its data ranks' slices, int8
    codes over pod, against the reference's body over the pods' halves of
    the batch."""
    ref, results = run
    hist, after = ref["whole"]
    for res in results["w4"]:
        got = res[3]
        assert [h["step"] for h in got["hist"]] == [1, 2]
        for h, w in zip(got["hist"], hist):
            np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-4)
            np.testing.assert_allclose(h["grad_norm"], w["grad_norm"],
                                       rtol=1e-3)
            assert h["lr"] == pytest.approx(w["lr"], rel=1e-6)
        moved, n = _moved(got["params"][0], after[0], LR[0] / 2)
        assert moved <= 1e-3 * n, (moved, n)


@pytest.mark.parametrize("world", ["w4", "w2"])
def test_params_bitwise_equal_across_ranks(run, world):
    """Every replica ends every scenario with the same parameters (each
    rank's gathered whole; over model its own part among them)."""
    _, results = run
    ranks = results[world]
    for i in range(len(ranks[0])):
        outs = [r[i][-1] if isinstance(r[i], list) else r[i] for r in ranks
                if r[i] is not None]
        first = _leaves(outs[0]["state"][0])
        for o in outs[1:]:
            for a, b in zip(first, _leaves(o["state"][0])):
                np.testing.assert_array_equal(a, b)


def _state_equal(got, want):
    params, (step, m, v), err = got
    wp, wo, we = want
    assert int(step) == int(wo.step)
    for g, w in zip(_leaves(params) + _leaves(m) + _leaves(v)
                    + _leaves(err), _leaves(wp) + _leaves(wo.m)
                    + _leaves(wo.v) + _leaves(we)):
        np.testing.assert_array_equal(g, w)


def test_one_rank_podwise_bitwise_the_one_device_step(run):
    """(pod 1, data 1, model 1), QAT 8 + int8 EF: the pod-wise step with
    its all-gather over one rank (sum s q / 1 is q s exactly) equals the
    one-device trainer bit for bit over three steps."""
    ref, results = run
    got = results["w2"][0][3]
    assert results["w2"][1][3] is None          # rank 1: outside the mesh
    hist, state = ref["one"]["qat"]
    assert [h["loss"] for h in got["hist"]] == [h["loss"] for h in hist]
    _state_equal(got["state"], state)


def _within_1e4(got, hist, params):
    """A rank's three steps against a one-device run's history and final
    parameters, at 1e-4."""
    assert [h["step"] for h in got["hist"]] == \
        [h["step"] for h in hist] == [1, 2, 3]
    for h, w in zip(got["hist"], hist):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], w[key], rtol=1e-4)
    for g, w in zip(_leaves(got["state"][0]), _leaves(params)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("index,tag", [(0, "plain"), (1, "masked")])
def test_data_parallel_within_1e4_of_the_global_batch(run, index, tag):
    """(data 2, model 1), no pod axis: each rank's gradients weighted by
    its share of the loss tokens (loss_mask: ~70 % kept, one row empty)
    and summed give the reference's one-device step on the global batch,
    within 1e-4; the port's one-device step too."""
    ref, results = run
    jhist, jparams = ref["jax"][tag]
    hist, (params, _, _) = ref["one"][tag]
    for res in results["w2"]:
        _within_1e4(res[index], jhist, jparams)
        _within_1e4(res[index], hist, params)


def test_model_axis_shards_compute(run):
    """(data 1, model 2): each rank holds half of the sharded leaves and
    computes with them: qwen2's smoke heads (4 over 2 KV heads) split by
    whole KV groups, so every product of a forward takes this rank's
    column shard (``wq`` 64 -> 32, ``wk``/``wv`` 32 -> 16, gate/up 160 ->
    80, the tied head's 512 vocabulary columns -> 256) or row shard
    (``wo`` 32 -> 64, down 80 -> 64), the partial sums reduced over
    ``model``.  Within 1e-4 of the reference's one-device step; both
    ranks' parameters bitwise equal."""
    ref, results = run
    b, s = B, S
    layer = [((b, s, 64), (64, 32)), ((b, s, 64), (64, 16)),
             ((b, s, 64), (64, 16)), ((b, s, 32), (32, 64)),
             ((b, s, 64), (64, 80)), ((b, s, 64), (64, 80)),
             ((b, s, 80), (80, 64))]
    for rank, res in enumerate(results["w2"]):
        got = res[2]
        _within_1e4(got, *ref["jax"]["plain"])
        assert got["plan"] == dict(size=2, rank=rank, attn=True, mlp=True,
                                   vocab=True, experts=False)
        assert got["products"] == layer * 4 + [((b, s, 64), (64, 256))]
    a, c = (_leaves(r[2]["state"][0]) for r in results["w2"])
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x, y)


def test_loader_slices_by_pod_and_data(run):
    """Each rank's batch is its contiguous slice of the global batch,
    pod-major over (pod, data); without a pod axis, over data; over model
    alone, the whole batch."""
    _, results = run
    want = markov(B, S).batch_at(0)
    for world, index, count in (("w4", 3, 4), ("w2", 0, 2), ("w2", 2, 1)):
        for res in results[world]:
            got = res[index]
            coord = got["coord"]
            i = (coord[0] * 2 + coord[1]) if world == "w4" else \
                (coord[0] if count > 1 else 0)
            rows = slice(i * B // count, (i + 1) * B // count)
            for k, v in want.items():
                np.testing.assert_array_equal(got["batch"][k], v[rows])


def test_cli_under_torchrun_on_two_ranks(run):
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --smoke --device cpu --steps 20`` (started
    with the ranks): a (data 2, model 1) mesh over gloo, rank 0 prints
    the reference's lines, and the loss improves as on one rank."""
    stdout, stderr, rc = run[1]["cli"]
    assert rc == 0, stderr[-3000:]
    lines = stdout.strip().splitlines()
    assert lines[0].startswith("arch=qwen2-0.5b-smoke params=")
    assert "devices=2" in lines[0] and "mesh=(data 2, model 1)" in lines[0]
    assert sum(line.startswith("step    20 loss") for line in lines) == 1
    assert lines[-1].endswith("(improved)"), stdout
