"""MoE training over data-parallel ranks (and experts over ``model``) on
gloo ranks, against the JAX reference's one-device fit on the global
batch, on the CPU.

The reference's MoE layers see every token of the batch its loss sees:
the load-balancing loss is E x sum_e f_e p_e over the batch's means, and
the dispatch path counts each expert's capacity queue over groups of
``min(1024, tokens)`` tokens of the flattened batch.  Over data-parallel
ranks the port sums the per-expert statistics over the ranks and counts
each queue across them; each rank backpropagates its share of the loss
tokens times its CE plus the global aux term.

The ranks (``tests/_torch_ranks.py``) start once for the module, a world
of two and one of four, from the reference's initial states (qwen3-moe
smoke, the linear schedule, a global batch of 8 x 32, three steps):

* the smoke config (8 experts, top 2: the dense path) at (data 2,
  model 1) and (data 2, model 2), the second with the experts, heads and
  vocabulary split over ``model``;
* a 16-expert variant (the dispatch path) at the same two meshes: its
  256 tokens are one capacity group spanning both data-parallel ranks,
  and the group drops assignments (counted here);
* the 16-expert variant at (data 2, model 1) with a ``loss_mask`` (about
  70 % ones, one row empty): the aux term is not a mean over the masked
  tokens, so it cannot be weighted as the CE is;
* the 16-expert variant in the pod-wise step (int8 error feedback) at
  (pod 2, data 2, model 1), two steps: the loader slices the batch over
  pod x data, each pod's loss and capacity groups span its two data
  ranks (the pod's 128 tokens one group, which drops assignments), and
  the pods exchange int8 codes; against the reference's per-pod body on
  the pods' halves at the training tolerance (an int8 code that rounds
  the other way moves an element), as ``tests/test_torch_parallel.py``'s
  dense pod-wise fit.

Each within 1e-4 of the reference (loss, grad norm, lr, final
parameters); replicas bitwise equal.  The masked run's loss, grad norm
and lr too; but a token seen only at masked positions gets its only
gradient from the aux term, about 3e-7, mostly rounding, so Adam's
update of its row follows the rounding (the port's own one-device fit
comes within 0.99 of 1e-4 of the reference there): its parameters are
held at the training tolerance (``_torch_fits.within_training``), and
every element within 2e-4 of the reference's (one element passes 1e-4,
at 1.04e-4).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from _torch_fits import (LR, ref_fit, ref_podwise_fit, replicas_equal,
                         within_1e4, within_training)
from _torch_ranks import join_world, markov, put_inputs, start_world
from repro.configs import get_smoke as jget_smoke
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import moe as M
from repro_torch.models.lm import DecoderLM

ARCH = "qwen3-moe-235b-a22b"
B, S = 8, 32
WIDE = {"n_experts": 16}
EF = {"grad_compression": "int8_ef"}
POD_AXES = ("pod", "data", "model")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe"))
    dense = jget_smoke(ARCH)
    wide = dataclasses.replace(dense, **WIDE)
    states = {}
    for tag, cfg in (("dense", dense), ("wide", wide)):
        states[tag], _, _ = ref_fit(cfg, ARCH, B, S, steps=0)
        put_inputs(tmp, tag, {"state": states[tag], "tc": {}, "lr": LR})
    pod_state, *pod_ref = ref_podwise_fit(wide, ARCH, B, S, pods=2)
    put_inputs(tmp, "pod", {"state": pod_state, "tc": EF, "lr": LR})
    fit = dict(axes=("data", "model"), steps=3, batch=B, seq=S, arch=ARCH)
    w2 = start_world(2, [
        ("fit_mesh", dict(shape=(2, 1), inputs="dense", **fit)),
        ("fit_mesh", dict(shape=(2, 1), inputs="wide", variant=WIDE, **fit)),
        ("fit_mesh", dict(shape=(2, 1), inputs="wide", variant=WIDE,
                          masked=True, **fit))], tmp, "moe2")
    w4 = start_world(4, [
        ("fit_mesh", dict(shape=(2, 2), inputs="dense", record=True,
                          **fit)),
        ("fit_mesh", dict(shape=(2, 2), inputs="wide", variant=WIDE,
                          record=True, **fit)),
        ("fit_mesh", dict(fit, shape=(2, 2, 1), axes=POD_AXES, steps=2,
                          inputs="pod", variant=WIDE))], tmp, "moe4")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fits = {(tag, masked): pool.submit(ref_fit, cfg, ARCH, B, S,
                                           masked=masked)
                for tag, cfg, masked in (("dense", dense, False),
                                         ("wide", wide, False),
                                         ("wide", wide, True))}
        ranks = {"w2": join_world(w2, timeout=600),
                 "w4": join_world(w4, timeout=600)}
        ref = {k: f.result()[1:] for k, f in fits.items()}
    ref["pod"] = pod_ref
    return ref, ranks, states


@pytest.mark.parametrize("world,index,tag,masked", [
    ("w2", 0, "dense", False), ("w2", 1, "wide", False),
    ("w2", 2, "wide", True), ("w4", 0, "dense", False),
    ("w4", 1, "wide", False)])
def test_moe_fit_within_1e4_of_the_global_batch(run, world, index, tag,
                                                masked):
    """Every rank within 1e-4 of the reference's one-device fit on the
    global batch (masked: its parameters at the training tolerance, each
    within 2e-4); replicas bitwise equal."""
    ref, ranks, _ = run
    for r in ranks[world]:
        if masked:
            within_training(r[index], *ref[(tag, masked)], max_diff=2e-4)
        else:
            within_1e4(r[index], *ref[(tag, masked)])
    replicas_equal(ranks[world], index)


@pytest.mark.parametrize("index,experts,router_x", [
    (0, 8, (B // 2, S, 64)), (1, 16, (1, B * S, 64))])
def test_experts_split_over_model(run, index, experts, router_x):
    """(data 2, model 2): each rank runs its half of the experts, and
    attention and the vocabulary split too; the router stays whole: a
    forward's router products take the whole [64, E] router, on this
    rank's 4 x 32 rows (dense) or on the one 256-token capacity group its
    128 tokens lie in (dispatch: the other rank's half zero rows), and the
    dispatch's expert products take E / 2 experts' stacks."""
    _, ranks, _ = run
    for r in ranks["w4"]:
        plan = r[index]["plan"]
        assert plan["size"] == 2 and plan["rank"] == r[index]["coord"][1]
        assert plan["experts"] and plan["attn"] and plan["vocab"]
        assert not plan["mlp"]
        seen = r[index]["products"]
        assert seen.count((router_x, (64, experts))) == 4
        assert (64, experts // 2) not in [w for _, w in seen]
        stacks = [w for _, w in seen if len(w) == 3]
        assert len(stacks) == (12 if experts > 8 else 0)
        assert all(w[0] == experts // 2 for w in stacks)


def test_capacity_group_spans_the_ranks_and_drops(run, monkeypatch):
    """The 16-expert variant's first step: 8 x 32 = 256 tokens <= 1024
    make one group, half of it on each data-parallel rank, and its first
    layer's routing (the port's one-device forward on the global batch,
    from the reference's state) sends more (token, slot) assignments to
    some expert than its capacity ceil(2 x 256 x 1.25 / 16) = 40: the
    ranks had to count the queues across each other and drop the same
    assignments as the reference."""
    _, _, states = run
    tokens = B * S
    assert tokens <= 1024               # one group, half on each rank
    cap, load = _first_layer_load(states, slice(None), monkeypatch)
    assert cap == 40
    assert load.sum() == 2 * tokens
    assert np.maximum(load - cap, 0).sum() >= 1, load


def _first_layer_load(states, rows, monkeypatch):
    """(capacity, assignments per expert) of the 16-expert variant's first
    layer on ``rows`` of the first global batch: the port's one-device
    forward from the reference's state, its group those rows' tokens."""
    cfg = dataclasses.replace(get_smoke(ARCH), **WIDE)
    params = params_from_jax(states["wide"][0], device="cpu")
    seen = []
    one = M._dispatch_one

    def record(cfg_, p, x, *args, **kwargs):
        seen.append((p["router"], x.detach()))
        return one(cfg_, p, x, *args, **kwargs)
    monkeypatch.setattr(M, "_dispatch_one", record)
    batch = {k: torch.from_numpy(v[rows])
             for k, v in markov(B, S, arch=ARCH).batch_at(0).items()}
    with torch.no_grad():
        DecoderLM(cfg).loss(params, batch)
    router, x = seen[0]
    tokens = x.shape[0] * x.shape[1]
    probs, _ = M._router_probs(cfg, {"router": router}, x.reshape(-1, 64))
    _, topi = M.top_k(probs, cfg.experts_per_token)
    cap = max(int(-(-cfg.experts_per_token * tokens * cfg.capacity_factor
                     // cfg.n_experts)), 1)
    return cap, np.bincount(topi.numpy().reshape(-1),
                            minlength=cfg.n_experts)


def test_podwise_moe_within_training_of_the_pods_batches(run, monkeypatch):
    """(pod 2, data 2, model 1), int8 error feedback: every rank within
    the training tolerance of the reference's per-pod body on the pods'
    halves of the global batch; replicas bitwise equal.  Each pod's 4 x
    32 = 128 tokens are one capacity group over its two data ranks, and
    the first pod's drops assignments (capacity ceil(2 x 128 x 1.25 /
    16) = 20)."""
    ref, ranks, _ = run
    for r in ranks["w4"]:
        assert r[2]["batch"]["labels"].shape == (B // 4, S)
        within_training(r[2], *ref["pod"])
    replicas_equal(ranks["w4"], 2)
    cap, load = _first_layer_load(run[2], slice(0, B // 2), monkeypatch)
    assert cap == 20
    assert np.maximum(load - cap, 0).sum() >= 1, load
