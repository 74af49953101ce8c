"""Gloo ranks for the port's multi-rank tests.

``start_world(n, scenarios, tmp)`` starts ``n`` processes, one rank each,
joined through a ``FileStore`` in ``tmp`` (no TCP port, so test workers
running side by side cannot collide); each rank runs the named scenarios
of :data:`SCENARIOS` in order and pickles what they return to
``tmp/<world>_rank<r>.pkl``.  ``join_world`` waits for them and returns
the results per rank, or raises with a failed rank's traceback.  The ranks
import torch and ``repro_torch`` only (never JAX): the tests compute the
reference in their own process and hand inputs over as numpy arrays in a
pickle of their own making (``put_inputs``).
"""

from __future__ import annotations

import json
import os
import pathlib
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen2-0.5b"


# ---------------------------------------------------------------------------
# the harness (test process side)
# ---------------------------------------------------------------------------

def put_inputs(tmp, name: str, obj) -> None:
    """Pickle ``obj`` as the inputs ``name`` (whole or not at all: a rank
    may be waiting for them)."""
    path = os.path.join(tmp, f"{name}.inputs.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)


def start_world(n: int, scenarios, tmp, world: str):
    """Start ``n`` ranks running ``scenarios`` (a list of (name, kwargs));
    returns the handle for :func:`join_world`."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    store = os.path.join(tmp, f"{world}.store")
    code = ("import sys, _torch_ranks; "
            "_torch_ranks.rank_main(*sys.argv[1:])")
    spec = json.dumps(scenarios)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), store, str(tmp),
         world, spec], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return world, tmp, procs


def join_world(handle, timeout: float = 240.0):
    """Wait for every rank; returns [rank 0's results, rank 1's, ...],
    each a list with one entry per scenario."""
    world, tmp, procs = handle
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"world {world}: ranks failed: {bad}")
    results = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"{world}_rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def rank_main(rank, n, store, tmp, world, spec) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks

    torch.set_num_threads(1)
    rank, n = int(rank), int(n)
    try:
        init_ranks("cpu", store_file=store, rank=rank, world_size=n)
        out = [SCENARIOS[name](tmp, **kwargs)
               for name, kwargs in json.loads(spec)]
        with open(os.path.join(tmp, f"{world}_rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def _inputs(tmp, name, wait: float = 0.0):
    """The test's inputs ``name``; ``wait`` > 0: polls up to that many
    seconds for them (the test may write them while the ranks run)."""
    path = os.path.join(tmp, f"{name}.inputs.pkl")
    deadline = time.monotonic() + wait
    while wait and not os.path.exists(path) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _np_tree(tree):
    """Nested dicts (and AdamWState) of tensors, DTensors gathered whole,
    as numpy."""
    from repro_torch.parallel.sharding import gather
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np_tree(v) for v in tree)
    return gather(tree).detach().cpu().numpy().copy()


def _trainer(mesh, tc, lr, clip_norm=1.0, arch=ARCH, variant=None,
             notp=False):
    """A trainer over ``mesh``: AdamW with the linear schedule ``lr``
    (peak, warmup, total), or a constant 1e-3 where ``lr`` is None;
    ``variant`` replaces fields of the smoke config; ``notp``: the
    dry-run's ``notp`` rules (heads, KV, FFN and vocabulary replicated)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, linear_schedule
    from repro_torch.parallel.sharding import default_rules
    from repro_torch.runtime import TrainConfig, Trainer
    opt = AdamW(learning_rate=1e-3 if lr is None else linear_schedule(*lr),
                clip_norm=clip_norm)
    cfg = dataclasses.replace(get_smoke(arch), **(variant or {}))
    rules = None
    if notp:
        rules = default_rules(cfg)
        rules.update(heads=None, kv=None, kv_heads=None, ffn=None,
                     vocab=None)
    return Trainer(build_model(cfg), opt, "cpu",
                   TrainConfig(log_every=1, **tc), mesh=mesh, rules=rules)


def _start(tr, inp):
    """The trainer's state from the test's numpy state, placed."""
    from repro_torch.bridge import train_state_from_jax
    return tr.place_state(*train_state_from_jax(*inp["state"],
                                                device="cpu"))


class MaskedData:
    """A dataset's batches with a seeded ``loss_mask`` (about 70 % ones,
    one whole row masked out), the same per step on every rank."""

    def __init__(self, ds):
        self.ds = ds

    def batch_at(self, step):
        b = dict(self.ds.batch_at(step))
        rng = np.random.default_rng(1000 + step)
        mask = (rng.random(b["labels"].shape) < 0.7).astype(np.float32)
        mask[step % mask.shape[0]] = 0.0
        b["loss_mask"] = mask
        return b


class FramesData:
    """A dataset's batches with ``frames`` seeded stub frame embeddings a
    row (standard normals, ``embeds`` [B, frames, D]), for an
    encoder-decoder: the same per step on every rank and in the test
    process."""

    def __init__(self, ds, frames: int, d_model: int):
        self.ds, self.frames, self.d = ds, frames, d_model

    def batch_at(self, step):
        b = dict(self.ds.batch_at(step))
        rng = np.random.default_rng(2000 + step)
        b["embeds"] = rng.standard_normal(
            (b["labels"].shape[0], self.frames, self.d)).astype(np.float32)
        return b


def markov(batch: int, seq: int, masked: bool = False, arch=ARCH):
    """``arch``'s smoke vocabulary's Markov data (``masked``: with a
    :class:`MaskedData` mask); an encoder-decoder's batches also carry
    ``seq`` frames of stub embeddings (:class:`FramesData`)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    cfg = get_smoke(arch)
    ds = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch))
    if cfg.n_enc_layers:
        ds = FramesData(ds, seq, cfg.d_model)
    return MaskedData(ds) if masked else ds


def fed_podwise(tmp, pod, model, ranks=None):
    """The pod-wise step after the gradients: each pod's gradients (the
    reference's, two steps' worth) fed to ``Trainer._apply`` over a (pod,
    1, model) mesh; per step this rank's codes and scales, its ``g_hat``
    and new residual (``compress_tree`` over the pod group), then the
    state after ``_apply``."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import tree_map
    from repro_torch.optim import compress_tree
    from repro_torch.optim.grad_compress import _quantize_leaf
    from repro_torch.parallel.sharding import gather

    inp = _inputs(tmp, "fed")
    mesh = make_mesh((pod, 1, model), ("pod", "data", "model"), ranks,
                     device="cpu")
    if mesh.get_coordinate() is None:
        return None                     # a rank outside the mesh
    tr = _trainer(mesh, inp["tc"], inp["lr"], clip_norm=0.0)
    state = _start(tr, inp)
    p = mesh.get_coordinate()[0]
    out = []
    for grads, losses in inp[f"grads{pod}"]:
        g = tree_map(lambda a: torch.from_numpy(np.array(a[p])), grads)
        e0 = tree_map(gather, state[2])
        codes = tree_map(lambda t: _quantize_leaf(t)[0].numpy(),
                         _plus(g, e0))
        scales = tree_map(lambda t: float(_quantize_leaf(t)[1]),
                          _plus(g, e0))
        g_hat, e1 = compress_tree(g, e0, "pod", mesh)
        *state, metrics = tr._apply([_model_shards(tr, g)],
                                    torch.tensor(float(losses[p])),
                                    None, *state)
        out.append({"codes": codes, "scales": scales,
                    "g_hat": _np_tree(g_hat), "err": _np_tree(e1),
                    "state": _np_tree(tuple(state)),
                    "metrics": {k: float(v) for k, v in metrics.items()}})
    return out


def _model_shards(tr, grads):
    """Whole gradients as ``Trainer._apply`` takes them: this rank's
    ``model`` shard of the leaves that compute on their shards."""
    if tr.tp is None:
        return grads

    def one(g, d):
        if isinstance(g, dict):
            return {k: one(g[k], d[k]) for k in g}
        return g if d is None else g.chunk(tr.tp.size, d)[tr.tp.rank]
    return one(grads, tr._local)


def _plus(a, b):
    if isinstance(a, dict):
        return {k: _plus(a[k], b[k]) for k in a}
    return a.to(b.dtype) + b


def products(tr, state, batch):
    """[(x's shape, w's shape)] of every ``torch.matmul`` and ``@`` in one
    forward of the trainer's loss on ``batch``, from the leaves its step
    computes with (each gathered but for its ``model`` shard where it
    computes on it)."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.runtime.train_loop import _gather, _zip_map

    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                seen.append((tuple(args[0].shape), tuple(args[1].shape)))
            return func(*args, **(kwargs or {}))

    leaves = _zip_map(_gather, state[0], tr._dims(state[0]))
    with torch.no_grad(), Record():
        tr._loss_fn(leaves, batch)
    return seen


def fit_mesh(tmp, shape, axes, steps, masked=False, batch=12, seq=32,
             inputs="whole", ranks=None, arch=ARCH, variant=None,
             spec=None, record=False, notp=False):
    """``Trainer.fit`` over a mesh of ``shape``, from the test's state, on
    this rank's slice of the global batch, a step at a time; returns the
    history, the full state after it, the parameters after each step,
    this rank's first batch slice and its coordinate.  ``variant``
    replaces fields of the smoke config of ``arch``; ``spec`` runs the
    steps under ``activation_sharding(spec)``; ``record`` adds the
    products of one forward on the first batch (:func:`products`) and
    the trainer's tensor-parallel plan; ``notp`` takes the dry-run's
    ``notp`` rules (:func:`_trainer`)."""
    import contextlib
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import activation_sharding

    inp = _inputs(tmp, inputs)
    mesh = make_mesh(tuple(shape), tuple(axes), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None                     # a rank outside the mesh
    tr = _trainer(mesh, inp["tc"], inp["lr"], arch=arch, variant=variant,
                  notp=notp)
    loader = ShardedLoader(markov(batch, seq, masked, arch=arch),
                           device="cpu", mesh=mesh)
    first = next(loader)
    loader.seek(0)
    tr.build_step(loader.peek_structure())
    state, hist, params = _start(tr, inp), [], []
    out = {}
    if record:
        out["products"] = products(tr, state, first)
        out["plan"] = None if tr.tp is None else {
            k: getattr(tr.tp, k) for k in
            ("size", "rank", "attn", "mlp", "vocab", "experts")}
        out["flags"] = None if tr.tp is None else {
            k: getattr(tr.tp, k) for k in FLAGS}
        out["dp"] = None if tr.dp is None else [tr.dp.size, tr.dp.index]
        out["local"] = [list(p.to_local().shape) for p in
                        _tree_leaves(state[0])]
    with (contextlib.nullcontext() if spec is None
          else activation_sharding(tuple(spec))):
        for _ in range(steps):
            state, h = tr.fit(loader, 1, state=state)
            hist += h
            params.append(_np_tree(state[0]))
    return {"hist": hist, "state": _np_tree(tuple(state)),
            "params": params, "coord": list(mesh.get_coordinate()),
            "batch": {k: v.numpy() for k, v in first.items()}, **out}


FLAGS = ("attn", "mlp", "vocab", "experts", "mamba", "mlstm", "slstm")


def _tree_leaves(tree):
    from repro_torch.models.lm import tree_leaves
    return list(tree_leaves(tree))


def serve_family(tmp, arch, model, steps, ranks=None):
    """Tensor-parallel serving of ``arch``'s smoke model on a (data 1,
    ``model``) mesh's trainer plan, from the test's state and inputs
    (``serve_<arch>``: a prompt batch, its grown cache's length and the
    decode tokens): ``prefill`` under ``tp``, its cache grown as the test
    grows the reference's, then ``steps`` ``decode_step``s of the given
    tokens.  Returns the plan's flags, the logits of each call and this
    rank's cache after the prefill and after the last step."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.train_loop import _gather, _zip_map

    inp = _inputs(tmp, f"serve_{arch}")
    mesh = make_mesh((1, model), ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tr = _trainer(mesh, {}, None, arch=arch)
    state = _start(tr, inp)
    leaves = _zip_map(_gather, state[0], tr._dims(state[0]))
    m, tp = tr.model, tr.tp
    prompt = {k: torch.from_numpy(v) for k, v in inp["prompt"].items()}
    with torch.no_grad():
        logits, cache = m.prefill(leaves, prompt, tp=tp)
        first = {k: v.numpy().copy() for k, v in cache.items()}
        cache = grow_cache(m, cache, inp["grown"], tp)
        out = [logits.numpy().copy()]
        for tok, pos in zip(inp["tokens"], inp["pos"]):
            logits, cache = m.decode_step(
                leaves, cache, {"token": torch.from_numpy(tok),
                                "pos": torch.from_numpy(pos)}, tp=tp)
            out.append(logits.numpy().copy())
    return {"flags": {k: getattr(tp, k) for k in FLAGS}, "logits": out,
            "prefill_cache": first,
            "cache": {k: v.numpy().copy() for k, v in cache.items()}}


def grow_cache(model, cache, length, tp=None):
    """A prefill's cache in one of ``length`` positions (the decode steps'
    room): the attention caches' prompt positions copied into a fresh
    cache, every other entry kept (torch; the test grows the reference's
    numpy cache alike)."""
    if "k" not in cache:
        return cache
    b, s = cache["k"].shape[1], cache["k"].shape[2]
    grown = model.init_cache(b, length, tp=tp)
    for k in grown:
        if k in ("k", "v"):
            grown[k][:, :, :s] = cache[k]
        else:
            grown[k] = cache[k]
    return grown


def gated_norm(tmp, model, ranks=None):
    """Mamba's gated RMSNorm split over ``model``: this rank's channels of
    the test's rows and scale through ``ssm.gated_rmsnorm`` with the
    plan's ``tp`` (the sum of squares all-reduced), and the gradient of
    sum(out x weights) in the rows and the scale."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ssm import gated_rmsnorm

    inp = _inputs(tmp, "norm")
    mesh = make_mesh((1, model), ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tp = _trainer(mesh, {}, None, arch="jamba-1.5-large-398b").tp
    g, scale, w = (torch.from_numpy(inp[k]).chunk(model, -1)[tp.rank]
                   .clone().requires_grad_(True) for k in ("g", "scale", "w"))
    out = gated_rmsnorm(g, scale, tp)
    torch.sum(out * w).backward()
    return {"out": out.detach().numpy().copy(),
            "g": g.grad.numpy().copy(), "scale": scale.grad.numpy().copy()}


def fit_steps(tmp, shape, axes, arch, batch, seq, inputs):
    """:func:`fit_mesh`'s fit over a mesh of ``shape``, each step from the
    reference's state before it (the inputs ``inputs``, written by the
    test while the ranks run: ``states``, one a step and the last): per
    step the history and the parameters after it, then the plan's flags,
    the data-parallel index, this rank's leaves' shapes and its
    coordinate."""
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
    inp = _inputs(tmp, inputs, wait=600.0)
    tr = _trainer(mesh, {}, LR_STEPS, arch=arch)
    loader = ShardedLoader(markov(batch, seq, arch=arch), device="cpu",
                           mesh=mesh)
    tr.build_step(loader.peek_structure())
    hist, params = [], []
    for i, st in enumerate(inp["states"][:-1]):
        state = _start(tr, {"state": st})
        tr.step = i
        loader.seek(i)
        state, h = tr.fit(loader, 1, state=state)
        hist += h
        params.append(_np_tree(state[0]))
    return {"hist": hist, "params": params,
            "state": _np_tree(tuple(state)),
            "flags": None if tr.tp is None else {
                k: getattr(tr.tp, k) for k in FLAGS},
            "dp": None if tr.dp is None else [tr.dp.size, tr.dp.index],
            "local": [list(p.to_local().shape)
                      for p in _tree_leaves(state[0])],
            "coord": list(mesh.get_coordinate())}


#: the linear schedule of the reference's fits (``_torch_fits.LR``)
LR_STEPS = (3e-3, 2, 20)


def _placed(tree):
    """{path: (this rank's part, [(mesh dim size, sharded tensor dim or
    None)], coordinate)} of a tree's ``DTensor`` leaves."""
    from repro_torch.checkpoint.store import _flatten
    from torch.distributed.tensor import DTensor, Shard
    out = {}
    for path, leaf in _flatten(tree):
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            dims = [(mesh.size(i), pl.dim if isinstance(pl, Shard) else None)
                    for i, pl in enumerate(leaf.placements)]
            out[path] = (leaf.to_local().numpy().copy(), dims,
                         list(mesh.get_coordinate()))
    return out


def elastic(tmp, ckpt_dir, arch="stablelm-3b"):
    """The reference's elastic re-mesh (``tests/test_elastic.py``) on
    ranks: a (data 4, model 2) session over eight ranks trains 10 steps,
    checkpointing every 5; then a (data 2, model 2) session over the
    first four (the others are outside its mesh) restores step 10 onto
    the smaller mesh and trains to step 15.  Returns each session's
    history and, from the second, this rank's restored parts."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import make_mesh

    def session(mesh):
        tr = _trainer(mesh, {}, None, arch=arch)
        tr.ckpt = CheckpointManager(ckpt_dir, save_interval=5)
        loader = ShardedLoader(markov(4, 16, arch=arch), device="cpu",
                               mesh=mesh)
        return tr, loader

    tr1, loader = session(make_mesh((4, 2), ("data", "model"), device="cpu"))
    _, h1 = tr1.fit(loader, 10)
    out = {"h1": h1, "step1": tr1.step}
    mesh = make_mesh((2, 2), ("data", "model"), ranks=range(4),
                     device="cpu")
    if mesh.get_coordinate() is None:
        return out
    tr2, loader = session(mesh)
    state = tr2.init_state(0)
    *state, start = tr2.maybe_restore(*state)
    out["restored"] = _placed({"params": state[0], "opt": state[1],
                               "err": state[2]})
    loader.seek(start)
    _, h2 = tr2.fit(loader, 5, state=tuple(state))
    out.update(h2=h2, step2=tr2.step, start=start)
    return out


def mesh_of_two(tmp):
    """Two pods of one rank each, int8 EF: two steps from ``init_state``
    (history and the gathered parameters); an MoE decoder's trainer and an
    MoE hybrid's over two data-parallel ranks (their ``DataParallel``)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainConfig, Trainer

    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    tr = Trainer(DecoderLM(get_smoke(ARCH)), AdamW(), mesh=mesh,
                 train_cfg=TrainConfig(grad_compression="int8_ef",
                                       log_every=1))
    (params, _, _), hist = tr.fit(ShardedLoader(markov(4, 16),
                                                device="cpu", mesh=mesh), 2)
    moe = dataclasses.replace(get_smoke(ARCH), n_experts=4,
                              experts_per_token=2)
    dp2 = make_mesh((2, 1), ("data", "model"), device="cpu")
    dp = Trainer(DecoderLM(moe), AdamW(), mesh=dp2).dp
    hybrid = Trainer(build_model(get_smoke("jamba-1.5-large-398b")),
                     AdamW(), mesh=dp2)
    return {"hist": hist, "moe": (dp.size, dp.index),
            "hybrid": (type(hybrid.model).__name__, hybrid.dp.size,
                       hybrid.dp.index, hybrid.tp),
            "params": [_np_tree(p) for p in tree_leaves(params)]}


def vocab_ce(tmp, model, ranks=None):
    """The vocabulary-parallel lookup and cross-entropy of a (data 1,
    ``model``) mesh's trainer plan, on the test's inputs (``ce``: the
    tied table, and per length hidden states, labels and a mask): whether
    the lookup of this rank's rows, summed over ``model``, equals the
    whole table's; per length the loss and its gradient in the hidden
    states."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L

    inp = _inputs(tmp, "ce")
    mesh = make_mesh((1, model), ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tr = _trainer(mesh, {}, None)
    tok = torch.from_numpy(inp["tok"])
    mine = {"tok": tok.chunk(model, 0)[tr.tp.rank].clone()}
    out = {}
    for s in (k for k in inp if k != "tok"):
        d = {k: torch.from_numpy(v) for k, v in inp[s].items()}
        out["lookup_equal"] = out.get("lookup_equal", True) and torch.equal(
            L.embed_tokens(mine, d["labels"], torch.float32, tr.tp),
            tok[d["labels"]])
        x = d["x"].clone().requires_grad_(True)
        loss = L.chunked_cross_entropy(tr.cfg, x, mine, d["labels"],
                                       d["mask"], tp=tr.tp)
        loss.backward()
        out[s] = (float(loss), x.grad.numpy().copy())
    return out


def serve_tp(tmp, model, ranks=None):
    """Tensor-parallel serving on a (data 1, ``model``) mesh's trainer
    plan, from the test's state: ``prefill`` of the test's prompts and
    one ``decode_step`` over the test's cache (this rank's KV heads of it
    where attention splits), on the leaves the plan computes with, under
    ``tp``.  Returns the plan's attention flag, the prefill's logits and
    cache, and the decode step's logits."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.train_loop import _gather, _zip_map

    inp = _inputs(tmp, "serve")
    mesh = make_mesh((1, model), ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tr = _trainer(mesh, {}, None)
    state = _start(tr, _inputs(tmp, "plain"))
    leaves = _zip_map(_gather, state[0], tr._dims(state[0]))
    heads = (lambda a: a.chunk(model, 3)[tr.tp.rank]) if tr.tp.attn \
        else (lambda a: a)
    cache = {k: heads(torch.from_numpy(inp[k])).contiguous()
             for k in ("k", "v")}
    cache["len"] = torch.from_numpy(inp["pos"])
    with torch.no_grad():
        logits, pre = tr.model.prefill(
            leaves, {"tokens": torch.from_numpy(inp["tokens"])}, tp=tr.tp)
        step, _ = tr.model.decode_step(
            leaves, cache, {"token": torch.from_numpy(inp["token"]),
                            "pos": torch.from_numpy(inp["pos"])}, tp=tr.tp)
    return {"attn": tr.tp.attn, "prefill": logits.numpy().copy(),
            "k": pre["k"].numpy().copy(), "v": pre["v"].numpy().copy(),
            "decode": step.numpy().copy()}


def _plan_leaves(tr, params):
    """The leaves ``tr``'s plan computes with, from every rank's whole
    ``params`` (a float or an int8-resident tree): this rank's ``model``
    shard where the plan splits a part, the leaf whole elsewhere."""
    from repro_torch.parallel.tensor_parallel import shard_leaf
    from repro_torch.runtime.train_loop import _zip_map
    return _zip_map(lambda p, d: shard_leaf(p, d, tr.tp), params,
                    tr._dims(params))


def seq_decode(tmp, arch, axis, ranks=None):
    """Decode steps over a cache whose sequence is split over the mesh
    axis ``axis`` of two ranks ((data 1, model 2) with ``arch``'s
    tensor-parallel plan, or (data 2, model 1)): every rank builds the
    seeded smoke parameters whole and computes on its plan's leaves,
    holds its half of the test's cache (``seqdec_<arch>``: every
    attention cache's positions, all KV heads) and runs the test's
    tokens through ``decode_step(..., cache_seq=)``.  Returns the logits
    of each step, this rank's cache after them and its offset."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.tensor_parallel import SequenceShards

    inp = _inputs(tmp, f"seqdec_{arch}")
    shape = (1, 2) if axis == "model" else (2, 1)
    mesh = make_mesh(shape, ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tr = _trainer(mesh, {}, None, arch=arch)
    model = tr.model
    params = model.init(torch.Generator().manual_seed(inp["seed"]))
    leaves = _plan_leaves(tr, params)
    half = inp["cache"]["k"].shape[2] // 2
    shards = SequenceShards.of(mesh, (axis,), half)
    cache = {}
    for k, v in inp["cache"].items():
        t = torch.from_numpy(v)
        if k in ("k", "v", "ek", "ev"):
            t = t[:, :, shards.offset:shards.offset + half]
        cache[k] = t.clone()
    out = []
    with torch.no_grad():
        for tok, pos in zip(inp["tokens"], inp["pos"]):
            logits, cache = model.decode_step(
                leaves, cache, {"token": torch.from_numpy(tok),
                                "pos": torch.from_numpy(pos)},
                tp=tr.tp, cache_seq=shards)
            out.append(logits.numpy().copy())
    return {"logits": out, "offset": shards.offset,
            "cache": {k: v.numpy().copy() for k, v in cache.items()}}


def int8w_serve(tmp, ranks=None):
    """The int8-resident serving steps over (data 1, model 2): the seeded
    smoke parameters through ``quantize_tree_stacked`` at 8 bits per
    channel (the dry-run's ``int8w``), this rank's plan leaves of it
    (codes and scale columns of its shards), then ``prefill`` of the
    test's prompts and one ``decode_step`` over the test's cache (this
    rank's KV heads of it where attention splits).  Returns the plan's
    attention flag, the logits, the prefill's cache and this rank's
    held bytes of the quantized leaves."""
    import torch
    from repro_torch.core.quantization import (QuantConfig,
                                               QuantizedTensor,
                                               quantize_tree_stacked)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import tree_leaves

    inp = _inputs(tmp, "int8w")
    mesh = make_mesh((1, 2), ("data", "model"), ranks, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    tr = _trainer(mesh, {}, None)
    params = quantize_tree_stacked(
        tr.model.init(torch.Generator().manual_seed(inp["seed"])),
        QuantConfig(bits=8, granularity="per-channel"))
    leaves = _plan_leaves(tr, params)
    held = sum(q.codes.numel() + 4 * q.scale.numel()
               for q in tree_leaves(leaves) if isinstance(q, QuantizedTensor))
    heads = (lambda a: a.chunk(2, 3)[tr.tp.rank]) if tr.tp.attn \
        else (lambda a: a)
    cache = {k: heads(torch.from_numpy(inp[k])).contiguous()
             for k in ("k", "v")}
    cache["len"] = torch.from_numpy(inp["pos"])
    with torch.no_grad():
        logits, pre = tr.model.prefill(
            leaves, {"tokens": torch.from_numpy(inp["tokens"])}, tp=tr.tp)
        step, _ = tr.model.decode_step(
            leaves, cache, {"token": torch.from_numpy(inp["token"]),
                            "pos": torch.from_numpy(inp["pos"])}, tp=tr.tp)
    return {"attn": tr.tp.attn, "prefill": logits.numpy().copy(),
            "k": pre["k"].numpy().copy(), "v": pre["v"].numpy().copy(),
            "decode": step.numpy().copy(), "held": held}


SCENARIOS = {"fed_podwise": fed_podwise, "fit_mesh": fit_mesh,
             "elastic": elastic, "mesh_of_two": mesh_of_two,
             "vocab_ce": vocab_ce, "serve_tp": serve_tp,
             "serve_family": serve_family, "gated_norm": gated_norm,
             "fit_steps": fit_steps, "seq_decode": seq_decode,
             "int8w_serve": int8w_serve}
