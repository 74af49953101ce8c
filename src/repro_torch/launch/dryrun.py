"""Multi-pod dry-run: every (architecture x shape x mesh x variant) cell of
the production meshes, accounted per device without allocating anything
(``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/dryrun_torch

It runs in its own process: the process joins a fake process group of 512
ranks (``torch.distributed``'s ``"fake"`` backend: collectives return at
once and move nothing) as rank 0, the production mesh is a
``DeviceMesh`` over its first 256 or all 512 ranks, and rank 0's real
step runs once under the accountant (``launch/opcount.py``) on tensors of
the ``meta`` device: shapes and dtypes only, every kernel op through its
fake version, which refuses what the card would.  Meta stands for the
card because PyTorch built without CUDA can neither index nor
backpropagate fake CUDA tensors (their device guard is not linked), so
the same accounting runs here and beside the card.  ``F.rms_norm``, one
fused op on the card that meta would decompose, runs as one op on both
(``models/layers.py``: ``repro_norm::rms_norm``), so meta bills the
card's bytes (``chip_smoke.py`` phase 22 holds them equal).

Per cell the step is this rank's:

  train    ``Trainer._backward`` then ``_apply`` (``runtime/train_loop.py``:
           the state placed by the sharding rules, gathered over every
           axis but ``model``, every family computing on its ``model``
           shards by ``model_plan``, the gradient mean over the
           data-parallel ranks, AdamW on this rank's part); ``gradcomp``
           on the two-pod mesh is the pod-wise int8 step
  prefill  ``model.prefill`` on this rank's rows of the batch
  decode   one ``model.decode_step`` against this rank's part of the
           full-size cache; where the rules split the cache's sequence
           (``cache_seq``: ``data`` at ``long_500k``, ``model`` under
           ``cacheshard``) the step writes on the shard that owns the
           position and merges the shards' attention partials
           (``parallel.tensor_parallel.SequenceShards``)

Every family's serving steps compute tensor-parallel over ``model`` as
its training does (``model_plan``: the parts whose sizes divide on their
shards, the others on leaves gathered whole), and hold the cache as the
rules place it (batch rows, and the ``heads``, ``kv_heads`` and ``ffn``
axes where the part that writes them is split).  Train and prefill
cells run in bfloat16 (the reference's ``_to_bf16``); decode cells in
float32, because the decode step's products run through ``row_gemm``,
which takes float32 only (``model_stats["dtype"]`` says which).  Under
the activation-sharding context (``seqshard``, ``notp`` and the big
archs' training) the training stacks hold the residual sequence-sharded
between blocks; a part computed replicated runs its per-token work on
this rank's chunk, its attention over K and V gathered whole
(``models/layers.py``: ``seq_attention``).  The prefill of the decoder
LM and the hybrid constrains nothing, the xLSTM's runs its forward
(which does), as the reference's.

The record has the reference's keys.  ``hlo`` holds the accountant's
per-device counts under the reference's names; ``cost_analysis`` repeats
its totals (XLA's own counters have no counterpart here).  ``memory``:
``argument_bytes`` is this rank's part of every argument,
``output_bytes`` the step's outputs, ``temp_bytes`` the most bytes the
step allocated that were alive at once.  A cell the reference's own
program refuses gets ``status="error"`` with the reference's error
(:data:`INT8W_TRAIN_REFUSAL`; the families that index their weights
refuse an int8-resident tree); any other failure stops the sweep.

Variants (``--variant``), the reference's:
  baseline        bf16 params and compute (float32 decode, above)
  flash           attention through the fused accounting ops
                  (``parallel.sharding.flash_attention_mode``)
  seqshard        + Megatron-style sequence-parallel activations
  int8w           int8-resident weights (``quantize_tree_stacked`` at 8
                  bits per channel: codes placed as the float leaves,
                  scales replicated; serving cells of the decoder LM)
  int8w+seqshard, gradcomp (int8 error-feedback gradients over ``pod``;
                  two-pod training), cacheshard (the KV cache's sequence
                  over ``model``, flash-decoding partials merged), notp
                  (heads, KV, FFN and vocabulary replicated, the sequence
                  over ``model``), noseqshard (a big arch's training
                  without the sequence split)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ALL_SHAPES, ARCH_IDS, cell_applicable, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..core.quantization import (QuantConfig, QuantizedTensor,
                                 quantize_tree_stacked)
from ..models.lm import DecoderLM, refuse_quantized, tree_leaves, tree_map
from ..models.registry import build_model
from ..optim import AdamW
from ..parallel.sharding import (activation_sharding, batch_shardings,
                                 default_rules, flash_attention_mode, gather,
                                 local_part, tree_shardings)
from ..parallel.tensor_parallel import (cache_shards, model_plan,
                                       shard_leaf)
from ..runtime.train_loop import Trainer, TrainConfig, _map3
from .mesh import make_mesh
from .opcount import account, tensor_bytes

#: archs large enough that the residual stream must be sequence-sharded
#: between blocks for activations (saved-for-backward) to fit HBM
BIG_ARCHS = ("granite-34b", "internlm2-20b", "kimi-k2-1t-a32b",
             "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
             "llava-next-mistral-7b")

WORLD = 512
DEVICE = torch.device("meta")


class Refused(Exception):
    """A cell the reference's own dry-run program refuses; its record is
    ``status="error"`` with the reference's error line."""


def _to_bf16(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, dtype="bfloat16",
                               param_dtype="bfloat16")


def _cell_config(arch: str, shape: ShapeSpec) -> ModelConfig:
    """The cell's config: bfloat16 for training and prefill, float32 for
    decode (``row_gemm``, every decode product's kernel, takes float32
    only)."""
    cfg = get_config(arch)
    return cfg if shape.kind == "decode" else _to_bf16(cfg)


_MESHES: Dict[bool, Any] = {}


def _production_mesh(multi_pod: bool):
    """The production mesh over the fake world's first 256 or 512 ranks,
    the process group joined first (rank 0 of WORLD)."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
    if multi_pod not in _MESHES:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        _MESHES[multi_pod] = make_mesh(shape, axes,
                                       ranks=range(math.prod(shape)),
                                       device="cpu")
    return _MESHES[multi_pod]


def _meta_tree(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=DEVICE), tree)


def _local_tree(tree, shardings):
    """This rank's parts of a tree of full meta tensors.  An int8-resident
    leaf (``QuantizedTensor``) is placed as the reference's
    ``_shard_quantized`` places it: its codes as the float leaf, its
    scale replicated (held whole)."""
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, codes=local_part(
            tree.codes, shardings.mesh, shardings.placements))
    return local_part(tree, shardings.mesh, shardings.placements)


def _bytes(tree) -> int:
    """This rank's bytes of a tree of tensors (a ``DTensor``'s local
    part; a ``QuantizedTensor``'s codes and scale)."""
    def leaves():
        for t in tree_leaves(tree):
            if isinstance(t, QuantizedTensor):
                yield from (t.codes, t.scale)
            elif isinstance(t, torch.Tensor):
                yield getattr(t, "_local_tensor", t)
    return sum(tensor_bytes(t) for t in leaves())


#: the reference's refusal of an ``int8w`` training cell (its
#: ``_cell_fn_and_args`` gives the optimizer no state for the quantized
#: tree), as its dry-run records it
INT8W_TRAIN_REFUSAL = (
    "ValueError: pytree structure error: different types at key path "
    "pjit in_shardings[1] (the reference's int8w train step has no AdamW "
    "state for an int8-resident tree: its in_shardings pair AdamWState "
    "with None)")


def _serving_params(model, cfg, rules, mesh, int8w: bool = False):
    """(the leaves a serving step computes with, ``tp``, this rank's parts
    as held).  The leaves the plan computes on shards of (``model_plan``)
    stay this rank's; the rest are gathered whole.

    ``int8w``: the int8-resident tree (``quantize_tree_stacked`` at 8 bits
    per channel, the reference's ``int8w``), placed as
    :func:`_local_tree` says.  A quantized leaf is gathered as its int8
    codes; one the plan computes on its ``model`` shards keeps its
    scale's columns of its shard.  The step reads every weight through
    ``QuantizedTensor.to``, as the int8-resident forward does."""
    axes = model.logical_axes()
    structs = model.param_structs()
    sh = tree_shardings(axes, structs, rules, mesh)
    full = _meta_tree(structs)
    if int8w:
        full = quantize_tree_stacked(full, QuantConfig(
            bits=8, granularity="per-channel"))
    held = _local_tree(full, sh)
    del full
    tp, local = model_plan(cfg, tree_map(lambda s: s.spec, sh), mesh)

    def whole(part, s, dim):
        if isinstance(part, QuantizedTensor):
            # the codes gathered as int8; the scale (held whole) cut to
            # this rank's columns where the plan keeps the leaf's shard
            return dataclasses.replace(
                part, codes=whole(part.codes, s, dim),
                scale=shard_leaf(part, dim, tp).scale)
        d = DTensor.from_local(part, mesh, s.placements, run_check=False)
        return gather(d, () if dim is None else ("model",))

    def step_leaves():
        return _map3(whole, held, sh, local)
    return step_leaves, tp, held


def _cell_fn_and_args(model, cfg: ModelConfig, shape: ShapeSpec,
                      variant: str, mesh, rules):
    """(fn, held): ``fn()`` runs this rank's step on meta tensors; ``held``
    is the tree of this rank's arguments (its part of the state, batch
    and cache)."""
    int8w = "int8w" in variant
    if int8w and shape.kind == "train":
        raise Refused(INT8W_TRAIN_REFUSAL)
    if int8w and not isinstance(model, DecoderLM):
        # the families that index their weights refuse the tree
        try:
            refuse_quantized(cfg, quantize_tree_stacked(
                model.param_structs(), QuantConfig(
                    bits=8, granularity="per-channel")))
        except TypeError as e:
            raise Refused(f"TypeError: {e}") from None
    in_specs = model.input_specs(shape)
    b_sh = batch_shardings(in_specs, rules, mesh)
    batch = {k: local_part(torch.empty(v.shape, dtype=v.dtype,
                                       device=DEVICE),
                           mesh, b_sh[k].placements)
             for k, v in in_specs.items()}

    if shape.kind == "train":
        pod = "pod" in mesh.mesh_dim_names
        tc = TrainConfig(grad_compression="int8_ef"
                         if "gradcomp" in variant and pod else "none")
        tr = Trainer(model, AdamW(learning_rate=1e-4), device=DEVICE,
                     train_cfg=tc, mesh=mesh, rules=rules)
        full = _meta_tree(model.param_structs())
        err = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=DEVICE), full)
               if tc.grad_compression == "int8_ef"
               else torch.zeros((), dtype=torch.float32, device=DEVICE))
        params, opt_state, err = tr.place_state(full, tr.opt.init(full), err)
        del full
        tr.build_step({"labels": in_specs["labels"]})

        def fn():
            return tr._step(params, opt_state, err, batch)
        held = {"params": tree_map(lambda t: t.to_local(), params),
                "opt": [opt_state.step,
                        tree_map(lambda t: t.to_local(), opt_state.m),
                        tree_map(lambda t: t.to_local(), opt_state.v)],
                "err": tree_map(lambda t: getattr(t, "to_local",
                                                  lambda: t)(), err),
                "batch": batch}
        return fn, held

    leaves, tp, held_params = _serving_params(model, cfg, rules, mesh,
                                              int8w)
    kw = {} if tp is None else {"tp": tp}
    if shape.kind == "prefill":
        def fn():
            return model.prefill(leaves(), batch, **kw)
        return fn, {"params": held_params, "batch": batch}

    c_structs = model.cache_specs(shape)
    # the cache as the step needs it: split by the rules' kv_heads where
    # attention computes on its shards, by heads (and a Mamba conv state
    # by ffn) where the recurrent layers do, whole along those axes where
    # the plan computes the part replicated
    on = {"kv_heads": tp is not None and tp.attn,
          "heads": tp is not None and (tp.mamba or tp.mlstm),
          "ffn": tp is not None and tp.mamba}
    c_rules = {k: (None if k in on and not on[k] else r)
               for k, r in rules.items()}
    c_axes = model.cache_axes()
    c_sh = tree_shardings(c_axes, c_structs, c_rules, mesh)
    cache = _local_tree(_meta_tree(c_structs), c_sh)
    # the attention cache's sequence split over the axes the rules map
    # ``cache_seq`` to (``data`` at long_500k, ``model`` under cacheshard)
    if "cache_seq" in c_axes.get("k", ()):
        d = c_axes["k"].index("cache_seq")
        shards = cache_shards(mesh, c_sh["k"].spec, d, cache["k"].shape[d])
        if shards is not None:
            kw["cache_seq"] = shards

    def fn():
        return model.decode_step(leaves(), cache, batch, **kw)
    return fn, {"params": held_params, "cache": cache, "batch": batch}


def run_cell(arch: str, shape: ShapeSpec, *, multi_pod: bool,
             variant: str = "baseline") -> Dict[str, Any]:
    """Account one cell; returns the roofline record."""
    cfg = _cell_config(arch, shape)
    ok, reason = cell_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec

    t0 = time.monotonic()
    return _account(rec, arch, cfg, shape, _production_mesh(multi_pod),
                    variant, t0)


def run_config(cfg: ModelConfig, shape: ShapeSpec, mesh,
               variant: str = "baseline") -> Dict[str, Any]:
    """Account one cell of any config on any mesh of the process's
    group (a smoke config on a small fake mesh, say), as :func:`run_cell`
    does a production cell; returns the record."""
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                           "variant": variant,
                           "mesh": "x".join(map(str, mesh.shape))}
    return _account(rec, cfg.name, cfg, shape, mesh, variant,
                    time.monotonic())


def _account(rec, arch, cfg, shape, mesh, variant, t0):
    """:func:`run_cell`'s accounting of ``cfg``'s step on ``mesh``."""
    multi_pod = "pod" in mesh.mesh_dim_names
    rules = default_rules(cfg, long_context=shape.name == "long_500k")
    if "cacheshard" in variant:
        rules["cache_seq"] = "model"
    if "notp" in variant:
        for k in ("heads", "kv", "kv_heads", "ffn", "vocab"):
            rules[k] = None
    model = build_model(cfg)
    try:
        fn, held = _cell_fn_and_args(model, cfg, shape, variant, mesh, rules)
    except Refused as e:
        rec.update(status="error", error=str(e),
                   compile_s=round(time.monotonic() - t0, 1))
        return rec

    seq_spec = None
    if "seqshard" in variant or "notp" in variant or (
            arch in BIG_ARCHS and shape.kind == "train"
            and "noseqshard" not in variant):
        batch_axes = ("pod", "data") \
            if (multi_pod and "gradcomp" not in variant) else ("data",)
        seq_spec = (batch_axes if len(batch_axes) > 1 else batch_axes[0],
                    "model")
    with activation_sharding(seq_spec), flash_attention_mode(
            mesh if "flash" in variant else None):
        out, costs = account(fn)

    rec.update(
        status="ok",
        compile_s=round(time.monotonic() - t0, 1),
        memory={
            "argument_bytes": _bytes(held),
            "output_bytes": _bytes(out),
            "temp_bytes": costs.peak_bytes,
            "generated_code_bytes": 0,
        },
        cost_analysis={
            "flops": costs.flops,
            "bytes_accessed": costs.hbm_bytes,
        },
        hlo={
            "flops_per_device": costs.flops,
            "hbm_bytes_per_device": costs.hbm_bytes,
            "collective_bytes_per_device": costs.collective_bytes,
            "collective_breakdown": costs.collective_breakdown,
            "n_while": costs.n_while,
            "trip_counts": costs.trip_counts[:32],
        },
        model_stats={
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1),
            "kind": shape.kind,
            "dtype": cfg.dtype,
        },
    )
    return rec


def _report(rec, args):
    """Print a cell's line and write its record; returns the record."""
    tag = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}|{args.variant}"
    status = rec["status"]
    extra = ""
    if status == "ok":
        mb = rec["memory"]["argument_bytes"] / 2 ** 30
        extra = (f" args={mb:.2f}GiB "
                 f"flops/dev={rec['hlo']['flops_per_device']:.3g}"
                 f" coll/dev="
                 f"{rec['hlo']['collective_bytes_per_device']:.3g}"
                 f" ({rec['compile_s']}s)")
    elif status == "error":
        extra = " " + rec["error"][:160]
    print(f"[{status:5s}] {tag}{extra}", flush=True)
    fname = (f"{rec['arch']}_{rec['shape']}_{rec['mesh'].replace('x','-')}"
             f"_{args.variant}.json")
    with open(os.path.join(args.out, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' or comma list")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells accounted at once, each in a process of "
                         "its own (default 1: in this process)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(ALL_SHAPES) if args.shape == "all" else [
        s for s in ALL_SHAPES if s.name in args.shape.split(",")]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    cells = [(arch, shape, mp) for arch in archs for shape in shapes
             for mp in meshes]
    t_all = time.monotonic()
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp_
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=mp_.get_context("spawn")) as pool:
            futs = [pool.submit(run_cell, a, s, multi_pod=m,
                                variant=args.variant) for a, s, m in cells]
            results = [_report(f.result(), args) for f in
                       cf.as_completed(futs)]
    else:
        results = [_report(run_cell(a, s, multi_pod=m, variant=args.variant),
                           args) for a, s, m in cells]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"of {len(results)} cells in {time.monotonic() - t_all:.1f}s")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
