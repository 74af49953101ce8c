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
the same accounting runs here and beside the card.  An op that PyTorch
decomposes by device is billed as meta decomposes it: ``F.rms_norm`` is
one fused op on the card and five on meta (measured on the card: +0.1 to
+4.6 % of the HBM bytes of a forward, decode step, prefill or training
step; ``chip_smoke.py`` phase 22).

Per cell the step is this rank's:

  train    ``Trainer._backward`` then ``_apply`` (``runtime/train_loop.py``:
           the state placed by the sharding rules, gathered over every
           axis but ``model``, a decoder LM computing on its ``model``
           shards by ``decoder_plan``, the gradient mean over the
           data-parallel ranks, AdamW on this rank's part); ``gradcomp``
           on the two-pod mesh is the pod-wise int8 step
  prefill  ``model.prefill`` on this rank's rows of the batch
  decode   one ``model.decode_step`` against this rank's part of the
           full-size cache

A decoder LM's serving steps compute tensor-parallel over ``model`` as
its training does; the other families gather every weight whole first
and compute replicated (ROADMAP A.7.1(b)), and hold the cache whole but
for their batch rows.  Train and prefill cells run in bfloat16 (the
reference's ``_to_bf16``); decode cells in float32, because the decode
step's products run through ``row_gemm``, which takes float32 only
(``model_stats["dtype"]`` says which).

The record has the reference's keys.  ``hlo`` holds the accountant's
per-device counts under the reference's names; ``cost_analysis`` repeats
its totals (XLA's own counters have no counterpart here).  ``memory``:
``argument_bytes`` is this rank's part of every argument,
``output_bytes`` the step's outputs, ``temp_bytes`` the most bytes the
step allocated that were alive at once.  A variant the port's program
cannot express (the port raises ``NotImplementedError`` for it) gets
``status="error"`` naming what is missing; any other failure stops the
sweep.

Variants (``--variant``): ``baseline``; ``flash`` (attention through the
fused accounting ops, ``parallel.sharding.flash_attention_mode``);
``seqshard`` (the residual sequence-sharded between blocks: training; a
decode step's one position is not split); ``gradcomp`` (the pod-wise
int8 exchange, two-pod training); the modifiers ``notp`` and
``noseqshard``.  Not ported (``error``): ``int8w``, ``cacheshard`` on a
decode cell, ``seqshard`` and ``notp`` on a prefill cell.
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
from ..models.lm import DecoderLM, tree_leaves, tree_map
from ..models.registry import build_model
from ..optim import AdamW
from ..parallel.sharding import (activation_sharding, batch_shardings,
                                 default_rules, flash_attention_mode, gather,
                                 local_part, tree_shardings)
from ..parallel.tensor_parallel import decoder_plan
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
    """This rank's parts of a tree of full meta tensors."""
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], shardings[k]) for k in tree}
    return local_part(tree, shardings.mesh, shardings.placements)


def _bytes(tree) -> int:
    """This rank's bytes of a tree of tensors (a ``DTensor``'s local
    part)."""
    return sum(tensor_bytes(getattr(t, "_local_tensor", t))
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _serving_params(model, cfg, rules, mesh):
    """(the leaves a serving step computes with, ``tp``, this rank's parts
    as held).  A decoder LM keeps the leaves it computes on shards of
    (``decoder_plan``) and gathers the rest whole; other families gather
    every leaf whole."""
    axes = model.logical_axes()
    structs = model.param_structs()
    sh = tree_shardings(axes, structs, rules, mesh)
    held = _local_tree(_meta_tree(structs), sh)
    tp, local = None, tree_map(lambda _: None, held)
    if isinstance(model, DecoderLM):
        specs = tree_map(lambda s: s.spec, sh)
        tp, plan = decoder_plan(cfg, specs, mesh)
        local = plan

    def whole(part, s, dim):
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
    if "int8w" in variant:
        raise NotImplementedError(
            "int8w: the int8-resident tree (core.quantization."
            "quantize_tree_stacked) is not placed over a mesh in the port")
    if "cacheshard" in variant and shape.kind == "decode":
        raise NotImplementedError(
            "cacheshard: the port's decode step writes and attends the "
            "cache whole along the sequence (no sequence-sharded cache)")
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

    if shape.kind == "prefill" and ("seqshard" in variant
                                    or "notp" in variant):
        raise NotImplementedError(
            f"{variant}: the port's prefill does not hold the residual "
            "sequence-sharded (activation_sharding serves the training "
            "step)")
    leaves, tp, held_params = _serving_params(model, cfg, rules, mesh)
    kw = {} if tp is None else {"tp": tp}
    if shape.kind == "prefill":
        def fn():
            return model.prefill(leaves(), batch, **kw)
        return fn, {"params": held_params, "batch": batch}

    c_structs = model.cache_specs(shape)
    # the cache as the step needs it: a decoder LM's split where its
    # attention is (the rules' kv_heads), another family's whole but for
    # its batch rows
    c_rules = rules if isinstance(model, DecoderLM) else \
        {"batch": rules["batch"]}
    c_sh = tree_shardings(model.cache_axes(), c_structs, c_rules, mesh)
    cache = _local_tree(_meta_tree(c_structs), c_sh)

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
    mesh = _production_mesh(multi_pod)
    rules = default_rules(cfg, long_context=shape.name == "long_500k")
    if "cacheshard" in variant:
        rules["cache_seq"] = "model"
    if "notp" in variant:
        for k in ("heads", "kv", "kv_heads", "ffn", "vocab"):
            rules[k] = None
    model = build_model(cfg)
    try:
        fn, held = _cell_fn_and_args(model, cfg, shape, variant, mesh, rules)
    except NotImplementedError as e:
        rec.update(status="error", error=f"NotImplementedError: {e}",
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
