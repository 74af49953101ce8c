"""The port's dry-run (``repro_torch/launch/dryrun.py``) against the JAX
package's cell definitions, on the CPU.

* The shapes, ``cell_applicable``, ``smoke_shape`` and ``ARCH_IDS`` equal
  the reference's; ``input_specs`` and ``cache_specs`` give the
  reference's shapes and dtypes for every architecture x shape.
* ``run_cell`` through the CLI, in subprocesses (the dry-run joins a
  process-wide fake process group of 512 ranks): qwen2-0.5b x the four
  shapes x both meshes x {``baseline``, ``flash``}, and qwen3-moe
  ``decode_32k`` on both meshes.  Each record is ``ok`` or ``skip`` as
  the reference's ``cell_applicable`` says, with the reference's keys;
  ``model_stats`` equals the reference's formula; ``argument_bytes``
  equals this rank's shards of the arguments, reckoned here from the
  specs alone; the ``flash`` records bill no attention products (the
  roofline adds them).  The reference's ``repro.launch.dryrun`` is never
  imported here: it sets ``XLA_FLAGS`` at import.
"""

import _torch_threads  # noqa: F401  (one torch thread: see the module)

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro import configs as RC
from repro.models.registry import build_model as ref_build
from repro_torch import configs as PC
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.parallel.sharding import default_rules, spec_for

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_KEYS = {"arch", "shape", "variant", "mesh", "status", "compile_s",
            "memory", "cost_analysis", "hlo", "model_stats"}


def test_shapes_and_arch_ids_equal_the_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert [dataclasses.astuple(s) for s in PC.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in RC.ALL_SHAPES]
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.astuple(getattr(PC, name)) == \
            dataclasses.astuple(getattr(RC, name))
    from repro.configs.base import SUBQUADRATIC_FAMILIES as ref_sub
    from repro_torch.configs.base import SUBQUADRATIC_FAMILIES
    assert SUBQUADRATIC_FAMILIES == ref_sub
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.astuple(PC.smoke_shape(kind)) == \
            dataclasses.astuple(RC.smoke_shape(kind))
    for arch in RC.ARCH_IDS + ("fcdnn-16", "blip2-proxy", "git-proxy"):
        rc, pc = RC.get_config(arch), PC.get_config(arch)
        if rc is None:
            continue
        for rs, ps in zip(RC.ALL_SHAPES, PC.ALL_SHAPES):
            assert PC.cell_applicable(pc, ps) == RC.cell_applicable(rc, rs)


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_input_and_cache_specs_equal_the_reference(arch):
    rm, pm = ref_build(RC.get_config(arch)), build_model(PC.get_config(arch))
    for rs, ps in zip(RC.ALL_SHAPES, PC.ALL_SHAPES):
        ri, pi = rm.input_specs(rs), pm.input_specs(ps)
        assert sorted(ri) == sorted(pi)
        for k in ri:
            assert tuple(pi[k].shape) == tuple(ri[k].shape), (k, rs.name)
            assert _dtype(pi[k]) == str(ri[k].dtype)
            assert pi[k].device.type == "meta"
        if rs.kind != "decode":
            continue
        ref_leaves = jax.tree_util.tree_flatten_with_path(
            rm.cache_specs(rs))[0]
        pc = pm.cache_specs(ps)
        assert len(ref_leaves) == len(list(tree_leaves(pc)))
        for path, leaf in ref_leaves:
            t = pc
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == tuple(leaf.shape), (path, rs.name)
            assert _dtype(t) == str(leaf.dtype)
            assert t.device.type == "meta"


# ---------------------------------------------------------------------------
# run_cell through the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's ``main`` three times in one subprocess: qwen2-0.5b's cells
    under both variants, qwen3-moe's ``decode_32k``."""
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = [["--arch", "qwen2-0.5b", "--shape", "all", "--mesh", "both",
             "--variant", v, "--out", str(tmp)] for v in ("baseline",
                                                          "flash")]
    runs.append(["--arch", "qwen3-moe-235b-a22b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp)])
    code = ("from repro_torch.launch import dryrun\n"
            f"assert [dryrun.main(a) for a in {runs!r}] == [0, 0, 0]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return roofline.load_records(str(tmp))


def _local_bytes(shape, dtype, spec, mesh):
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n *= size // math.prod(mesh.shape[a] for a in names)
    return n * torch.empty((), dtype=dtype).element_size()


def _expected_argument_bytes(arch, shape, multi_pod):
    """This rank's bytes of the cell's arguments from the sharding specs:
    parameters (and for training float32 AdamW moments, the int32 step
    and the float32 residual scalar), the batch over ('pod', 'data'),
    the cache by the rules (a decoder LM's)."""
    cfg = PC.get_config(arch)
    if shape.kind != "decode":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  param_dtype="bfloat16")
    model = build_model(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(cfg)

    def pairs(axes, structs):
        if isinstance(axes, dict):
            for k in axes:
                yield from pairs(axes[k], structs[k])
        else:
            yield axes, structs

    def tree(axes, structs, f32=False):
        return sum(_local_bytes(
            tuple(s.shape), torch.float32 if f32 else s.dtype,
            spec_for(a, tuple(s.shape), rules, mesh), mesh)
            for a, s in pairs(axes, structs))
    axes, structs = model.logical_axes(), model.param_structs()
    total = tree(axes, structs)
    if shape.kind == "train":
        total += 2 * tree(axes, structs, f32=True) + 4 + 4
    for s in model.input_specs(shape).values():
        total += _local_bytes(tuple(s.shape), s.dtype, spec_for(
            ("batch",), tuple(s.shape), rules, mesh), mesh)
    if shape.kind == "decode":
        total += tree(model.cache_axes(), model.cache_specs(shape))
    return total


def test_cells_follow_the_reference(records):
    assert len(records) == 4 * 2 * 2 + 2
    by = {(r["arch"], r["shape"], r["mesh"], r["variant"]): r
          for r in records}
    for (arch, shape_name, mesh, variant), rec in by.items():
        shape = next(s for s in RC.ALL_SHAPES if s.name == shape_name)
        ok, reason = RC.cell_applicable(RC.get_config(arch), shape)
        if not ok:
            assert rec["status"] == "skip" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec
        assert REF_KEYS <= set(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "generated_code_bytes"}
        assert set(rec["cost_analysis"]) == {"flops", "bytes_accessed"}
        assert set(rec["hlo"]) == {
            "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collective_breakdown",
            "n_while", "trip_counts"}
        ref_cfg = RC.get_config(arch)
        ms = rec["model_stats"]
        assert ms["params"] == ref_cfg.param_count()
        assert ms["active_params"] == ref_cfg.active_param_count()
        assert ms["tokens"] == shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1)
        assert ms["kind"] == shape.kind
        assert ms["dtype"] == ("float32" if shape.kind == "decode"
                               else "bfloat16")
        assert rec["memory"]["argument_bytes"] == _expected_argument_bytes(
            arch, shape, mesh == "2x16x16")
        hlo = rec["hlo"]
        assert hlo["flops_per_device"] > 0 and hlo["hbm_bytes_per_device"] > 0
        assert rec["cost_analysis"]["flops"] == hlo["flops_per_device"]
        assert roofline.roofline_terms(rec) is not None


def test_flash_records_bill_no_attention_products(records):
    by = {(r["arch"], r["shape"], r["mesh"], r["variant"]): r
          for r in records}
    cfg = PC.get_config("qwen2-0.5b")
    for shape in ("train_4k", "prefill_32k"):
        for mesh in ("16x16", "2x16x16"):
            base = by[("qwen2-0.5b", shape, mesh, "baseline")]["hlo"]
            flash = by[("qwen2-0.5b", shape, mesh, "flash")]["hlo"]
            assert flash["flops_per_device"] < base["flops_per_device"]
            rec = by[("qwen2-0.5b", shape, mesh, "flash")]
            assert roofline._attention_flops_per_device(rec) > 0
            # the baseline's forward attention is the flash kernel's op
            # already, billed q, k, v and out as the accounting op is;
            # only training's plain backward recompute reads more
            if shape == "prefill_32k":
                assert flash["hbm_bytes_per_device"] == \
                    base["hbm_bytes_per_device"]
            else:
                assert flash["hbm_bytes_per_device"] < \
                    base["hbm_bytes_per_device"]
    # prefill: the baseline's attention is exactly the flash op's formula
    # (the blockwise census over 512-blocks): 4 B H S T dh a layer
    for mesh, dp in (("16x16", 16), ("2x16x16", 32)):
        base = by[("qwen2-0.5b", "prefill_32k", mesh, "baseline")]["hlo"]
        flash = by[("qwen2-0.5b", "prefill_32k", mesh, "flash")]["hlo"]
        b = 32 // dp
        assert base["flops_per_device"] - flash["flops_per_device"] == \
            cfg.n_layers * 4 * b * cfg.n_heads * 32768 ** 2 * cfg.head_dim
    for mesh in ("16x16", "2x16x16"):
        d = by[("qwen2-0.5b", "decode_32k", mesh, "baseline")]["hlo"]
        f = by[("qwen2-0.5b", "decode_32k", mesh, "flash")]["hlo"]
        assert f["flops_per_device"] < d["flops_per_device"]
