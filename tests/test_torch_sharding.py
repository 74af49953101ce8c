"""The port's meshes and sharding rules against the reference's, on the
CPU (no ranks: the production meshes are abstract, as in the reference).

For every registered config, full and smoke, on the abstract (data 16,
model 16) and (pod 2, data 16, model 16) production meshes, with and
without ``long_context``: every parameter's spec (``tree_shardings``
over ``param_structs()``) equals the reference's ``PartitionSpec``
entries, and so do ``batch_shardings``' for batch leaves that do and do
not divide.  Then the reference's own cases
(``tests/test_sharding_and_data.py``) and the ``DTensor`` placements a
spec becomes.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models.registry import build_model as jbuild_model
from repro.parallel import sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.registry import build_model
from repro_torch.models.lm import tree_leaves
from repro_torch.parallel import sharding as tsh

ARCHS = sorted(tconfigs._PORTED)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _axes_leaves(axes):
    """The axis tuples of a logical-axes tree in sorted-key order."""
    if isinstance(axes, dict):
        out = []
        for k in sorted(axes):
            out += _axes_leaves(axes[k])
        return out
    return [axes]


def _specs(tree):
    return [s.spec for s in _axes_leaves(tree)]


def test_all_configs_registered_alike():
    assert ARCHS == sorted(jconfigs._MODULES) and len(ARCHS) == 13


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_param_specs_equal_the_reference(arch, full):
    get = "get_config" if full else "get_smoke"
    cfg, jcfg = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
    if jcfg is None:                    # fcdnn-16: no ModelConfig
        assert cfg is None
        return
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    structs, jstructs = model.param_structs(), jmodel.param_structs()
    axes, jaxes = model.logical_axes(), jmodel.logical_axes()
    assert _axes_leaves(axes) == jax.tree_util.tree_leaves(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))
    shapes = [tuple(t.shape) for t in tree_leaves(structs)]
    assert shapes == [tuple(s.shape) for s in
                      jax.tree_util.tree_leaves(jstructs)]
    for shape, names in MESHES:
        amesh = tmesh.make_abstract_mesh(shape, names)
        jamesh = jmesh.make_abstract_mesh(shape, names)
        for long_context in (False, True):
            rules = tsh.default_rules(cfg, long_context=long_context)
            jrules = jsh.default_rules(jcfg, long_context=long_context)
            assert rules == jrules
            got = _specs(tsh.tree_shardings(axes, structs, rules, amesh))
            want = [tuple(sh.spec) for sh in jax.tree_util.tree_leaves(
                jsh.tree_shardings(jaxes, jstructs, jrules, jamesh),
                is_leaf=lambda x: hasattr(x, "spec"))]
            assert got == want


@pytest.mark.parametrize("shape,names", MESHES)
def test_batch_specs_equal_the_reference(shape, names):
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    amesh = tmesh.make_abstract_mesh(shape, names)
    jamesh = jmesh.make_abstract_mesh(shape, names)
    structs = {f"b{b}": np.empty((b, 8), np.int32)
               for b in (1, 8, 16, 32, 48, 512, 1024)}
    structs["scalar"] = np.empty((), np.float32)
    for long_context in (False, True):
        got = tsh.batch_shardings(
            structs, tsh.default_rules(cfg, long_context=long_context),
            amesh)
        want = jsh.batch_shardings(
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in structs.items()},
            jsh.default_rules(cfg, long_context=long_context), jamesh)
        assert {k: s.spec for k, s in got.items()} == {
            k: tuple(s.spec) for k, s in want.items()}


def test_spec_divisibility_fallback():
    """``tests/test_sharding_and_data.py``'s cases."""
    mesh = tmesh.make_abstract_mesh((16, 16), ("data", "model"))
    rules = {"heads": "model", "embed": "data", "kv": "model"}
    assert tsh.spec_for(("embed", "heads"), (64, 64), rules, mesh) == \
        tuple(P("data", "model"))
    # 14 q-heads don't divide 16 -> that dim replicates (qwen2 case)
    assert tsh.spec_for(("embed", "heads"), (64, 14), rules, mesh) == \
        tuple(P("data"))
    # kv=1 (granite MQA) can't shard either
    assert tsh.spec_for(("kv",), (1,), rules, mesh) == tuple(P())


def test_production_and_abstract_meshes():
    one, two = (tmesh.make_production_mesh(),
                tmesh.make_production_mesh(multi_pod=True))
    for got, want in ((one, jmesh.make_abstract_mesh((16, 16),
                                                     ("data", "model"))),
                      (two, jmesh.make_abstract_mesh(
                          (2, 16, 16), ("pod", "data", "model")))):
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
    assert (one.size, two.size) == (256, 512)
    assert tmesh.HBM_BYTES == 80 * 10 ** 9 and tmesh.HBM_BW == 3.35e12
    assert tmesh.PEAK_FLOPS_TF32 == 495e12


def test_placements_of_a_spec():
    mesh = tmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements_for((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements_for((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert tsh.placements_for((), mesh) == (Replicate(),) * 3
    assert tsh.NamedSharding(mesh, ("data",)).placements == (
        Replicate(), Shard(0), Replicate())
    assert tsh.replicated(mesh).spec == ()
