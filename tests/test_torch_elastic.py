"""Elastic re-mesh of the port's training on gloo ranks, on the CPU: the
port's counterpart of ``tests/test_elastic.py``.

Eight ranks train stablelm-3b's smoke config over a (data 4, model 2)
mesh for 10 steps, checkpointing every 5 (the sharded state written whole
by the mesh's first rank).  Then "half the hosts are lost": a (data 2,
model 2) mesh over four of them restores the step-10 checkpoint onto the
smaller mesh, each rank keeping its part, and trains to step 15.  Every
restored part is bitwise its slice of the checkpoint, read back here with
``load_tree``; the losses pass the reference's assertions.  Beside it,
the port's fault-tolerant training example runs on two ranks.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_ranks import join_world, start_world
from repro_torch.checkpoint import load_tree
from repro_torch.checkpoint.store import _flatten

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _slice(full, dims, coord):
    """The part of ``full`` at ``coord`` of a mesh with (size, sharded
    tensor dim) per mesh dimension, split in mesh order."""
    part = full
    for (size, d), c in zip(dims, coord):
        if d is not None:
            part = np.split(part, size, axis=d)[c]
    return part


@pytest.fixture(scope="module")
def example():
    """``examples/torch_fault_tolerant_training.py`` under ``torchrun``
    on two CPU ranks, started before the elastic world and read after."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         str(ROOT / "examples" / "torch_fault_tolerant_training.py"),
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1",
                                      PYTHONPATH=str(ROOT / "src")))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_elastic_remesh_eight_to_four_ranks(tmp_path, example):
    ckpt = str(tmp_path / "ckpt")
    ranks = join_world(start_world(
        8, [("elastic", dict(ckpt_dir=ckpt))], str(tmp_path), "elastic"),
        timeout=300)
    outs = [r[0] for r in ranks]
    assert all(o["step1"] == 10 for o in outs)
    survivors = [o for o in outs if "h2" in o]
    assert len(survivors) == 4
    h1 = outs[0]["h1"]
    for o in outs:       # one loss for all ranks
        assert [h["loss"] for h in o["h1"]] == [h["loss"] for h in h1]
    for o in survivors:
        assert o["start"] == 10 and o["step2"] == 15
        h2 = o["h2"]
        assert [h["step"] for h in h2] == [11, 12, 13, 14, 15]
        losses = [h["loss"] for h in h1 + h2]
        assert all(np.isfinite(x) for x in losses)
        assert h2[-1]["loss"] < h1[0]["loss"] + 1.0
    # every restored part is its slice of the checkpoint at step 10
    state = {path: part for path, (part, _, _) in
             survivors[0]["restored"].items()}
    like = {}
    for path, part in state.items():
        node = like
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = np.zeros(_full_shape(survivors[0]["restored"][path]),
                              part.dtype)
    tree, manifest = load_tree(ckpt, 10, like)
    assert manifest["metadata"]["data_step"] == 10
    full = dict(_flatten(tree))
    sharded = 0
    for o in survivors:
        for path, (part, dims, coord) in o["restored"].items():
            np.testing.assert_array_equal(part,
                                          _slice(full[path], dims, coord))
            sharded += part.size < full[path].size
    assert sharded > 0           # the model axis shards some leaves


def _full_shape(entry):
    part, dims, _ = entry
    shape = list(part.shape)
    for size, d in dims:
        if d is not None:
            shape[d] *= size
    return tuple(shape)


def test_fault_tolerant_example_on_two_ranks(example):
    """The example prints the reference example's lines: two restarts
    after losing hosts 5 and 2, the sessions rebuilt over 8, 7 and 6
    hosts, each restored from the newest checkpoint, finishing at 30."""
    out, err = example.communicate(timeout=300)
    assert example.returncode == 0, err[-3000:]
    assert "restored checkpoint at step 10" in out
    assert "restored checkpoint at step 20" in out
    assert out.rstrip().endswith(
        "finished at step 30: 2 restarts after losing hosts [5, 2]; "
        "mesh sizes [8, 7, 6]"), out
