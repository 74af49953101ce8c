"""Checkpoints, checkpoint/restart training and the training supervisor of
the port, on the CPU (mirrors the checkpoint and training half of
tests/test_fault_tolerance.py).

* ``checkpoint.store``: a round trip restores every leaf bitwise with its
  ``like`` leaf's dtype and device; a corrupt newest step (a damaged file,
  or a damaged file whose manifest ``sha256`` was rewritten to match)
  raises ``CorruptCheckpointError`` and ``restore_latest`` falls back to
  the previous step; ``keep`` bounds the steps kept; ``save_async`` saves
  the tree as it was when called.  The port's (path, dtype, shape, bytes)
  records of a tree of numpy arrays equal the reference's
  ``_serialize_tree`` records (skipped where ``msgpack`` is missing: the
  port's own framing needs it nowhere).
* ``Trainer(ckpt=)``: a run interrupted after step 5 and restored by a
  fresh trainer equals the uninterrupted run bitwise, losses and state.
* ``Supervisor``/``HostSet``: host failures restart the session from the
  newest checkpoint, not from step 0, within the restart budget.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager,
                                    CorruptCheckpointError,
                                    available_steps, latest_step, load_tree,
                                    save_tree, tree_records)
from repro_torch.configs import get_smoke
from repro_torch.data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from repro_torch.models.lm import DecoderLM
from repro_torch.optim import AdamW, AdamWState
from repro_torch.runtime import (HostFailure, HostSet, StragglerMonitor,
                                 Supervisor, TrainConfig, Trainer)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "b": torch.randn(5, generator=g).double()},
            "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                              m={"w": torch.zeros(3, 5)},
                              v={"w": torch.ones(3, 5)}),
            "err": torch.zeros(()),
            "codes": [torch.arange(-4, 4, dtype=torch.int8),
                      np.arange(6, dtype=np.uint8).reshape(2, 3)]}


def _assert_same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for n in tree._fields:
            yield from _leaves(getattr(tree, n))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def test_round_trip(tmp_path):
    tree = _tree()
    path = save_tree(tree, str(tmp_path), 10, metadata={"data_step": 10})
    assert path.endswith("step_10")
    assert not os.path.exists(path + ".tmp")
    restored, manifest = load_tree(str(tmp_path), 10, _tree(seed=1))
    _assert_same(restored, tree)
    assert isinstance(restored["opt"], AdamWState)
    assert manifest["step"] == 10 and manifest["compression"] == "none"
    assert manifest["metadata"] == {"data_step": 10}
    assert manifest["bytes_raw"] == manifest["bytes_compressed"] == \
        os.path.getsize(os.path.join(path, "tree.bin"))
    assert manifest["sha256"] == manifest["sha256_raw"]
    assert available_steps(str(tmp_path)) == [10]
    assert latest_step(str(tmp_path)) == 10
    with pytest.raises(ValueError, match="uncompressed"):
        save_tree(tree, str(tmp_path), 11, compress=True)


def test_missing_leaf_and_shape_mismatch(tmp_path):
    save_tree({"a": torch.zeros(4)}, str(tmp_path), 1)
    with pytest.raises(KeyError, match="missing leaf"):
        load_tree(str(tmp_path), 1, {"b": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        load_tree(str(tmp_path), 1, {"a": torch.zeros(5)})


def test_corrupt_checkpoint_falls_back(tmp_path):
    """A damaged newest file: its sha mismatch -> the previous step."""
    d = str(tmp_path)
    save_tree({"a": torch.arange(4.0)}, d, 10)
    save_tree({"a": torch.arange(4.0) * 2}, d, 20)
    with open(os.path.join(d, "step_20", "tree.bin"), "ab") as f:
        f.write(b"garbage")
    with pytest.raises(CorruptCheckpointError, match="blob sha"):
        load_tree(d, 20, {"a": torch.zeros(4)})
    restored, manifest = CheckpointManager(d).restore_latest(
        {"a": torch.zeros(4)})
    assert manifest["step"] == 10
    assert torch.equal(restored["a"], torch.arange(4.0))


def test_checkpoint_content_corruption_detected(tmp_path):
    """A tampered payload whose manifest ``sha256`` was rewritten to match
    still fails the content checksum (``sha256_raw``)."""
    d = str(tmp_path)
    tree = {"a": torch.arange(8.0)}
    save_tree(tree, d, 10)
    save_tree({"a": torch.arange(8.0) * 3}, d, 20)
    blob_path = os.path.join(d, "step_20", "tree.bin")
    with open(blob_path, "rb") as f:
        blob = bytearray(f.read())
    blob[-40] ^= 0xFF
    with open(blob_path, "wb") as f:
        f.write(bytes(blob))
    mpath = os.path.join(d, "step_20", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["sha256"] = hashlib.sha256(bytes(blob)).hexdigest()
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CorruptCheckpointError, match="content sha"):
        load_tree(d, 20, tree)
    restored, man = CheckpointManager(d).restore_latest(tree)
    assert man["step"] == 10
    assert torch.equal(restored["a"], torch.arange(8.0))


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_retention(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), keep=keep, save_interval=5)
    assert [s for s in range(12) if mgr.should_save(s)] == [5, 10]
    for step in (5, 10, 15, 20):
        mgr.save(step, {"a": torch.full((2,), float(step))})
    assert available_steps(str(tmp_path)) == [5, 10, 15, 20][-keep:]


def test_save_async_snapshots_on_the_callers_thread(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(6.0)
    mgr.save_async(1, {"w": w}, metadata={"data_step": 1})
    w.add_(100.0)                     # the next step changes it in place
    mgr.save_async(2, {"w": w})
    mgr.wait()
    a, _ = load_tree(str(tmp_path), 1, {"w": torch.zeros(6)})
    b, man = mgr.restore_latest({"w": torch.zeros(6)})
    assert torch.equal(a["w"], torch.arange(6.0))
    assert torch.equal(b["w"], torch.arange(6.0) + 100.0)
    assert man["step"] == 2


def test_save_async_surfaces_a_write_error(tmp_path):
    """A background write that fails raises on the next ``wait()``."""
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d))
    d.rmdir()
    d.write_text("not a directory")
    mgr.save_async(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                        # the error is raised once


def test_records_equal_reference_serialize_tree():
    msgpack = pytest.importorskip("msgpack")
    from repro.checkpoint.store import _serialize_tree
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": np.arange(4, dtype=np.int32)},
            "a": [np.float32(2.5), np.zeros((2, 0), np.float64),
                  np.arange(5, dtype=np.int8)],
            "z": {"y": np.ones((2, 2, 2), np.uint8)}}
    ref = msgpack.unpackb(_serialize_tree(tree))["leaves"]
    ours = tree_records(tree)
    assert [(r["path"], r["dtype"], list(r["shape"]), r["data"])
            for r in ref] == [tuple(x) for x in ours]


# ---------------------------------------------------------------------------
# checkpoint/restart training
# ---------------------------------------------------------------------------

def _loader(cfg):
    return ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=16, batch_size=4)),
        device="cpu")


def _trainer(cfg, ckpt=None):
    return Trainer(DecoderLM(cfg), AdamW(learning_rate=1e-3), "cpu",
                   TrainConfig(qat_bits=8, grad_compression="int8_ef",
                               log_every=1), ckpt=ckpt)


def test_interrupted_fit_equals_uninterrupted(tmp_path):
    cfg = get_smoke("qwen2-0.5b")
    full = _trainer(cfg)
    state, hist = full.fit(_loader(cfg), 10)
    losses = [h["loss"] for h in hist]

    mgr = CheckpointManager(str(tmp_path), keep=1, save_interval=5)
    first = _trainer(cfg, mgr)
    saved, hist_a = first.fit(_loader(cfg), 5)
    assert available_steps(str(tmp_path)) == [5]
    # a fresh trainer restores step 5 (bitwise the state it saved) and
    # runs steps 6..10
    second = _trainer(cfg, CheckpointManager(str(tmp_path), keep=1,
                                             save_interval=5))
    restored = second.maybe_restore(*second.init_state(0))
    assert restored[3] == 5 and second.step == 5
    for x, y in zip(_leaves(restored[:3]), _leaves(saved)):
        assert torch.equal(x, y)
    second.step = 0
    final, hist_b = second.fit(_loader(cfg), 5)
    assert second.step == 10
    assert [h["step"] for h in hist_b] == list(range(6, 11))
    assert [h["loss"] for h in hist_a + hist_b] == losses
    for x, y in zip(_leaves(final), _leaves(state)):
        assert torch.equal(x, y)
    assert available_steps(str(tmp_path)) == [10]


class _Session:
    """A restartable training session for the Supervisor tests (the
    reference's, on the port's trainer)."""

    def __init__(self, ckpt_dir: str, n_hosts: int):
        cfg = get_smoke("qwen2-0.5b")
        self.tr = Trainer(DecoderLM(cfg), AdamW(learning_rate=1e-3), "cpu",
                          TrainConfig(log_every=100),
                          ckpt=CheckpointManager(ckpt_dir, save_interval=5))
        self.loader = _loader(cfg)
        self.n_hosts = n_hosts
        self.start = None

    @property
    def step(self):
        return self.tr.step

    def run_until(self, target: int, hosts):
        params, opt, err = self.tr.init_state(0)
        params, opt, err, start = self.tr.maybe_restore(params, opt, err)
        self.start = start
        self.loader.seek(start)
        state = (params, opt, err)
        while self.tr.step < target:
            hosts.check(self.tr.step)       # may raise HostFailure
            state, _ = self.tr.fit(self.loader, 1, state=state)
            if self.tr.ckpt.should_save(self.tr.step):
                self.tr.ckpt.save(self.tr.step,
                                  {"params": state[0], "opt": state[1],
                                   "err": state[2]},
                                  metadata={"data_step": self.tr.step})


def test_supervisor_survives_host_failures(tmp_path):
    hosts = HostSet(n_hosts=4, fail_at={7: 3, 11: 2})
    report = Supervisor(lambda n: _Session(str(tmp_path), n),
                        hosts).run(target_steps=12)
    assert report.final_step >= 12
    assert report.restarts == 2 and report.failures == [3, 2]
    assert hosts.n_alive == 2
    assert report.remesh_history == [4, 3, 2]


def test_supervisor_restart_budget(tmp_path):
    hosts = HostSet(n_hosts=4, fail_at={1: 0, 2: 1, 3: 2})
    sup = Supervisor(lambda n: _Session(str(tmp_path), n), hosts,
                     max_restarts=1)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run(target_steps=20)


def test_supervisor_resumes_from_checkpoint_not_zero(tmp_path):
    sessions = []

    def make(n):
        s = _Session(str(tmp_path), n)
        sessions.append(s)
        return s

    Supervisor(make, HostSet(n_hosts=2, fail_at={8: 1})).run(target_steps=12)
    assert len(sessions) == 2
    assert sessions[1].start == 5 and sessions[1].step == 12
    assert available_steps(str(tmp_path))


def test_host_failure_and_straggler_monitor():
    hosts = HostSet(n_hosts=3, fail_at={2: 1})
    hosts.check(1)
    with pytest.raises(HostFailure) as e:
        hosts.check(2)
    assert e.value.host_id == 1 and hosts.n_alive == 2
    mon = StragglerMonitor(factor=3.0)
    rng = np.random.default_rng(0)
    for _ in range(30):
        for host in range(8):
            base = 1.0 + 0.05 * rng.standard_normal()
            mon.report(host, base * (10.0 if host == 5 else 1.0))
    assert mon.stragglers() == [5]
    quiet = StragglerMonitor(factor=3.0)
    for _ in range(20):
        for host in range(4):
            quiet.report(host, 1.0 + 0.01 * host)
    assert quiet.stragglers() == []
