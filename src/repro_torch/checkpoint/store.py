"""Tree checkpoints: a framed binary file, an integrity manifest, an async
writer (``repro/checkpoint/store.py``).

Format (one directory per step, ``step_<N>/``, as in the reference):

  tree.bin       — the flattened tree: an 8-byte little-endian header
                   length, a JSON header ``{"version": 1, "leaves": [...]}``
                   of one (path, dtype, shape, offset, nbytes) record per
                   leaf, then each leaf's raw little-endian bytes at its
                   offset (64-byte aligned) from the end of the header
  manifest.json  — step, compression, bytes, the file's sha256 and the
                   payload's, user metadata (data step, ...)

The reference frames its records with ``msgpack`` and may compress them
with ``zstandard``; this framing needs only the standard library, so the
port writes no compression (``compression`` is always ``"none"`` and
``sha256_raw`` equals ``sha256``).  Leaf paths are the reference's:
``/``-joined dict keys (sorted, as a JAX pytree flattens them), sequence
indices and NamedTuple field names, and the records of a tree equal the
reference's ``_serialize_tree`` records (path, dtype, shape, bytes).

A step directory is written under ``step_<N>.tmp`` and renamed, so a crash
mid-write never leaves half a checkpoint.  Restores go into the structure
of a ``like`` tree, each leaf onto its ``like`` leaf's device.  The async
writer copies the tree to the host on the caller's thread (the next step
must not change what is being saved) and writes it on a background thread,
so the training loop only blocks on ``wait()`` or at the next save.

Sharded trees (``DTensor`` leaves, ``runtime/train_loop.py`` over a mesh)
are saved whole: every rank of the mesh joins the gathers, the rank at the
mesh's origin alone writes, and the others wait for the write at a barrier
(in ``save``, or in the ``wait`` that follows ``save_async``), so a
checkpoint on disk is always complete before any rank goes on.  The
records are those of the unsharded tree.  Restores are shard-aware, as the
reference's: ``shardings`` (a tree of ``parallel.sharding.NamedSharding``)
or a ``DTensor`` leaf of ``like`` gives each leaf's mesh and placements,
and each rank keeps its part of the saved tensor, on any mesh: the elastic
restart restores a checkpoint onto a smaller mesh this way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..parallel.sharding import gather, mesh_barrier, place

_TREE_FILE = "tree.bin"
_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")
_ALIGN = 64


class CorruptCheckpointError(IOError):
    """A checkpoint's bytes do not match its manifest checksums.

    Subclasses ``IOError`` so ``CheckpointManager.restore_latest`` keeps
    treating a corrupt step as "fall back to the previous one" without
    callers having to know about this type."""


# ---------------------------------------------------------------------------
# flattening (the reference's pytree order and path strings)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs: dicts in sorted-key order, NamedTuples by field
    name, lists and tuples by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _flatten(getattr(tree, name), prefix + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _flatten(sub, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(getattr(like, n), leaves,
                                       prefix + (n,))
                            for n in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _host(leaf) -> np.ndarray:
    """A little-endian host copy of one leaf (a tensor is copied even on
    the CPU, so a later in-place update cannot reach it; a ``DTensor`` is
    gathered whole, a collective over its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = gather(leaf)
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf)
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def snapshot_tree(tree) -> List[Tuple[str, np.ndarray]]:
    """The tree as (path, host array) pairs, copied now."""
    return [(path, _host(leaf)) for path, leaf in _flatten(tree)]


def tree_records(tree) -> List[Tuple[str, str, List[int], bytes]]:
    """(path, dtype string, shape, raw bytes) per leaf: the fields of the
    reference's ``_serialize_tree`` records."""
    return [(p, a.dtype.str, list(a.shape), a.tobytes())
            for p, a in snapshot_tree(tree)]


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

def _pad(n: int) -> int:
    return -n % _ALIGN


def _write_tree(path: str, leaves: List[Tuple[str, np.ndarray]]) -> Tuple[
        int, str]:
    """Write ``tree.bin``; returns (its bytes, its sha256), hashed as it is
    written (the payload is never assembled in memory)."""
    records, offset = [], 0
    for p, a in leaves:
        records.append({"path": p, "dtype": a.dtype.str,
                        "shape": list(a.shape), "offset": offset,
                        "nbytes": int(a.nbytes)})
        offset += a.nbytes + _pad(a.nbytes)
    header = json.dumps({"version": 1, "leaves": records}).encode()
    header += b" " * _pad(8 + len(header))
    digest = hashlib.sha256()
    total = 0

    def put(f, buf):
        nonlocal total
        digest.update(buf)
        f.write(buf)
        total += len(buf)

    with open(path, "wb") as f:
        put(f, struct.pack("<Q", len(header)))
        put(f, header)
        for _, a in leaves:
            put(f, a.reshape(-1).view(np.uint8))
            if _pad(a.nbytes):
                put(f, b"\0" * _pad(a.nbytes))
    return total, digest.hexdigest()


def _read_records(blob: bytearray) -> Dict[str, np.ndarray]:
    """Path -> array view into ``blob`` (which stays writable, so a CPU
    restore shares it)."""
    (n,) = struct.unpack_from("<Q", blob, 0)
    header = json.loads(bytes(blob[8:8 + n]))
    base = 8 + n
    out = {}
    for rec in header["leaves"]:
        dt = np.dtype(rec["dtype"])
        arr = np.frombuffer(blob, dtype=dt, count=rec["nbytes"] // dt.itemsize,
                            offset=base + rec["offset"])
        out[rec["path"]] = arr.reshape(tuple(rec["shape"]))
    return out


def save_tree(tree: Any, directory: str, step: int,
              metadata: Optional[Dict[str, Any]] = None,
              compress: Optional[bool] = None) -> str:
    """Synchronous checkpoint write; returns the step directory.
    ``compress=True`` raises: the port writes uncompressed."""
    if compress:
        raise ValueError("repro_torch checkpoints are uncompressed "
                         "(compression 'none'); pass compress=False")
    mesh = _mesh_of(tree)
    leaves = snapshot_tree(tree)
    path = os.path.join(directory, f"step_{step}")
    if _is_writer(mesh):
        path = _save_leaves(leaves, directory, step, metadata)
    if mesh is not None:
        mesh_barrier(mesh)
    return path


def _mesh_of(tree):
    """The mesh of a tree's ``DTensor`` leaves (the trainer's state has
    one), or None for an unsharded tree."""
    for _, leaf in _flatten(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _is_writer(mesh) -> bool:
    """Whether this rank writes: always without a mesh, else the rank at
    the mesh's origin."""
    return mesh is None or not any(mesh.get_coordinate())


def _save_leaves(leaves: List[Tuple[str, np.ndarray]], directory: str,
                 step: int, metadata: Optional[Dict[str, Any]]) -> str:
    """Write :func:`snapshot_tree`'s pairs as step ``step``."""
    step_dir = os.path.join(directory, f"step_{step}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    nbytes, sha = _write_tree(os.path.join(tmp_dir, _TREE_FILE), leaves)
    manifest = {
        "step": step,
        "compression": "none",
        "bytes_raw": nbytes,
        "bytes_compressed": nbytes,
        "sha256": sha,
        # the content checksum of the reference: over the uncompressed
        # payload, which is the file itself here; still checked on load,
        # so a tampered file whose "sha256" was rewritten to match fails
        "sha256_raw": sha,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def load_tree(directory: str, step: int, like: Any,
              shardings: Optional[Any] = None
              ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays): each leaf takes its ``like`` leaf's dtype and, for a tensor,
    its device.  Where ``shardings`` (a tree matching ``like`` whose
    leaves are ``NamedSharding`` or None) has a sharding, or the ``like``
    leaf is a ``DTensor``, the leaf becomes a ``DTensor`` holding this
    rank's part on that mesh.  Raises :class:`CorruptCheckpointError` on
    a checksum mismatch, ``KeyError``/``ValueError`` on a missing leaf or
    shape."""
    step_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(step_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    path = os.path.join(step_dir, _TREE_FILE)
    blob = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(blob)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != manifest["sha256"]:
        raise CorruptCheckpointError(
            f"checkpoint {step_dir} corrupt: blob sha mismatch")
    if manifest.get("compression", "none") != "none":
        raise ValueError(f"checkpoint {step_dir}: compression "
                         f"{manifest['compression']!r} is not readable here")
    want_raw = manifest.get("sha256_raw")
    if want_raw is not None and digest != want_raw:
        raise CorruptCheckpointError(
            f"checkpoint {step_dir} corrupt: content sha mismatch")
    records = _read_records(blob)
    shard_of = dict(_flatten(shardings)) if shardings is not None else {}
    leaves = {}
    for key, leaf in _flatten(like):
        if key not in records:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = records[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
        sharding = shard_of.get(key)
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            t = torch.from_numpy(arr).to(device=local.device,
                                         dtype=leaf.dtype)
            if sharding is not None:
                t = place(t, sharding.mesh, sharding.placements)
            elif isinstance(leaf, DTensor):
                t = place(t, leaf.device_mesh, leaf.placements)
            leaves[key] = t
        else:
            want = np.asarray(leaf).dtype
            leaves[key] = arr.astype(want) if arr.dtype != want else arr
    return _unflatten(like, leaves), manifest


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Manager: retention + async writes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointManager:
    """Periodic/async checkpointing with bounded retention."""

    directory: str
    keep: int = 3
    save_interval: int = 100

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None      # the mesh of a sharded save_async's tree

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Write ``tree`` as step ``step`` now (a sharded tree: a
        collective call of every rank of its mesh)."""
        self.wait()
        path = save_tree(tree, self.directory, step, metadata)
        if _is_writer(_mesh_of(tree)):
            self._retain()
        return path

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[Dict[str, Any]] = None) -> None:
        """Copy the tree to the host now (blocking; gathered whole where
        it is sharded), then write it on a background thread (the writing
        rank's only)."""
        self.wait()
        host = snapshot_tree(tree)
        self._mesh = _mesh_of(tree)
        if not _is_writer(self._mesh):
            return

        def work():
            try:
                _save_leaves(host, self.directory, step, metadata)
                self._retain()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait(self) -> None:
        """Wait for the last ``save_async`` to be on disk: its writer
        joins its thread, and after a sharded save every rank of the mesh
        waits for the writer."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        mesh, self._mesh = self._mesh, None
        if mesh is not None:
            mesh_barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like: Any, shardings: Optional[Any] = None):
        """(tree, manifest) from the newest intact checkpoint, else None;
        ``shardings`` as :func:`load_tree`'s."""
        self.wait()
        for step in reversed(available_steps(self.directory)):
            try:
                return load_tree(self.directory, step, like, shardings)
            except (IOError, KeyError, ValueError):
                continue  # corrupt/partial: fall back to the previous one
        return None

    def _retain(self):
        steps = available_steps(self.directory)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
