"""Logical-axis -> mesh-axis sharding rules (``repro/parallel/sharding.py``).

Every model names the logical axes of its parameters (``logical_axes()``,
a tree of tuples mirroring the parameter tree).  These rules map them to
mesh axes for a concrete mesh, with the reference's guards:

  * a dimension whose size does not divide the product of its mesh axes
    is replicated instead (qwen2's 14 query heads on a 16-way axis,
    granite's single KV head);
  * a mesh axis shards at most one dimension of a leaf;
  * ``long_context`` maps ``cache_seq`` to ``data``.

Default mapping (the reference's):

  batch       -> ('pod', 'data')     activations / cache batch
  heads/kv/ffn/vocab/experts -> 'model'
  embed       -> 'data' iff cfg.fsdp (ZeRO-3-style weight sharding)
  cache_seq   -> None, or 'data' with long_context
  everything else -> replicated

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry
per leading dimension: None, an axis name, or a tuple of axis names,
trailing Nones dropped.  :func:`placements_for` turns it into ``DTensor``
placements, ``Shard(dim)`` or ``Replicate()`` per mesh dimension.  The
port holds the parameters, the AdamW moments and the int8 residual as
``DTensor``s so placed; a training step gathers them over every mesh
axis but ``model`` and computes on its ``model`` shards where the part
they belong to divides (``parallel/tensor_parallel.py``,
``runtime/train_loop.py``).

:func:`activation_sharding` and :func:`constrain_activations` are the
reference's sequence-parallel context: under tensor-parallel compute, a
spec that maps the sequence axis (the second) to ``model`` holds the
residual stream sequence-sharded between blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import axis_sizes

LogicalRules = Dict[str, Any]  # logical name -> mesh axis | tuple | None
Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Activation-sharding context (Megatron-style sequence parallelism)
# ---------------------------------------------------------------------------
# The reference constrains the [B, S, D] residual at every layer boundary to
# this spec (typically (('pod', 'data'), 'model')) and GSPMD inserts the
# all-gather before attention and the MLP and the reduce-scatter after them.
# The port's tensor-parallel blocks do so by hand: with the sequence entry
# on 'model' each block takes and returns this rank's sequence chunk.

_ACTIVATION_SPEC: Optional[Spec] = None


@contextlib.contextmanager
def activation_sharding(spec: Optional[Spec]):
    """Within the context, models hold the residual stream as ``spec``
    (a spec tuple over [B, S, D]) says."""
    global _ACTIVATION_SPEC
    prev = _ACTIVATION_SPEC
    _ACTIVATION_SPEC = spec
    try:
        yield
    finally:
        _ACTIVATION_SPEC = prev


def sequence_sharded(tp, seq_len: int) -> bool:
    """Whether the residual of a ``seq_len`` sequence is held
    sequence-sharded over ``tp``'s ``model`` group: under the context,
    with the spec's sequence entry on ``model`` and a length that
    divides."""
    spec = _ACTIVATION_SPEC
    if tp is None or spec is None or len(spec) < 2:
        return False
    entry = spec[1]
    names = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return "model" in names and seq_len % tp.size == 0


def constrain_activations(x: torch.Tensor, tp=None) -> torch.Tensor:
    """The full residual [B, S, D] as the ambient spec holds it between
    blocks: this rank's sequence chunk where :func:`sequence_sharded`
    (chunk forward, all-gather backward), else ``x``.  A no-op outside
    the context and without tensor-parallel compute.  The blocks keep the
    layout, so one call at the layer stack's entry holds it between all
    of them (the reference constrains at each boundary)."""
    if x.dim() < 2 or not sequence_sharded(tp, x.shape[1]):
        return x
    return tp.split(x, 1)


# ---------------------------------------------------------------------------
# Fused-attention (flash) accounting mode
# ---------------------------------------------------------------------------
# When set to a mesh, the models route full-sequence and decode attention
# through the fused accounting ops (models/layers.fused_attention_acct and
# fused_decode_attention_acct): one opaque op a layer whose operands and
# results are the fused kernel's interface (q, k, v -> out), so the
# dry-run's accountant bills the kernel's HBM traffic instead of the plain
# attention's score blocks.  On the card the same op launches the flash
# kernel.

_FLASH_MESH = None


@contextlib.contextmanager
def flash_attention_mode(mesh):
    """Within the context, attention runs through the accounting ops over
    ``mesh`` (None: the ordinary paths)."""
    global _FLASH_MESH
    prev = _FLASH_MESH
    _FLASH_MESH = mesh
    try:
        yield
    finally:
        _FLASH_MESH = prev


def flash_mesh():
    return _FLASH_MESH


def default_rules(cfg, *, long_context: bool = False) -> LogicalRules:
    return {
        "batch": ("pod", "data"),
        "heads": "model",
        "kv": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "gates": "model",
        "cache_seq": "data" if long_context else None,
        "embed": "data" if cfg.fsdp else None,
    }


def _physical_axes(rule, names) -> Tuple[str, ...]:
    """A rule entry as a tuple of the mesh's axes."""
    if rule is None:
        return ()
    if isinstance(rule, str):
        rule = (rule,)
    return tuple(a for a in rule if a in names)


def spec_for(axes: Tuple[str, ...], shape: Tuple[int, ...],
             rules: LogicalRules, mesh) -> Spec:
    """The spec of one leaf, with the divisibility fallback."""
    sizes = axis_sizes(mesh)
    entries = []
    used: set = set()
    for dim, name in zip(shape, axes):
        phys = _physical_axes(rules.get(name), sizes)
        phys = tuple(a for a in phys if a not in used)
        size = math.prod(sizes[a] for a in phys) if phys else 1
        if phys and dim % size == 0:
            entries.append(phys if len(phys) > 1 else phys[0])
            used.update(phys)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_for(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dimension ``Shard(d)`` where the spec maps tensor dimension d to it,
    else ``Replicate()``.  A dimension over several mesh axes is split
    over the first of them, then each part over the next (the
    reference's major-to-minor order)."""
    names = tuple(axis_sizes(mesh))
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec = ()

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def _map(fn, axes_tree, struct_tree):
    if isinstance(axes_tree, dict):
        return {k: _map(fn, axes_tree[k], struct_tree[k]) for k in axes_tree}
    return fn(axes_tree, struct_tree)


def tree_shardings(axes_tree, struct_tree, rules: LogicalRules, mesh):
    """A :class:`NamedSharding` tree matching ``struct_tree`` (tensors,
    ``meta`` tensors from ``param_structs()``, or anything with
    ``shape``)."""
    def one(axes, struct):
        if not isinstance(axes, tuple):
            raise TypeError(f"expected axis tuple, got {axes!r}")
        if len(axes) != len(struct.shape):
            raise ValueError(f"axes {axes} rank != shape "
                             f"{tuple(struct.shape)}")
        return NamedSharding(mesh, spec_for(axes, tuple(struct.shape),
                                            rules, mesh))
    return _map(one, axes_tree, struct_tree)


def batch_shardings(batch_specs: Dict[str, Any], rules: LogicalRules,
                    mesh) -> Dict[str, NamedSharding]:
    """Shard every input leaf along its leading (batch) dimension, or
    replicate it where that dimension does not divide."""
    sizes = axis_sizes(mesh)

    def one(struct):
        phys = _physical_axes(rules.get("batch"), sizes)
        size = math.prod(sizes[a] for a in phys) if phys else 1
        shape = tuple(struct.shape)
        if phys and shape and shape[0] % size == 0:
            return NamedSharding(mesh, (phys if len(phys) > 1 else phys[0],))
        return NamedSharding(mesh, (None,))

    return {k: one(v) for k, v in batch_specs.items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# DTensors by hand: the local part of a full tensor, and back
# ---------------------------------------------------------------------------
# Only ``DTensor.from_local`` / ``to_local`` are used: the gathers below are
# ``dist.all_gather`` over one mesh dimension's group at a time, which gloo
# runs for CPU and CUDA tensors alike, and the local part is a slice, so the
# same code runs on NCCL ranks, gloo ranks and one rank alone.

def local_part(full: torch.Tensor, mesh, placements,
               keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's part of ``full`` under ``placements`` on ``mesh``
    (sizes divide: :func:`spec_for` guarantees it).  ``full`` is already
    this rank's part along the mesh axes named in ``keep``."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names or ()
    part = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and not (keep and names[i] in keep):
            part = part.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    # a copy, not a view: a view would keep the whole tensor alive
    return part.clone() if part.numel() != full.numel() \
        else part.contiguous()


def place(full: torch.Tensor, mesh, placements) -> DTensor:
    """A ``DTensor`` holding this rank's part of ``full`` (which every
    rank of the mesh holds whole); no communication."""
    return DTensor.from_local(local_part(full, mesh, placements), mesh,
                              placements, run_check=False)


def distribute(full: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """:func:`place` by a :class:`NamedSharding`."""
    return place(full, sharding.mesh, sharding.placements)


def gather(t, keep: Tuple[str, ...] = ()):
    """The full tensor of a ``DTensor`` (collective over the mesh
    dimensions that shard it, innermost first), but for the mesh axes
    named in ``keep``, along which it stays this rank's part; any other
    value as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh, full = t.device_mesh, t.to_local()
    names = mesh.mesh_dim_names or ()
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if isinstance(pl, Shard) and mesh.size(i) > 1 \
                and not (keep and names[i] in keep):
            parts = [torch.empty_like(full) for _ in range(mesh.size(i))]
            dist.all_gather(parts, full.contiguous(),
                            group=mesh.get_group(i))
            full = torch.cat(parts, dim=pl.dim)
    return full


def mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` has arrived: a one-element
    all-reduce over each mesh dimension in turn (on the mesh's device,
    so NCCL and gloo alike)."""
    t = torch.zeros(1, device=mesh.device_type)
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
