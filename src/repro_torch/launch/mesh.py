"""Meshes of ranks (``repro/launch/mesh.py``).

A mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group, one rank per process: on the card one
process per GPU under NCCL, on the CPU processes under gloo.  Its axes are
the reference's: ``("data", "model")`` on one pod, ``("pod", "data",
"model")`` across pods, where ``pod`` carries pure data parallelism (the
int8-compressed gradient exchange of ``optim/grad_compress.py``).

:func:`make_production_mesh` and :func:`make_abstract_mesh` give the
reference's 256- and 512-chip shapes as :class:`AbstractMesh` (names and
sizes only, as ``jax.sharding.AbstractMesh``): no process group of 512
ranks can be built in one process, and the sharding rules need only the
shape.  :func:`init_ranks` joins the process group or creates it: under
``torchrun`` from its environment, for ranks that a program starts itself
through a ``FileStore`` (a file every rank can open, so concurrent jobs on
one machine never contend for a TCP port), and for one process alone
in memory.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind it
    (``jax.sharding.AbstractMesh``): ``shape`` maps each axis name to
    its size, in order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_abstract_mesh(shape: Sequence[int],
                       axes: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production shapes: (data 16, model 16) on one pod,
    (pod 2, data 16, model 16) across two."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def init_ranks(device=None, *, backend: Optional[str] = None,
               store_file: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Join the default process group, creating it if this process has
    none yet; returns this rank's device.

    ``device`` as :func:`repro_torch.device.resolve_device` (the card
    unless ``"cpu"``); a bare ``"cuda"`` becomes the card of the rank's
    ``LOCAL_RANK``.  ``backend`` defaults to NCCL on the card and gloo on
    the CPU.  The rendezvous is ``store_file`` (a ``FileStore``, with
    ``rank`` and ``world_size``) when given, else ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else one rank alone.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if store_file is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore rendezvous needs rank and "
                             "world_size")
        dist.init_process_group(
            backend, store=dist.FileStore(store_file, world_size),
            rank=rank, world_size=world_size)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              ranks: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (default: every rank
    of the group, in order), row-major as ``jax.make_mesh``.  Every rank
    of the group calls it, also one outside ``ranks`` (its
    ``get_coordinate()`` is then None): a mesh over fewer ranks is how a
    session continues on the survivors of a failure.  ``device`` as
    :func:`init_ranks`: the card unless ``"cpu"``."""
    dev = init_ranks(device)
    n = dist.get_world_size()
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != math.prod(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks, got {len(ranks)}")
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(data: int = 1, model: int = 1,
                   device=None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the group (joining it
    first), clamped as the reference's: ``data`` to the ranks there are,
    ``model`` to what is left.  Raises when the clamped mesh leaves ranks
    out."""
    dev = init_ranks(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh leaves {n - data * model}"
                         f" of {n} ranks out")
    return make_mesh((data, model), ("data", "model"), device=dev)


# H100 SXM (NVIDIA data sheet, dense, at the 700 W power limit): the card
# the port's numbers are measured on (PERF.md, "NVIDIA H100 80GB HBM3,
# 700.00 W"); chip_smoke.py's bounds read them
PEAK_FLOPS_BF16 = 989e12      # per card, bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12      # tf32 tensor cores
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card, one direction (NVLink 4)
HBM_BYTES = 80 * 10 ** 9      # 80 GB of HBM3
