"""Host loader: a ``batch_at(step)`` dataset -> batches on a device
(``repro/data/loader.py``).

Batches keep the reference's global-batch semantics: step ``s`` is the
dataset's ``batch_at(s)`` whatever the mesh, ``peek_structure`` gives the
global shapes, and ``seek`` resumes.  Over a mesh each rank places only
its contiguous slice of every leaf's leading (batch) dimension, by its
``(pod, data)`` coordinate, pod-major: the reference's ``batch ->
('pod', 'data')`` rule, with its fallback (a batch that does not divide
is placed whole on every rank).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import batch_shardings, local_part

BATCH_RULES = {"batch": ("pod", "data")}


class ShardedLoader:
    """Wraps a ``batch_at(step)`` dataset with device placement; the
    device is the CUDA card unless ``device="cpu"`` is asked for, and
    with ``mesh`` each rank gets its slice of the batch."""

    def __init__(self, dataset, device=None, start_step: int = 0,
                 mesh=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.step = start_step
        self.mesh = mesh

    def peek_structure(self) -> Dict[str, torch.Tensor]:
        """{name: a tensor on the ``meta`` device with the global batch's
        shape and dtype} (the reference's ``ShapeDtypeStruct``s)."""
        b = self.dataset.batch_at(0)
        return {k: torch.empty(v.shape, dtype=torch.from_numpy(
                    np.empty((), v.dtype)).dtype, device="meta")
                for k, v in b.items()}

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self.mesh is not None:
            sh = batch_shardings(out, BATCH_RULES, self.mesh)
            out = {k: local_part(v, self.mesh, sh[k].placements)
                   for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self.dataset.batch_at(self.step)
        self.step += 1
        return self._place(batch)

    def seek(self, step: int) -> None:
        """Resume point."""
        self.step = step
