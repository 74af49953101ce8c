"""Host loader: a ``batch_at(step)`` dataset -> batches on one device
(``repro/data/loader.py``).

The reference places each batch across a mesh of hosts; the port trains on
one device, so the loader moves each numpy batch to its device.  Step
indexing and ``seek`` (resume) are the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device


class ShardedLoader:
    """Wraps a ``batch_at(step)`` dataset with device placement; the
    device is the CUDA card unless ``device="cpu"`` is asked for."""

    def __init__(self, dataset, device=None, start_step: int = 0):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.step = start_step

    def peek_structure(self) -> Dict[str, torch.Tensor]:
        """{name: a tensor on the ``meta`` device with the batch's shape
        and dtype} (the reference's ``ShapeDtypeStruct``s)."""
        b = self.dataset.batch_at(0)
        return {k: torch.empty(v.shape, dtype=torch.from_numpy(
                    np.empty((), v.dtype)).dtype, device="meta")
                for k, v in b.items()}

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self.dataset.batch_at(self.step)
        self.step += 1
        return self._place(batch)

    def seek(self, step: int) -> None:
        """Resume point."""
        self.step = step
