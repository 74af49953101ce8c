"""Carry the reference's parameters across to the port.

The reference's parameter pytree is nested dicts of arrays with the same
structure and layouts as the port's (``[in, out]`` matrices,
layer-stacked ``[L, ...]`` leaves).  The caller turns every leaf into a
numpy array (``np.asarray`` on each leaf); :func:`params_from_jax` turns
those into tensors on a chosen device.  Both sides then compute the same
function of the same numbers; no JAX random stream is reproduced.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device`` (the CUDA card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)
