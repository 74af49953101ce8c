"""Carry the reference's parameters and training state across to the port.

The reference's parameter pytree is nested dicts of arrays with the same
structure and layouts as the port's (``[in, out]`` matrices,
layer-stacked ``[L, ...]`` leaves), or, for the FC-DNN, a list of
``[out, in]`` matrices.  The caller turns every leaf into a
numpy array (``np.asarray`` on each leaf); :func:`params_from_jax` turns
those into tensors on a chosen device, and :func:`train_state_from_jax`
does the same for a trainer's whole state (parameters, the AdamW state
and the error-feedback residuals).  Both sides then compute the same
function of the same numbers; no JAX random stream is reproduced.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .optim import AdamWState


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts and lists of numpy arrays (a DecoderLM's tree, or the
    FC-DNN's list of matrices) -> the same structure of torch tensors on
    ``device`` (the CUDA card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)


def train_state_from_jax(params: Any, opt_state: Any, err: Any,
                         device=None):
    """The reference's ``(params, AdamWState(step, m, v), err)`` with numpy
    leaves -> the port's, on ``device``: a trainer started from it takes
    the reference's next step.  ``err`` is the residual tree under int8
    error feedback, else a scalar."""
    step, m, v = opt_state
    dev = resolve_device(device)
    return (params_from_jax(params, dev),
            AdamWState(step=torch.tensor(int(np.asarray(step)),
                                         dtype=torch.int32, device=dev),
                       m=params_from_jax(m, dev), v=params_from_jax(v, dev)),
            params_from_jax(err, dev))
