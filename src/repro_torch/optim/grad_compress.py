"""Error-feedback int8 gradient compression (``repro/optim/grad_compress.py``).

Each gradient leaf is quantized to int8 codes with one absmax scale, the
quantization residual is kept locally and added to the next step's
gradient (error feedback), and the dequantized gradient goes to the
optimizer.  Across pods the reference all-gathers the codes and scales;
that collective waits for the parallel slice, so only the single-device
form (``axis_name=None``) is ported.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.lm import tree_map

# fl32(1/127): the reference runs this inside its jitted train step, where
# XLA compiles ``amax / 127.0`` into ``amax * fl(1/127)``
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(g))
    scale = torch.where(amax > 0, amax * _INV_127, 1.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _no_pod_axis(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"compression over the {axis_name!r} axis (int8 all-gather "
            "across pods) is not yet ported: it waits for the parallel "
            "slice")


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        axis_name: Optional[str] = None):
    """Quantize (g + err) to int8 and dequantize; returns (g_hat, new_err)
    with the codes and residual bitwise the jitted reference's."""
    _no_pod_axis(axis_name)
    gf = g.to(torch.float32) + err
    q, scale = _quantize_leaf(gf)
    g_hat = q.to(torch.float32) * scale
    # XLA contracts the reference's ``gf - q * scale`` into one fused
    # multiply-subtract (a single rounding).  In float64 the product of an
    # int8 code and an f32 scale is exact, and so is the difference (a
    # nonzero code means |gf| and |q * scale| lie within 2^8 of each
    # other), so rounding it once to f32 gives the fused result.
    new_err = (gf.to(torch.float64) - q.to(torch.float64)
               * scale.to(torch.float64)).to(torch.float32)
    return g_hat.to(g.dtype), new_err


def compress_tree(grads, err_state, axis_name: Optional[str] = None):
    """Error-feedback compression of every leaf; returns
    (compressed_grads, new_err_state)."""
    _no_pod_axis(axis_name)
    if isinstance(grads, dict):
        outs = {k: compress_tree(grads[k], err_state[k]) for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    return compress_decompress(grads, err_state)


def compression_ratio(dtype=torch.float32) -> float:
    """Wire-byte reduction against an uncompressed all-reduce."""
    return torch.empty((), dtype=dtype).element_size() / 1.0
