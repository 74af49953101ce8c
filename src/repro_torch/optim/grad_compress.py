"""Error-feedback int8 gradient compression (``repro/optim/grad_compress.py``).

Each gradient leaf is quantized to int8 codes with one absmax scale, the
quantization residual is kept locally and added to the next step's
gradient (error feedback), and the dequantized gradient goes to the
optimizer.  Across pods (``axis_name="pod"`` with the trainer's mesh) the
codes and the scales are all-gathered over the mesh's ``pod`` group, 1
wire byte an element and 4 bytes a pod, and each pod's codes are weighted
by its own scale: ``g_hat = sum_p s_p * q_p * fl(1/P)``, the reference's
``tensordot`` over the pod index followed by its division by P in the form
XLA compiles it to.  The residual stays with its pod.  Without an axis it
is quantize and dequantize with error feedback on one device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.lm import tree_map

# fl32(1/127): the reference runs this inside its jitted train step, where
# XLA compiles ``amax / 127.0`` into ``amax * fl(1/127)``
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_leaf(g: torch.Tensor,
                   tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, the absmax scale) of ``g``; under ``tp`` ``g`` is this
    rank's shard of a leaf split over ``model`` and the absmax is the
    whole leaf's (a max over the ranks: exact)."""
    amax = torch.amax(torch.abs(g))
    if tp is not None:
        amax = tp.all_max(amax)
    scale = torch.where(amax > 0, amax * _INV_127, 1.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _group(axis_name: Optional[str], mesh):
    """The process group of ``axis_name`` on ``mesh``, or None."""
    if axis_name is None:
        return None
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"compression over the {axis_name!r} axis needs "
                         f"a mesh with that axis, got {mesh}")
    return mesh.get_group(axis_name)


def pod_mean(qs: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """The mean of the pods' dequantized gradients from their stacked
    codes ``qs`` [P, ...] and scales ``ss`` [P]: the reference's
    ``tensordot(ss, qs, axes=(0, 0)) / P``, whose division XLA compiles
    into a product with fl(1/P) (they differ where P is not a power of
    two)."""
    n = qs.shape[0]
    inv_n = float(np.float32(1.0) / np.float32(n))
    return torch.tensordot(ss, qs.to(torch.float32), dims=([0], [0])) \
        * inv_n


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def quantize_with_feedback(g: torch.Tensor, err: torch.Tensor, tp=None):
    """(codes, scale, new residual) of ``g + err``: this pod's part of
    the exchange, bitwise the jitted reference's (``tp``: as in
    :func:`_quantize_leaf`, elementwise on the shard)."""
    gf = g.to(torch.float32) + err
    q, scale = _quantize_leaf(gf, tp)
    # XLA contracts the reference's ``gf - q * scale`` into one fused
    # multiply-subtract (a single rounding).  In float64 the product of an
    # int8 code and an f32 scale is exact, and so is the difference (a
    # nonzero code means |gf| and |q * scale| lie within 2^8 of each
    # other), so rounding it once to f32 gives the fused result.
    new_err = (gf.to(torch.float64) - q.to(torch.float64)
               * scale.to(torch.float64)).to(torch.float32)
    return q, scale, new_err


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        axis_name: Optional[str] = None, mesh=None,
                        tp=None):
    """Quantize (g + err) to int8, exchange the codes over ``axis_name``
    of ``mesh`` when given, dequantize; returns (g_hat, new_err) with the
    codes and residual bitwise the jitted reference's.  ``tp``: ``g`` is
    this rank's shard over ``model`` (:func:`_quantize_leaf`)."""
    group = _group(axis_name, mesh)
    q, scale, new_err = quantize_with_feedback(g, err, tp)
    if group is not None:
        g_hat = pod_mean(_all_gather(q, group),
                         _all_gather(scale.reshape(1), group).reshape(-1))
    else:
        g_hat = q.to(torch.float32) * scale
    return g_hat.to(g.dtype), new_err


def compress_tree(grads, err_state, axis_name: Optional[str] = None,
                  mesh=None, tp=None, local=None):
    """Error-feedback compression of every leaf (sorted-key order, the
    same on every rank); returns (compressed_grads, new_err_state).
    ``local`` mirrors ``grads`` with the dimension a leaf is split on over
    ``tp``'s ``model`` group, None where it is whole."""
    if isinstance(grads, dict):
        outs = {k: compress_tree(grads[k], err_state[k], axis_name, mesh,
                                 tp, None if local is None else local[k])
                for k in sorted(grads)}
        return ({k: outs[k][0] for k in grads},
                {k: outs[k][1] for k in grads})
    return compress_decompress(grads, err_state, axis_name, mesh,
                               None if local is None else tp)


def compression_ratio(dtype=torch.float32) -> float:
    """Wire-byte reduction against an uncompressed all-reduce."""
    return torch.empty((), dtype=dtype).element_size() / 1.0
