"""Fake quantization of the agent partition (``repro/runtime/qat.py``).

Training sees the quantized forward of the agent layers at the b̂ they
will be served at, with straight-through gradients
(``core.quantization.qat_quantize``).  Serving uses the same masking for
the operating points no kernel container covers: a uniform b̂ outside
{4, 8} and the > 8-bit layers of a plan.  Stacked weight leaves (leading
'layers'/'blocks' axis, >= 3 dims, floating) are quantized per layer and
only for the agent-owned layers ``[0, split)``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.quantization import (QuantPlan, qat_quantize,
                                 quantize_dequantize)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def agent_mask_fn(cfg):
    """(stacked_axis_name, length) -> boolean mask of agent-owned entries.

    The returned function also exposes ``n_agent(name, length)``, the
    count of agent-owned leading entries (the mask is
    ``arange(length) < n_agent``).
    """
    per = getattr(cfg, "attn_period", 0) or getattr(cfg, "slstm_period", 0) \
        or 0

    def n_agent(name: str, length: int) -> int:
        if name == "layers":
            return min(int(cfg.split_layer), length)
        # 'blocks': super-block granularity (split rounded down to blocks)
        blocks = max(cfg.split_layer // max(per, 1), 0) if per else 0
        return min(int(blocks), length)

    def mask(name: str, length: int) -> torch.Tensor:
        return torch.arange(length) < n_agent(name, length)
    mask.n_agent = n_agent
    return mask


def fake_quantize_agent(params: Any, axes: Any, cfg, qcfg,
                        *, ste: bool = True) -> Any:
    """Return params with the agent partition fake-quantized.

    ``qcfg`` is a single :class:`QuantConfig` (uniform b̂) or a
    :class:`QuantPlan` whose ``layers/<i>`` entries give layer i its own
    bit-width.  Server layers and non-stacked leaves pass through.
    ``ste`` (training) quantizes through :func:`qat_quantize`, whose
    gradient is the identity; serving passes ``ste=False``.
    """
    q1 = qat_quantize if ste else quantize_dequantize
    n_agent = agent_mask_fn(cfg).n_agent

    def one(ax, leaf):
        if isinstance(ax, dict):
            return {k: one(ax[k], leaf[k]) for k in leaf}
        if not _is_axes(ax) or leaf.ndim < 3 \
                or ax[0] not in ("layers", "blocks") \
                or not torch.is_floating_point(leaf):
            return leaf
        n = leaf.shape[0]
        na = n_agent(ax[0], n)
        # [L, in*, out], unbound: one stack op in the backward, where
        # indexing would add a zero-filled copy of the stack per layer
        flat = leaf.reshape(n, -1, leaf.shape[-1]).unbind(0)
        per_layer = [
            q1(flat[i], qcfg.config_for_layer(i)
                                if isinstance(qcfg, QuantPlan) else qcfg)
            if i < na else flat[i] for i in range(n)]
        return torch.stack(per_layer).reshape(leaf.shape)

    return one(axes, params)
