"""AdamW, schedules and global-norm clipping (``repro/optim/adamw.py``).

The state mirrors the parameter dict (m, v in float32) plus a scalar int32
step count.  Everything stays on the parameters' device: no value is read
back to the host during an update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from ..models.lm import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Adam with decoupled weight decay on leaves of ``ndim >= 2`` only,
    global-norm gradient clipping and bias correction."""

    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor],
                         float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = next(tree_leaves(params)).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (new_params, new_state, metrics) with metrics
        ``{"grad_norm", "lr"}`` as device scalars."""
        step = state.step + 1
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr = self._lr(step)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if self.weight_decay > 0 and p.ndim >= 2:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
            return p_new, m_new, v_new

        new_p, new_m, new_v = _map3(upd, params, grads, state.m, state.v)
        return new_p, AdamWState(step=step, m=new_m, v=new_v), \
            {"grad_norm": gnorm, "lr": lr}


def _map3(fn, params, *others):
    """``fn(p, *o) -> (a, b, c)`` over parallel nested dicts; returns the
    three result dicts."""
    if isinstance(params, dict):
        outs = {k: _map3(fn, params[k], *(o[k] for o in others))
                for k in params}
        return tuple({k: outs[k][i] for k in outs} for i in range(3))
    return fn(params, *others)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in the
    reference's (sorted-key) order."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Schedules: step (an int tensor) -> learning rate (a float32 tensor).
# The reference evaluates them inside its jitted train step, where XLA
# turns each division by a constant into a product with its float32
# reciprocal and folds ``peak_lr * step / w`` into ``step * fl(peak_lr *
# fl(1/w))``; they are written so here.  The linear schedule then equals
# the jitted reference bitwise; the cosine one too except where XLA's and
# torch's float32 cosines differ in the last bit.
# ---------------------------------------------------------------------------

def _inv(c: int) -> float:
    """fl32(1 / c) as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def _warmup_and_progress(peak_lr, warmup_steps, total_steps, step):
    step = step.to(torch.float32)
    warm = step * float(np.float32(peak_lr)
                        * np.float32(_inv(max(warmup_steps, 1))))
    prog = torch.clamp((step - warmup_steps)
                       * _inv(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    return step, warm, prog


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        step, warm, prog = _warmup_and_progress(peak_lr, warmup_steps,
                                                total_steps, step)
        cos = final_frac + (1 - final_frac) * 0.5 \
            * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn


def linear_schedule(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step, warm, prog = _warmup_and_progress(peak_lr, warmup_steps,
                                                total_steps, step)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))
    return fn
