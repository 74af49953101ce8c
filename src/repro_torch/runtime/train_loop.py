"""Training loop with QAT of the agent partition and int8 error-feedback
gradient compression (``repro/runtime/train_loop.py``).

Composition (bottom to top), one device:

  model.loss                  — ``DecoderLM.loss`` (flash attention on the
                                card; per-layer recompute under ``remat``)
  qat.fake_quantize_agent     — agent-partition fake quant with
                                straight-through gradients (optional)
  autograd + AdamW            — ``optim.AdamW``
  grad_compress (int8 + EF)   — ``optim.compress_tree`` (optional)
  CheckpointManager           — restore on start, async save (optional)

This is the reference's ``_plain_step``.  With ``ckpt`` the trainer
restores the newest intact checkpoint on start (params, AdamW state, the
int8-EF residual, the step, and the loader's position), saves the same
tree asynchronously at every ``ckpt.should_save(step)``, and waits for the
last write at the end, as the reference does.  Its pod-wise step (an
explicit int8 all-gather over a mesh of several chips) is not ported yet:
a ``mesh`` of several devices raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..core.quantization import QuantConfig
from ..device import resolve_device, set_float32_numerics
from ..models.lm import tree_map
from ..optim import AdamW, compress_tree, init_error_state
from . import qat as qat_mod


@dataclasses.dataclass
class TrainConfig:
    qat_bits: int = 0                 # 0 disables QAT
    qat_scheme: str = "uniform"
    grad_compression: str = "none"    # 'none' | 'int8_ef'
    log_every: int = 10
    remat: bool = True                # recompute each layer in backward


class Trainer:
    """Owns the step function and the step count; one per (model,
    device)."""

    def __init__(self, model, optimizer: AdamW, device=None,
                 train_cfg: Optional[TrainConfig] = None, *, ckpt=None,
                 mesh=None):
        if mesh is not None:
            devices = list(mesh)
            if len(devices) != 1:
                raise NotImplementedError(
                    f"not yet ported (training over a mesh of "
                    f"{len(devices)} devices: the pod-wise step, ROADMAP "
                    f"A.9)")
            device = devices[0] if device is None else device
        self.model = model
        self.cfg = model.cfg
        self.opt = optimizer
        self.ckpt = ckpt
        self.device = resolve_device(device)
        set_float32_numerics()
        self.tc = train_cfg or TrainConfig()
        if self.tc.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression must be 'none' or "
                             f"'int8_ef', got {self.tc.grad_compression!r}")
        self._axes = model.logical_axes()
        self._step_fn = None
        self.step = 0
        self.qcfg = None
        if self.tc.qat_bits > 0:
            self.qcfg = QuantConfig(bits=self.tc.qat_bits,
                                    scheme=self.tc.qat_scheme,
                                    granularity="per-channel")

    # ------------------------------------------------------------------
    # step construction
    # ------------------------------------------------------------------
    def _loss_fn(self, params, batch):
        if self.qcfg is not None:
            params = qat_mod.fake_quantize_agent(
                params, self._axes, self.cfg, self.qcfg, ste=True)
        return self.model.loss(params, batch, remat=self.tc.remat)

    def _plain_step(self, params, opt_state, err, batch):
        """(params, opt_state, err, batch) -> the same, updated, and the
        metrics ``{"loss", "grad_norm", "lr"}`` as device scalars."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = self._loss_fn(leaves, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        if self.tc.grad_compression == "int8_ef":
            grads, err = compress_tree(grads, err)
        params, opt_state, metrics = self.opt.update(
            grads, opt_state, tree_map(lambda p: p.detach(), leaves))
        metrics["loss"] = loss.detach()
        return params, opt_state, err, metrics

    def build_step(self, batch_struct=None) -> Callable:
        """The step function (eager: nothing is traced or compiled)."""
        self._step_fn = self._plain_step
        return self._step_fn

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(params, opt_state, err) from a seeded generator on the
        trainer's device."""
        params = self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        opt_state = self.opt.init(params)
        err = (init_error_state(params)
               if self.tc.grad_compression == "int8_ef"
               else torch.zeros((), dtype=torch.float32, device=self.device))
        return params, opt_state, err

    def maybe_restore(self, params, opt_state, err):
        """Resume from the newest intact checkpoint if there is one:
        (params, opt_state, err, start step), each tensor on the device of
        the one it replaces."""
        if self.ckpt is None:
            return params, opt_state, err, 0
        out = self.ckpt.restore_latest(
            {"params": params, "opt": opt_state, "err": err})
        if out is None:
            return params, opt_state, err, 0
        tree, manifest = out
        self.step = int(manifest["metadata"].get("data_step",
                                                 manifest["step"]))
        return tree["params"], tree["opt"], tree["err"], self.step

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def fit(self, loader, num_steps: int, seed: int = 0, state=None,
            on_metrics: Optional[Callable] = None):
        """Run ``num_steps`` steps; returns (state, history).

        ``history`` holds a metrics dict (``loss``, ``grad_norm``, ``lr``,
        ``step``, ``steps_per_s``) for the first step and every
        ``log_every``-th; reading it waits for the device, nothing else
        in the loop does.
        """
        if state is None:
            params, opt_state, err = self.init_state(seed)
            params, opt_state, err, start = self.maybe_restore(
                params, opt_state, err)
            loader.seek(start)
        else:
            params, opt_state, err = state
            start = self.step
        if self._step_fn is None:
            self.build_step(loader.peek_structure())

        history = []
        t_last = time.monotonic()
        for step in range(start, start + num_steps):
            batch = next(loader)
            params, opt_state, err, metrics = self._step_fn(
                params, opt_state, err, batch)
            self.step = step + 1
            if (step + 1) % self.tc.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["steps_per_s"] = self.tc.log_every / max(
                    time.monotonic() - t_last, 1e-9)
                t_last = time.monotonic()
                history.append(m)
                if on_metrics:
                    on_metrics(m)
            if self.ckpt is not None and self.ckpt.should_save(step + 1):
                self.ckpt.save_async(
                    step + 1,
                    {"params": params, "opt": opt_state, "err": err},
                    metadata={"data_step": step + 1})
        if self.ckpt is not None:
            self.ckpt.wait()
        return (params, opt_state, err), history
