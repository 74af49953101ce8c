"""Training loop with QAT of the agent partition, int8 error-feedback
gradient compression and checkpointing, on one device or over a mesh of
ranks (``repro/runtime/train_loop.py``).

Composition (bottom to top):

  model.loss                  — any family of ``models/`` (flash attention
                                on the card; per-layer recompute under
                                ``remat``)
  qat.fake_quantize_agent     — agent-partition fake quant with
                                straight-through gradients (optional)
  autograd + AdamW            — ``optim.AdamW``
  grad_compress (int8 + EF)   — ``optim.compress_tree``: on one device, or
                                over the mesh's ``pod`` axis
  DTensor state               — params, AdamW m/v and the residual placed
                                by ``parallel/sharding.py``'s rules
  CheckpointManager           — restore on start, async save (optional)

Over a mesh (a ``DeviceMesh`` with axes ``("data", "model")`` or ``("pod",
"data", "model")``) each rank holds its part of the state, steps on its
slice of the global batch (``data/loader.py``) and

* gathers the parameters and the residual whole, computes the loss and
  the gradients on full tensors (``model`` shards the state, not the
  compute: tensor-parallel products wait for a later slice), then
* without a ``pod`` axis or without int8 compression (the reference's
  ``_plain_step``, GSPMD over the global batch): sums each rank's
  gradients weighted by its share of the global batch's loss tokens over
  ``pod`` x ``data``, which gives the global batch's mean-loss gradient,
  then compresses on one device when asked;
* with a ``pod`` axis and int8 compression (``_podwise_step``): sums the
  weighted gradients over ``data`` inside each pod, exchanges them as
  int8 codes over ``pod`` (``g_hat = sum_p s_p q_p / P``), takes the
  mean of the pods' losses, and keeps each pod's residual on its own
  ranks: the residual is declared replicated over ``pod`` as the
  reference's ``out_specs=P()`` declares it, and a checkpoint holds the
  first pod's;
* updates its own part with AdamW (an elementwise update; the clipping
  norm is the full gradients'), so every replica of a part stays bitwise
  equal to the others.

A mesh of one rank runs the same code as one device and computes the same
bits.  MoE layers' load-balancing loss and expert capacity depend on every
token of the batch the loss sees: a trainer whose loss would be split over
several data-parallel ranks raises for an MoE config.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.quantization import QuantConfig
from ..device import resolve_device, set_float32_numerics
from ..launch.mesh import axis_sizes
from ..models.lm import tree_leaves, tree_map
from ..optim import AdamW, AdamWState, compress_tree, global_norm
from ..optim import init_error_state
from ..parallel.sharding import (default_rules, distribute, gather,
                                 local_part, tree_shardings)
from . import qat as qat_mod

MESH_AXES = (("data", "model"), ("pod", "data", "model"))


@dataclasses.dataclass
class TrainConfig:
    qat_bits: int = 0                 # 0 disables QAT
    qat_scheme: str = "uniform"
    grad_compression: str = "none"    # 'none' | 'int8_ef'
    log_every: int = 10
    remat: bool = True                # recompute each layer in backward


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _part(full, like):
    """This rank's part of ``full`` where ``like`` is a ``DTensor``."""
    if isinstance(like, DTensor):
        return local_part(full, like.device_mesh, like.placements)
    return full


def _wrap(local, like):
    """``local`` placed as ``like`` is (a ``DTensor`` or not)."""
    if isinstance(like, DTensor):
        return DTensor.from_local(local, like.device_mesh, like.placements,
                                  run_check=False)
    return local


class Trainer:
    """Owns the step function and the step count; one per (model, device)
    or (model, mesh)."""

    def __init__(self, model, optimizer: AdamW, device=None,
                 train_cfg: Optional[TrainConfig] = None, *, ckpt=None,
                 mesh=None):
        self.model = model
        self.cfg = model.cfg
        self.opt = optimizer
        self.ckpt = ckpt
        self.mesh = mesh
        self.tc = train_cfg or TrainConfig()
        if self.tc.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression must be 'none' or "
                             f"'int8_ef', got {self.tc.grad_compression!r}")
        self.rules = default_rules(self.cfg)
        self.podwise = False
        self._dp_groups = []
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if names not in MESH_AXES:
                raise ValueError(f"a training mesh has axes {MESH_AXES[0]} "
                                 f"or {MESH_AXES[1]}, got {names}")
            if mesh.get_coordinate() is None:
                raise ValueError("this rank is not in the mesh")
            if device is None:
                device = ("cpu" if mesh.device_type == "cpu" else
                          torch.device("cuda", torch.cuda.current_device()))
            sizes = axis_sizes(mesh)
            self.podwise = ("pod" in sizes
                            and self.tc.grad_compression == "int8_ef")
            # the ranks whose batch slices make up one loss: a pod's data
            # ranks in the pod-wise step, every pod x data rank otherwise
            dp_axes = ("data",) if self.podwise else tuple(
                a for a in ("pod", "data") if a in sizes)
            dp = math.prod(sizes[a] for a in dp_axes)
            if self.cfg.n_experts and dp > 1:
                raise NotImplementedError(
                    f"MoE training over {dp} data-parallel ranks: the "
                    "router's load-balancing loss and expert capacity "
                    "depend on the whole batch (ROADMAP A.7)")
            self._dp_groups = [mesh.get_group(a) for a in dp_axes
                               if sizes[a] > 1]
        self.device = resolve_device(device)
        set_float32_numerics()
        self._axes = model.logical_axes()
        self._step_fn = None
        self.step = 0
        self.qcfg = None
        if self.tc.qat_bits > 0:
            self.qcfg = QuantConfig(bits=self.tc.qat_bits,
                                    scheme=self.tc.qat_scheme,
                                    granularity="per-channel")

    # ------------------------------------------------------------------
    # shardings (None without a mesh)
    # ------------------------------------------------------------------
    def param_shardings(self):
        if self.mesh is None:
            return None
        return tree_shardings(self._axes, self.model.param_structs(),
                              self.rules, self.mesh)

    def opt_shardings(self, param_sh):
        # m/v mirror params; step is replicated (a plain tensor)
        return AdamWState(step=None, m=param_sh, v=param_sh)

    # ------------------------------------------------------------------
    # step construction
    # ------------------------------------------------------------------
    def _loss_fn(self, params, batch):
        if self.qcfg is not None:
            params = qat_mod.fake_quantize_agent(
                params, self._axes, self.cfg, self.qcfg, ste=True)
        return self.model.loss(params, batch, remat=self.tc.remat)

    def _mean_over_ranks(self, grads, loss, batch):
        """The gradients and loss of the mean loss over the batch slices
        of the data-parallel ranks: each rank's weighted by its share of
        the loss tokens (``loss_mask`` when the batch has one), summed."""
        n = (batch["loss_mask"].sum(dtype=torch.float32)
             if "loss_mask" in batch else
             torch.tensor(float(batch["labels"].numel()),
                          device=loss.device))
        total = n.clone()
        for g in self._dp_groups:
            dist.all_reduce(total, group=g)
        w = n / torch.clamp(total, min=1.0)
        grads = tree_map(lambda t: t * w, grads)
        loss = loss * w
        for t in [loss, *tree_leaves(grads)]:
            for g in self._dp_groups:
                dist.all_reduce(t, group=g)
        return grads, loss

    def _step(self, params, opt_state, err, batch):
        """(params, opt_state, err, batch) -> the same, updated, and the
        metrics ``{"loss", "grad_norm", "lr"}`` as device scalars."""
        leaves = tree_map(lambda p: gather(p).detach().requires_grad_(True),
                          params)
        loss = self._loss_fn(leaves, batch)
        loss.backward()
        return self._apply(tree_map(lambda p: p.grad, leaves),
                           loss.detach(), batch, params, opt_state, err)

    def _apply(self, grads, loss, batch, params, opt_state, err):
        """The step after this rank's full gradients and loss: their mean
        over the data-parallel ranks, compression, AdamW on this rank's
        part of the state."""
        if self._dp_groups:
            grads, loss = self._mean_over_ranks(grads, loss, batch)
        if self.tc.grad_compression == "int8_ef":
            axis = "pod" if self.podwise else None
            grads, new_err = compress_tree(grads, tree_map(gather, err),
                                           axis, self.mesh)
            err = _zip_map(lambda e, like: _wrap(_part(e, like), like),
                           new_err, err)
            if self.podwise:
                group = self.mesh.get_group("pod")
                dist.all_reduce(loss, group=group)
                loss = loss * float(np.float32(1.0) / np.float32(
                    dist.get_world_size(group)))
        new_p, new_state, metrics = self.opt.update(
            _zip_map(_part, grads, params),
            AdamWState(step=opt_state.step, m=tree_map(_local, opt_state.m),
                       v=tree_map(_local, opt_state.v)),
            tree_map(_local, params),
            grad_norm=global_norm(grads))
        params = _zip_map(_wrap, new_p, params)
        opt_state = AdamWState(step=new_state.step,
                               m=_zip_map(_wrap, new_state.m, opt_state.m),
                               v=_zip_map(_wrap, new_state.v, opt_state.v))
        metrics["loss"] = loss
        return params, opt_state, err, metrics

    def build_step(self, batch_struct=None) -> Callable:
        """The step function (eager: nothing is traced or compiled)."""
        self._step_fn = self._step
        return self._step_fn

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(params, opt_state, err) from a seeded generator on the
        trainer's device; over a mesh every rank draws the same full
        parameters and keeps its part of them."""
        params = self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        err = (init_error_state(params)
               if self.tc.grad_compression == "int8_ef"
               else torch.zeros((), dtype=torch.float32, device=self.device))
        return self.place_state(params, self.opt.init(params), err)

    def place_state(self, params, opt_state, err):
        """A state of full tensors (every rank holds the same) as this
        rank's parts on the mesh, placed by the rules; unchanged without
        a mesh."""
        sh = self.param_shardings()
        if sh is None:
            return params, opt_state, err
        return (_zip_map(distribute, params, sh),
                AdamWState(step=opt_state.step,
                           m=_zip_map(distribute, opt_state.m, sh),
                           v=_zip_map(distribute, opt_state.v, sh)),
                _zip_map(distribute, err, sh) if isinstance(err, dict)
                else err)

    def maybe_restore(self, params, opt_state, err):
        """Resume from the newest intact checkpoint if there is one:
        (params, opt_state, err, start step), each tensor placed as the
        one it replaces (its part of it over a mesh, which may be another
        mesh than the one that saved it)."""
        if self.ckpt is None:
            return params, opt_state, err, 0
        psh = self.param_shardings()
        sh = None if psh is None else {
            "params": psh, "opt": self.opt_shardings(psh),
            "err": psh if isinstance(err, dict) else None}
        out = self.ckpt.restore_latest(
            {"params": params, "opt": opt_state, "err": err}, sh)
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
