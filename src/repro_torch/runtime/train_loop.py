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

* gathers the parameters and the residual over every mesh axis but
  ``model``.  Over ``model`` > 1 every family computes on its ``model``
  shards (``parallel/tensor_parallel.py``: ``model_plan``): the attention
  leaves (``wq``/``wk``/``wv``, their biases, ``wo``; the
  encoder-decoder's three attentions) where the KV heads divide, the
  MLP's where ``d_ff`` does, the expert stacks where the experts do, the
  Mamba layers' and the mLSTM layers' where their heads do, the sLSTM's
  input projection where its gates are stored split, the embedding and
  head where the vocabulary does; those leaves stay this rank's shard and
  the collectives run inside the forward and backward.  Every other leaf
  (norms, the router, Mamba's ``in_B``/``in_C``, the sLSTM's recurrent
  weights, and the parts whose sizes do not divide) is gathered whole and
  computes replicated.  Then
* without a ``pod`` axis or without int8 compression (the reference's
  ``_plain_step``, GSPMD over the global batch): sums each rank's
  gradients weighted by its share of the global batch's loss tokens over
  ``pod`` x ``data``, which gives the global batch's mean-loss gradient,
  then compresses on one device when asked (the int8 scale of a leaf
  split over ``model`` is its whole absmax, a max over the ranks);
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
token of the batch the loss sees.  When the loader splits the batch over
several data-parallel ranks (``build_step`` asks its rule), the MoE
layers of a decoder LM or a hybrid sum the router's per-expert statistics
over them and count each expert's capacity queue across them
(``parallel/tensor_parallel.py``: ``DataParallel``); each rank
backpropagates its part of the global batch's loss (``DecoderLM.loss``
or ``HybridLM.loss`` with ``dp``), and the ranks' losses and gradients
are summed (the dense path weights the gradients after the backward
instead).
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
from ..data.loader import BATCH_RULES
from ..device import resolve_device, set_float32_numerics
from ..launch.mesh import axis_sizes
from ..models.lm import tree_leaves, tree_map
from ..optim import AdamW, AdamWState, compress_tree, global_norm
from ..optim import init_error_state
from ..parallel.sharding import (batch_shardings, default_rules,
                                 distribute, gather, local_part,
                                 tree_shardings)
from ..parallel.tensor_parallel import DataParallel, model_plan
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


def _part(full, like, dim=None):
    """This rank's part of ``full`` where ``like`` is a ``DTensor``;
    ``dim`` not None: ``full`` is already this rank's ``model`` shard."""
    if isinstance(like, DTensor):
        return local_part(full, like.device_mesh, like.placements,
                          () if dim is None else ("model",))
    return full


def _gather(t, dim=None):
    """``t`` whole, or (``dim`` not None) whole but for its ``model``
    shard."""
    return gather(t, () if dim is None else ("model",))


def _map3(fn, a, b, c):
    """``fn`` over the leaves of three nested dicts of one structure;
    ``c`` may be None (None at every leaf)."""
    if isinstance(a, dict):
        return {k: _map3(fn, a[k], b[k], None if c is None else c[k])
                for k in a}
    return fn(a, b, c)


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
                 mesh=None, rules=None):
        self.model = model
        self.cfg = model.cfg
        self.opt = optimizer
        self.ckpt = ckpt
        self.mesh = mesh
        self.tc = train_cfg or TrainConfig()
        if self.tc.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression must be 'none' or "
                             f"'int8_ef', got {self.tc.grad_compression!r}")
        # the sharding rules (default: ``default_rules``; the dry-run
        # passes its variants')
        self.rules = default_rules(self.cfg) if rules is None else rules
        self._axes = model.logical_axes()
        self.podwise = False
        self._dp_groups = []
        # tensor-parallel compute over ``model``: the plan and the model
        # dimension each leaf keeps local (None: gathered whole)
        self.tp, self._local = None, None
        # an MoE step's data-parallel ranks, whether the loader splits the
        # batch over them (``build_step``), and the rows each rank's slice
        # then has
        self.dp, self._split, self._rows = None, False, None
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
                self.dp = DataParallel.of(mesh, dp_axes)
            self._dp_groups = [mesh.get_group(a) for a in dp_axes
                               if sizes[a] > 1]
            if sizes["model"] > 1:
                specs = _zip_map(lambda s, _: s.spec,
                                 self.param_shardings(), self._axes)
                self.tp, self._local = model_plan(self.cfg, specs, mesh)
        self.device = resolve_device(device)
        set_float32_numerics()
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
    def _quantized(self, params):
        if self.qcfg is None:
            return params
        return qat_mod.fake_quantize_agent(
            params, self._axes, self.cfg, self.qcfg, ste=True, tp=self.tp,
            local=self._local)

    def _loss_fn(self, params, batch):
        """The loss this rank backpropagates: its batch's, or (an MoE step
        over data-parallel ranks) its part of the global batch's."""
        params = self._quantized(params)
        kw = {} if self.tp is None else {"tp": self.tp}
        if self._split:
            kw.update(dp=self.dp, ce_weight=self._token_share(batch))
        return self.model.loss(params, batch, remat=self.tc.remat, **kw)

    def _token_share(self, batch):
        """This rank's share of the global batch's loss tokens
        (``loss_mask`` when the batch has one) over the data-parallel
        ranks."""
        n = (batch["loss_mask"].sum(dtype=torch.float32)
             if "loss_mask" in batch else
             torch.tensor(float(batch["labels"].numel()),
                          device=batch["labels"].device))
        total = n.clone()
        for g in self._dp_groups:
            dist.all_reduce(total, group=g)
        return n / torch.clamp(total, min=1.0)

    def _sum_over_ranks(self, tensors):
        for t in tensors:
            for g in self._dp_groups:
                dist.all_reduce(t, group=g)

    def _mean_over_ranks(self, grads, loss, batch):
        """The gradients and loss of the mean loss over the batch slices
        of the data-parallel ranks: each rank's weighted by its share of
        the loss tokens (``loss_mask`` when the batch has one), summed."""
        w = self._token_share(batch)
        grads = tree_map(lambda t: t * w, grads)
        loss = loss * w
        self._sum_over_ranks([loss, *tree_leaves(grads)])
        return grads, loss

    def _step(self, params, opt_state, err, batch):
        """(params, opt_state, err, batch) -> the same, updated, and the
        metrics ``{"loss", "grad_norm", "lr"}`` as device scalars."""
        return self._apply(*self._backward(params, batch), batch, params,
                           opt_state, err)

    def _backward(self, params, batch):
        """([this rank's gradients], its loss); the leaves it computed
        with are freed on return, only their gradients kept.  An MoE step
        over data-parallel ranks returns them summed over the ranks
        already."""
        if self._rows is not None and batch["labels"].shape[0] != self._rows:
            raise ValueError(
                f"this rank's batch has {batch['labels'].shape[0]} rows; "
                f"the loader's rule gives it {self._rows}")
        leaves = _zip_map(lambda p, d: _gather(p, d).detach()
                          .requires_grad_(True), params, self._dims(params))
        loss = self._loss_fn(leaves, batch)
        loss.backward()
        grads, loss = tree_map(lambda p: p.grad, leaves), loss.detach()
        if self._split:
            self._sum_over_ranks([loss, *tree_leaves(grads)])
        return [grads], loss

    def _dims(self, tree):
        """The model dimension each leaf keeps local, mirroring ``tree``
        (None everywhere without tensor-parallel compute)."""
        if self._local is None:
            return tree_map(lambda _: None, tree)
        return self._local

    def _global_norm(self, grads):
        """``global_norm`` of the whole gradients: a leaf split over
        ``model`` adds the sum of its shards' squares over the ranks (one
        all-reduce for all of them), the leaves in sorted-key order."""
        if self.tp is None:
            return global_norm(grads)
        sqs = [torch.sum(torch.square(g.to(torch.float32)))
               for g in tree_leaves(grads)]
        split = [i for i, d in enumerate(tree_leaves(self._local))
                 if d is not None]
        if split:
            summed = self.tp.all_sum(torch.stack([sqs[i] for i in split]))
            for j, i in enumerate(split):
                sqs[i] = summed[j]
        total = sqs[0]
        for sq in sqs[1:]:
            total = total + sq
        return torch.sqrt(total)

    def _apply(self, held, loss, batch, params, opt_state, err):
        """The step after the backward, given ``held``, a list holding
        this rank's gradients (a leaf that computes on its ``model`` shard
        has that shard's), and its loss.  The list is emptied, so the
        whole gradients are freed before AdamW, only this rank's parts of
        them kept."""
        grads, loss, err = self._reduce(held.pop(), loss, batch, err)
        norm = self._global_norm(grads)
        parts = _map3(_part, grads, params, self._local)
        del grads
        return self._update(parts, norm, loss, params, opt_state, err)

    def _reduce(self, grads, loss, batch, err):
        """(gradients, loss, residual) after the mean over the
        data-parallel ranks (an MoE step's backward summed them already)
        and the compression; new trees where either ran."""
        if self._dp_groups and not self._split:
            grads, loss = self._mean_over_ranks(grads, loss, batch)
        dims = self._dims(grads)
        if self.tc.grad_compression == "int8_ef":
            axis = "pod" if self.podwise else None
            grads, new_err = compress_tree(
                grads, _zip_map(_gather, err, dims), axis, self.mesh,
                self.tp, self._local)
            err = _map3(lambda e, like, d: _wrap(_part(e, like, d), like),
                        new_err, err, self._local)
            if self.podwise:
                group = self.mesh.get_group("pod")
                dist.all_reduce(loss, group=group)
                loss = loss * float(np.float32(1.0) / np.float32(
                    dist.get_world_size(group)))
        return grads, loss, err

    def _update(self, parts, norm, loss, params, opt_state, err):
        """AdamW on this rank's part of the state, given its parts of the
        gradients and their global norm."""
        new_p, new_state, metrics = self.opt.update(
            parts,
            AdamWState(step=opt_state.step, m=tree_map(_local, opt_state.m),
                       v=tree_map(_local, opt_state.v)),
            tree_map(_local, params), grad_norm=norm)
        params = _zip_map(_wrap, new_p, params)
        opt_state = AdamWState(step=new_state.step,
                               m=_zip_map(_wrap, new_state.m, opt_state.m),
                               v=_zip_map(_wrap, new_state.v, opt_state.v))
        metrics["loss"] = loss
        return params, opt_state, err, metrics

    def build_step(self, batch_struct=None) -> Callable:
        """The step function (eager: nothing is traced or compiled).
        ``batch_struct``, the global batch's shapes (the loader's
        ``peek_structure``), tells an MoE step over data-parallel ranks
        how the loader places the batch, by the loader's own rule: sliced
        over every ``pod`` x ``data`` rank, or whole on each where it
        does not divide; the step then checks each batch's rows."""
        self._split, self._rows = False, None
        if self.dp is not None:
            if batch_struct is None:
                raise ValueError("an MoE step over data-parallel ranks "
                                 "needs the global batch's structure")
            labels = batch_struct["labels"]
            phys = batch_shardings({"labels": labels}, BATCH_RULES,
                                   self.mesh)["labels"].spec[0]
            axes = (() if phys is None else
                    phys if isinstance(phys, tuple) else (phys,))
            sizes = axis_sizes(self.mesh)
            self._split = bool(axes)
            self._rows = labels.shape[0] // math.prod(sizes[a] for a in axes)
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
