"""Collectives inside a training step's forward and backward: tensor
parallelism over the mesh's ``model`` axis (Megatron-style), and the MoE
router's statistics and expert capacity over the data-parallel ranks.

The reference has no such module: GSPMD inserts its collectives where the
shardings of the jitted step ask for them.  Here each is an autograd
function over a process group, so the backward carries its adjoint:

  copy      identity forward, all-reduce backward: into a region whose
            products each rank computes on its own shard
  reduce    all-reduce forward, identity backward: the partial sums out
            of a row-parallel product
  gather    all-gather forward (concatenated along ``dim``), this rank's
            chunk backward
  scatter   all-reduce then this rank's chunk forward, all-gather
            backward: a reduce-scatter.  Gloo has no ``reduce_scatter``
            and the CPU ranks and the ranks that share a card both run on
            gloo; a true reduce-scatter is later work
  split     this rank's chunk forward, all-gather backward

A failed collective raises; nothing here catches it.

:class:`TensorParallel` names the ``model`` group and which parts of a
decoder LM compute on their shards (:func:`decoder_plan`):

* attention, where the KV heads divide over ``model``: ``wq``/``wk``/``wv``
  and their biases column-parallel by whole KV groups (``q_dim`` is
  head-major, so the q heads of KV head j lie on the rank that holds j),
  ``wo`` row-parallel;
* the MLP, where ``d_ff`` divides: ``wi``/``wi_gate``/``wi_up``
  column-parallel, ``wo`` row-parallel;
* the vocabulary, where it divides: the embedding looks up its own rows
  and zeros the others before an all-reduce (one nonzero term: exact);
  the head gives vocabulary-sharded logits and the cross-entropy reduces
  the max, the sum of exponentials and the label's logit;
* the experts, where they divide: each rank runs its ``E / model``
  experts on the dispatch and combine that every rank computes whole from
  the replicated router, and the partial outputs are all-reduced.

A part whose sizes do not divide computes replicated on leaves gathered
whole, as before tensor parallelism; its leaves' storage is unchanged.

:class:`DataParallel` names the data-parallel groups of an MoE step whose
batch is split over ranks: the load-balancing loss's per-expert sums and
token counts are summed over them, and the dispatch's per-(group, slot,
expert) counts are exchanged where a capacity group spans ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import axis_sizes


def _all_gather(x: torch.Tensor, dim: int, group, size: int):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, rank: int, size: int):
    return x.chunk(size, dim=dim)[rank].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.args = (dim, rank, size)
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, rank, size = ctx.args
        return _chunk(g, dim, rank, size), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, size, reduce):
        ctx.args = (dim, group, size)
        y = x.contiguous().clone()
        if reduce:
            dist.all_reduce(y, group=group)
        return _chunk(y, dim, rank, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        return _all_gather(g, dim, group, size), None, None, None, None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` group of this rank and the parts of a decoder LM that
    compute on their shards of it (the others compute replicated)."""

    group: Any
    size: int
    rank: int
    attn: bool = False
    mlp: bool = False
    vocab: bool = False
    experts: bool = False

    def copy(self, x):
        return _Copy.apply(x, self.group)

    def reduce(self, x):
        return _Reduce.apply(x, self.group)

    def gather(self, x, dim: int):
        return _Gather.apply(x, dim, self.group, self.rank, self.size)

    def scatter(self, x, dim: int):
        return _Scatter.apply(x, dim, self.group, self.rank, self.size,
                              True)

    def split(self, x, dim: int):
        return _Scatter.apply(x, dim, self.group, self.rank, self.size,
                              False)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the group (no gradient)."""
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (no gradient)."""
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def offset(self, local: int) -> int:
        """The first global index of this rank's chunk of a dimension whose
        chunks have ``local`` entries."""
        return self.rank * local

    def attn_cfg(self, cfg):
        """``cfg`` with this rank's heads: the local projections' shapes."""
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // self.size,
                                   n_kv_heads=cfg.n_kv_heads // self.size)


def _model_dim(spec) -> Optional[int]:
    """The tensor dimension a spec maps the ``model`` axis to, or None."""
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in names:
            return d
    return None


# the tensor dimension each sharded compute layout keeps split over
# ``model`` (layer-stacked leaves: dimension 0 is the layer)
_ATTN_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1,
              "bv": 1}
_MLP_DIMS = {"wi": 2, "wi_gate": 2, "wi_up": 2, "wo": 1}
_EXPERT_DIMS = {"wi_gate": 1, "wi_up": 1, "wo": 1}


def decoder_plan(cfg, specs, mesh) -> Tuple[Optional[TensorParallel], Any]:
    """(the :class:`TensorParallel` of a decoder LM's step over ``mesh``,
    a tree mirroring ``specs`` of the model-sharded dimension each leaf
    keeps local in the step, or None where the leaf is gathered whole).

    ``specs`` is the tree of the leaves' spec tuples
    (``parallel/sharding.py``).  A part computes on its shards when its
    sizes divide over ``model`` (attention: the KV heads) and its leaves
    are stored split there, on the dimension its products split; None
    and no local leaves when ``model`` is 1."""
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    if m <= 1:
        return None, _map_specs(lambda s: None, specs)

    def held(tree, dims):
        return all(_model_dim(tree[k]) == d for k, d in dims.items()
                   if k in tree)

    layers = specs["layers"]
    attn = cfg.n_kv_heads % m == 0 and held(layers["attn"], _ATTN_DIMS)
    ffn = layers["ffn"]
    if cfg.n_experts:
        mlp = False
        experts = cfg.n_experts % m == 0 and held(ffn, _EXPERT_DIMS)
    else:
        mlp = held(ffn, _MLP_DIMS)
        experts = False
    emb = specs["embed"]
    vocab = _model_dim(emb["tok"]) == 0 and (
        "unembed" not in emb or _model_dim(emb["unembed"]) == 1)
    coord = mesh.get_coordinate()
    tp = TensorParallel(group=mesh.get_group("model"), size=m,
                        rank=coord[mesh.mesh_dim_names.index("model")],
                        attn=attn, mlp=mlp, vocab=vocab, experts=experts)

    def part(tree, on, dims):
        return {k: (dims[k] if on and k in dims else None) for k in tree}

    local = _map_specs(lambda s: None, specs)
    local["layers"]["attn"] = part(layers["attn"], attn, _ATTN_DIMS)
    local["layers"]["ffn"] = part(
        ffn, experts if cfg.n_experts else mlp,
        _EXPERT_DIMS if cfg.n_experts else _MLP_DIMS)
    local["embed"] = {k: ({"tok": 0, "unembed": 1}[k] if vocab else None)
                      for k in emb}
    return tp, local


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# data parallelism of an MoE step
# ---------------------------------------------------------------------------

class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The data-parallel ranks whose batch slices make up one loss: their
    groups (outermost first, as the loader orders the slices), their
    count and this rank's index among them."""

    groups: Tuple[Any, ...]
    size: int
    index: int

    @classmethod
    def of(cls, mesh, axes: Sequence[str]) -> "DataParallel":
        sizes = axis_sizes(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[a]
        return cls(groups=tuple(mesh.get_group(a) for a in axes
                                if sizes[a] > 1),
                   size=math.prod(sizes[a] for a in axes), index=index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; its gradient is this rank's
        own (identity backward): each rank's backward then holds its own
        tokens' part of the gradient of a function of the sums, and the
        step's sum over the ranks holds all of it."""
        return _SumRanks.apply(x, self.groups)

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """[size, ...]: every rank's ``x`` (integers: exact), by index."""
        out = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[self.index] = x
        for g in self.groups:
            dist.all_reduce(out, group=g)
        return out
