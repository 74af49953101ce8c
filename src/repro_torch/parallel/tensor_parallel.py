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
  gather_summed
            all-gather forward, all-reduce then this rank's chunk backward:
            the keys and values of a sequence-parallel attention, which
            every rank's query chunk reads whole

A failed collective raises; nothing here catches it.

:class:`TensorParallel` names the ``model`` group and which parts of a
model compute on their shards (:func:`model_plan`, for every family):

* attention, where the KV heads divide over ``model``: ``wq``/``wk``/``wv``
  and their biases column-parallel by whole KV groups (``q_dim`` is
  head-major, so the q heads of KV head j lie on the rank that holds j),
  ``wo`` row-parallel.  The encoder-decoder's three attentions (the
  encoder's, the decoder's causal self-attention and its cross-attention,
  whose k/v come from the encoder's output) split alike;
* the MLP, where ``d_ff`` divides: ``wi``/``wi_gate``/``wi_up``
  column-parallel, ``wo`` row-parallel;
* the vocabulary, where it divides: the embedding looks up its own rows
  and zeros the others before an all-reduce (one nonzero term: exact);
  the head gives vocabulary-sharded logits and the cross-entropy reduces
  the max, the sum of exponentials and the label's logit;
* the experts, where they divide: each rank runs its ``E / model``
  experts on the dispatch and combine that every rank computes whole from
  the replicated router, and the partial outputs are all-reduced;
* Mamba, where its heads divide: ``in_x``/``in_z``/``in_dt`` column-
  parallel by whole heads (``d_in`` is head-major), the conv, the chunked
  scan and ``A_log``/``D``/``dt_bias`` on the local heads, ``in_B`` and
  ``in_C`` (the ``state`` axis has no rule) computed whole on every rank,
  the gated RMSNorm over the whole ``d_in`` (its per-row sum of squares
  all-reduced), ``out`` row-parallel;
* mLSTM, where its heads divide: ``wq``/``wk``/``wv``/``w_o`` column-
  parallel by heads, the replicated ``w_i``/``w_f``/``b_i``/``b_f``
  sliced to the local heads, ``wout`` row-parallel;
* sLSTM, where its ``wx`` is stored split (over the ``gates`` axis, in
  contiguous chunks: at ``model`` 2 rank 0 holds z and i, rank 1 f and
  o): ``wx`` column-parallel on the stored chunk, the gate
  pre-activations all-gathered, the cell (whose recurrence needs all four
  gates of a head) and ``r``, ``b``, ``wout`` replicated.

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


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.args = (dim, group, rank, size)
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, rank, size = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return _chunk(g, dim, rank, size), None, None, None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` group of this rank and the parts of a model that
    compute on their shards of it (the others compute replicated)."""

    group: Any
    size: int
    rank: int
    attn: bool = False
    mlp: bool = False
    vocab: bool = False
    experts: bool = False
    mamba: bool = False
    mlstm: bool = False
    slstm: bool = False

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

    def gather_summed(self, x, dim: int):
        """``x`` whole along ``dim`` from every rank's chunk, read by each
        rank's own computation: the backward sums the ranks' gradients of
        the whole and keeps this rank's chunk (a reduce-scatter)."""
        return _GatherSummed.apply(x, dim, self.group, self.rank, self.size)

    def total(self, x):
        """The sum of ``x`` over the group, for every rank to go on using
        on its own shards: all-reduce forward and backward (each rank's
        gradient of the sum is a partial one)."""
        return self.copy(self.reduce(x))

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


@dataclasses.dataclass(frozen=True)
class SequenceShards:
    """Where a cache's sequence axis lives: ``size`` contiguous shards of
    ``length`` positions over the mesh axes ``axes`` (major first, their
    groups ``groups``), this rank holding shard ``index``.  The sharding
    rules say which axes (``cache_seq``: ``data`` at ``long_500k``,
    ``model`` under ``cacheshard``); the decode steps take it as they
    take ``tp``.

    A decode step writes a fresh entry on the shard that holds its
    position only, and attends in flash-decoding partials: each rank's
    unnormalized (acc, m, l) over its positions, merged over ``groups``
    by the logsumexp rule (one max all-reduce, two sum all-reduces), the
    reference's partial-softmax merge (``repro/models/layers.py``:
    ``fused_decode_attention_acct``)."""

    axes: Tuple[str, ...]
    groups: Tuple[Any, ...]
    size: int
    index: int
    length: int

    @property
    def offset(self) -> int:
        """The global position of this rank's first entry."""
        return self.index * self.length

    @classmethod
    def of(cls, mesh, axes: Sequence[str], length: int) -> "SequenceShards":
        """The layout of a cache split over ``axes`` of ``mesh`` whose local
        part has ``length`` positions."""
        sizes = axis_sizes(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[a]
        return cls(axes=tuple(axes),
                   groups=tuple(mesh.get_group(a) for a in axes
                                if sizes[a] > 1),
                   size=math.prod(sizes[a] for a in axes), index=index,
                   length=int(length))

    def write(self, cache: torch.Tensor, rows: torch.Tensor,
              pos: torch.Tensor, new: torch.Tensor) -> None:
        """Store ``new`` [B, ...] at global position ``pos`` [B] of this
        rank's ``cache`` [B, length, ...] where this rank holds it, in
        place.  ``dynamic_update_slice``'s clamp stays global: a ``pos``
        past the whole cache writes its last entry, on the last shard.
        Every rank reads and writes its entry at the clamped local index
        (the others write back what they read): no host sync, so the
        step can be captured."""
        at = torch.clamp(pos, max=self.size * self.length - 1) - self.offset
        mine = (at >= 0) & (at < self.length)
        idx = torch.clamp(at, 0, self.length - 1)
        old = cache[rows, idx]
        keep = mine.reshape((-1,) + (1,) * (new.dim() - 1))
        cache[rows, idx] = torch.where(keep, new.to(cache.dtype), old)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.contiguous().clone()
        for g in self.groups:
            dist.all_reduce(t, op=op, group=g)
        return t

    def merge(self, acc: torch.Tensor, m: torch.Tensor,
              l: torch.Tensor) -> torch.Tensor:
        """The attention of this rank's partials (acc [B, 1, KV, G, dh],
        m and l [B, KV, G, 1]) merged with every shard's: [B, 1, KV, G,
        dh] in float32."""
        m_all = self._reduce(m, dist.ReduceOp.MAX)
        finite = torch.isfinite(m)
        corr = torch.where(finite, torch.exp(
            torch.where(finite, m - m_all, 0.0)), 0.0)
        l = self._reduce(l * corr, dist.ReduceOp.SUM)
        acc = self._reduce(acc * corr[:, None], dist.ReduceOp.SUM)
        return acc / torch.clamp(l[:, None], min=1e-30)


def cache_shards(mesh, spec, seq_dim: int, length: int):
    """The :class:`SequenceShards` of a cache leaf placed by ``spec`` whose
    sequence is dimension ``seq_dim`` and holds ``length`` positions here,
    or None where the spec does not split that dimension."""
    entry = spec[seq_dim] if seq_dim < len(spec) else None
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    sizes = axis_sizes(mesh)
    if math.prod(sizes[a] for a in axes) <= 1:
        return None
    return SequenceShards.of(mesh, axes, length)


def _model_dim(spec) -> Optional[int]:
    """The tensor dimension a spec maps the ``model`` axis to, or None."""
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in names:
            return d
    return None


# the tensor dimension each sharded compute layout keeps split over
# ``model``, its leaves stacked over one leading axis (a decoder's
# ``layers``, an encoder-decoder's layers, a hybrid's ``blocks``); a part
# stacked over two (a hybrid's or xLSTM's ``blocks`` x ``layers``) keeps
# each one further on
_ATTN_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1,
              "bv": 1}
_MLP_DIMS = {"wi": 2, "wi_gate": 2, "wi_up": 2, "wo": 1}
_EXPERT_DIMS = {"wi_gate": 1, "wi_up": 1, "wo": 1}
_MAMBA_DIMS = {"in_x": 2, "in_z": 2, "in_dt": 2, "conv_x": 2, "A_log": 1,
               "D": 1, "dt_bias": 1, "norm": 1, "out": 1}
_MLSTM_DIMS = {"wq": 2, "wk": 2, "wv": 2, "w_o": 2, "wout": 1}
_SLSTM_DIMS = {"wx": 2}


def _deeper(dims):
    return {k: d + 1 for k, d in dims.items()}


def _parts(cfg, specs):
    """[(flag, the paths of its subtrees, their split dimensions, the
    count that must divide over ``model`` or None)] of the model whose
    parameter tree ``specs`` mirrors, by the tree's structure."""
    kv = cfg.n_kv_heads
    if "layers" in specs:                                  # decoder LM
        ffn = [("layers", "ffn")]
        return [("attn", [("layers", "attn")], _ATTN_DIMS, kv),
                ("experts", ffn, _EXPERT_DIMS, cfg.n_experts)
                if cfg.n_experts else ("mlp", ffn, _MLP_DIMS, None)]
    if "enc" in specs:                                     # encoder-decoder
        return [("attn", [("enc", "attn"), ("dec", "attn"),
                          ("dec", "cross")], _ATTN_DIMS, kv),
                ("mlp", [("enc", "mlp"), ("dec", "mlp")], _MLP_DIMS, None)]
    if "mamba" in specs["blocks"]:                         # hybrid
        heads = cfg.d_model * cfg.mamba_expand // cfg.mamba_headdim
        return [("attn", [("blocks", "attn")], _ATTN_DIMS, kv),
                ("mlp", [("blocks", "mlp")], _deeper(_MLP_DIMS), None),
                ("experts", [("blocks", "moe")], _deeper(_EXPERT_DIMS),
                 cfg.n_experts),
                ("mamba", [("blocks", "mamba")], _deeper(_MAMBA_DIMS),
                 heads)]
    return [("mlstm", [("blocks", "mlstm")], _deeper(_MLSTM_DIMS),   # xLSTM
             cfg.n_heads),
            ("slstm", [("blocks", "slstm")], _SLSTM_DIMS, None)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def model_plan(cfg, specs, mesh) -> Tuple[Optional[TensorParallel], Any]:
    """(the :class:`TensorParallel` of a model's step over ``mesh``, a
    tree mirroring ``specs`` of the model-sharded dimension each leaf
    keeps local in the step, or None where the leaf is gathered whole),
    for any family: the decoder LM (dense or MoE), the hybrid, the xLSTM
    and the encoder-decoder, told apart by their parameter trees.

    ``specs`` is the tree of the leaves' spec tuples
    (``parallel/sharding.py``).  A part computes on its shards when its
    sizes divide over ``model`` (attention: the KV heads; experts, Mamba
    and mLSTM: their counts) and its leaves are stored split there, on
    the dimension its products split; otherwise it computes replicated on
    its leaves gathered whole, a stated plan and not a fallback.  None
    and no local leaves when ``model`` is 1."""
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    if m <= 1:
        return None, _map_specs(lambda s: None, specs)
    local = _map_specs(lambda s: None, specs)
    flags = {}
    for flag, paths, dims, count in _parts(cfg, specs):
        on = (count is None or count % m == 0) and all(
            _model_dim(_at(specs, p)[k]) == d for p in paths
            for k, d in dims.items() if k in _at(specs, p))
        flags[flag] = on
        for p in paths:
            sub = _at(specs, p)
            _at(local, p[:-1])[p[-1]] = {
                k: (dims[k] if on and k in dims else None) for k in sub}
    emb = specs["embed"]
    vocab = _model_dim(emb["tok"]) == 0 and (
        "unembed" not in emb or _model_dim(emb["unembed"]) == 1)
    local["embed"] = {k: ({"tok": 0, "unembed": 1}[k] if vocab else None)
                      for k in emb}
    coord = mesh.get_coordinate()
    tp = TensorParallel(group=mesh.get_group("model"), size=m,
                        rank=coord[mesh.mesh_dim_names.index("model")],
                        vocab=vocab, **flags)
    return tp, local


def shard_leaf(leaf, dim: Optional[int], tp: Optional[TensorParallel]):
    """This rank's part of a whole leaf that :func:`model_plan` computes on
    its ``model`` shard of dimension ``dim`` (None: ``leaf`` whole).  An
    int8-resident leaf (``core.quantization.QuantizedTensor``) keeps its
    codes' chunk and its scale's columns of it where the scale has that
    dimension (a per-channel scale of a column-parallel product), the
    scale whole where it broadcasts there."""
    if dim is None or tp is None:
        return leaf
    codes = getattr(leaf, "codes", None)
    if codes is None:
        return _chunk(leaf, dim, tp.rank, tp.size)
    scale = leaf.scale
    if scale.shape[dim] > 1:
        scale = _chunk(scale, dim, tp.rank, tp.size)
    return dataclasses.replace(leaf, codes=_chunk(codes, dim, tp.rank,
                                                  tp.size), scale=scale)


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
