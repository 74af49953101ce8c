"""Per-device cost accounting of an eager step (``repro/launch/hloparse.py``).

The reference derives the roofline's inputs from the compiled
per-partition HLO text.  The port's step is eager PyTorch, so there is no
program text: :func:`analyze` runs the step once under a
``TorchDispatchMode`` and accounts every op it dispatches: on real
tensors, under a ``FakeTensorMode``, or on ``meta`` tensors (the
dry-run's: nothing allocated, nothing launched, every kernel op through
its fake version).  Every op is one rank's, so every count is per
device.

  * flops            -- the torch FLOP counter's formulas
                        (``torch.utils.flop_counter.flop_registry``):
                        ``mm``/``addmm``/``bmm``/``baddbmm`` (einsums and
                        matmuls reach these) and the port's kernel ops,
                        each of which registers its own (``kernels/``).
                        The fused attention accounting ops register none:
                        as the reference's custom-calls, they are opaque
                        to the census.
  * hbm bytes        -- operand plus result bytes of every op.  Eager
                        PyTorch fuses nothing, so every op is a fusion
                        boundary (the reference's rule at its fusion
                        boundaries); views, aliases, ``detach`` and bare
                        allocations are free (its ``_SKIP_BYTES``).  A
                        broadcast operand is billed the bytes it holds.
  * collective bytes -- the ``c10d`` ops: operand bytes for all-reduce
                        and reduce-scatter, result bytes for all-gather,
                        all-to-all and broadcast (the reference's split).

The reference's loop fields stay: Python loops are unrolled into the op
stream, so ``n_while`` is 0 and ``trip_counts`` empty.  Beside them,
``peak_bytes``: the most bytes of storage created during the step that
were alive at once (its temporaries and outputs), ``kernel_calls``: how
often each of the port's ops ran, and ``op_bytes``: the HBM bytes by op
name.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = {
    # c10d op: (breakdown name, argument whose bytes count)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "broadcast_": ("broadcast", 0),
}

#: allocations that write nothing (the reference's ``parameter``-like
#: instructions); views and aliases are recognised by their schema
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "set_", "resize_"}

_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}


@dataclasses.dataclass
class OpCosts:
    """The reference's ``HloCosts`` fields, per device, plus the step's
    peak of live bytes it allocated, its kernel ops' call counts and its
    bytes by op."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    n_while: int = 0
    trip_counts: List[int] = dataclasses.field(default_factory=list)
    n_dots: int = 0
    peak_bytes: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor holds: its elements once each, a dimension of
    stride 0 (a broadcast) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    if t.numel() == 0:
        n = 0
    return n * t.element_size()


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Accountant(TorchDispatchMode):
    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs
        self._live = 0
        self._seen: Dict[int, int] = {}

    def _track(self, out) -> None:
        """Count the storages an op created; forget them when they die."""
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self._live += n
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.costs
        ns = func.namespace
        if ns == "prim":
            # metadata queries (a fake tensor's ``.device`` dispatches
            # ``prim.device``): no kernel, no bytes
            return out
        name = func._overloadpacket.__name__
        if ns == "repro_torch":
            c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            c.flops += formula(*args, **kwargs, out_val=out)
            if name in _MATMULS:
                c.n_dots += 1
        if ns == "c10d" and name in _COLLECTIVES:
            kind, which = _COLLECTIVES[name]
            b = _bytes(args[which])
            c.collective_bytes += b
            c.collective_breakdown[kind] = \
                c.collective_breakdown.get(kind, 0.0) + b
        if not (func.is_view or name in _FREE):
            b = _bytes((args, kwargs)) + _bytes(out)
            c.hbm_bytes += b
            key = f"{ns}.{name}"
            c.op_bytes[key] = c.op_bytes.get(key, 0.0) + b
        self._track(out)
        return out


_ACTIVE: List[OpCosts] = []


def note_flops(n: float, dots: int = 0) -> None:
    """Add ``n`` flops (and ``dots`` products) to the running accountant,
    if any: for products a step computes as elementwise multiplies and
    sums (which the FLOP counter cannot see) where the reference's
    census counts einsums.  A no-op outside :func:`account`."""
    if _ACTIVE:
        _ACTIVE[-1].flops += n
        _ACTIVE[-1].n_dots += dots


def account(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCosts]:
    """(``fn(*args, **kwargs)``, its :class:`OpCosts`), ``fn`` run once
    under the accountant.  The arguments' own storage is not in
    ``peak_bytes``."""
    costs = OpCosts()
    _ACTIVE.append(costs)
    try:
        with _Accountant(costs):
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return out, costs


def analyze(fn: Callable, *args, **kwargs) -> OpCosts:
    """The :class:`OpCosts` of one run of ``fn(*args, **kwargs)``."""
    return account(fn, *args, **kwargs)[1]
