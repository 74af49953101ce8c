"""Continuous-batching greedy decode over a quantized KV cache
(``repro/runtime/decode_engine.py``).

A request prefills once, then occupies a decode slot for a run of
single-token steps whose cost is dominated by reading the KV cache.  The
engine keeps the reference's four commitments:

1.  **Continuous batching.**  A request is admitted into a free slot the
    moment one exists and retires the moment its budget is spent;
    ``admission="barrier"`` (refill a slot block only once it has drained)
    runs on the same code for comparison.
2.  **Quantized KV cache, attended directly.**  Entries are int8-held codes
    plus one f32 scale per head vector (``kernels.quantize.kv_quantize``)
    at the class's ``b_kv``; ``DecoderLM.decode_step_q`` quantizes each
    fresh entry before writing it and attends through the
    ``quantized_decode_attention`` CUDA kernel, which dequantizes tile by
    tile.  ``b_kv >= 16`` keeps the raw float32 container with unit scales.
3.  **Device residency.**  Each slot block's codes, scales, positions and
    last tokens live on the device across steps and are updated in place;
    the host sees the prompt going in and the token blocks coming out.
4.  **Bitwise parity.**  Greedy decode through the batched engine equals
    :func:`greedy_decode_reference` (batch width 1) token for token: a
    request's cache bucket is a function of its own prompt and budget, and
    every per-row op of the decode step is row-independent (the
    projections and head through ``layers.row_matmul``, the ``row_gemm``
    kernel on the card; attention through a kernel whose blocks each read
    one row).

The reference's two AOT executables are closures over static buffers
here: :func:`_prefill_slot` (prefill, quantize, scatter into a slot) and
:func:`_decode_step` (one ``decode_step_q`` writing its token into a
``[B, _CHUNK]`` block), each reading and writing only tensors whose
addresses are fixed for a (class, bucket): the slot block's buffers, a
static prompt, last index and slot, a device step counter and eos flags.
On the card each is captured once as a CUDA graph
(``fastpath.CapturedCall``) and memoized in a
``fastpath.CompiledForwardCache`` under the reference's keys (extended with
the weights and the buffers the graph bakes in); :func:`_decode_chunk`
replays the step graph up to ``n_steps`` times with no host sync between
replays unless ``eos`` asks for the reference's early exit (one flag read
per step).  On the CPU the same closures run uncaptured through the same
cache.  :meth:`DecodeEngine.warmup` captures every reachable variant, and
the report's compile fields count captures.  A capture's eager warm-up run
is a real step, so each capture restores the slot block it ran on: a graph
captured lazily, with live rows in the block, changes nothing.

Costs are billed on a virtual clock exactly as in the reference: each
token step of a chunk bills all ``max_batch`` slots plus the full cache
read at ``b_kv``, and a chunk never runs past a scheduling boundary (the
tightest remaining budget, the next queued arrival, the eos exit), so
admission and retirement times equal one-token-at-a-time stepping.

``tracer``/``metrics`` take the reference's spans (``decode.prefill``,
``decode.chunk``, and ``forward.capture`` for a capture, the port's name
for the reference's ``xla.compile``), instants and metrics.
``mixed_precision=True`` solves each class's per-layer allocation with
``core.mixed_precision.allocate_bits_decode`` and decodes with its plan's
fake-quantized weight tree (one tree per ``plan.key()``; the captured
prefill and token step key on that tree's tensors).
:meth:`DecodeEngine.snapshot_request` freezes one in-flight slot into the
reference's host-side state, which ``greedy_decode_reference(state=)``
resumes bitwise (the serving supervisor's crash recovery).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import mixed_precision as mp
from ..core.cost_model import (SystemParams, agent_delay, agent_energy,
                               kv_delay, kv_energy, server_delay,
                               server_energy)
from ..core.quantization import QuantConfig, QuantPlan
from ..core.rate_distortion import exponential_mle
from ..device import resolve_device, set_float32_numerics
from ..kernels.bucketing import DEFAULT_SEQ_BASE, seq_bucket, seq_ladder
from ..kernels.quantize import kv_cache_bytes, kv_quantize
from ..models.lm import tree_leaves, tree_map
from ..obs import NULL_METRICS, NULL_TRACER
from .fastpath import CapturedCall, CompiledForwardCache, tree_key
from .qat import fake_quantize_agent
from .serve_engine import CodesignCache, QosClass, fit_lambda

__all__ = [
    "DecodeRequest",
    "DecodeResponse",
    "ClassDecodeStats",
    "DecodeReport",
    "DecodeEngine",
    "decode_protocol_gap",
    "fit_kv_lambda",
    "greedy_decode_reference",
]

# one decode chunk emits up to this many tokens per slot; where the host
# cuts a run of steps into chunks changes no bit (each step is the same
# decode_step_q call)
_CHUNK = 64

# the speculative round's fixed draft-column width (``runtime/
# speculative.py``): the lookahead k is a runtime value up to this many
# columns, never a capture key
_SPEC_MAX_K = 16

# the KV-cache layout this engine manages slots in
_DECODE_CACHE_AXES = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "len": ("batch",),
}


def decode_protocol_gap(model) -> Optional[str]:
    """Why ``model`` cannot be decode-served (None when it can): it needs
    the ``prefill``/``init_cache``/``decode_step``/``decode_step_q``/
    ``cache_axes`` hooks over the [L, B, T, KV, dh] KV-cache layout."""
    missing = [h for h in ("prefill", "init_cache", "decode_step",
                           "decode_step_q", "cache_axes")
               if not hasattr(model, h)]
    if missing:
        return f"lacks the {'/'.join(missing)} decode hook(s)"
    if model.cache_axes() != _DECODE_CACHE_AXES:
        return ("decode state is not the [layers, batch, cache_seq, "
                "kv_heads, head_dim] KV cache")
    return None


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One queued decode request: a prompt plus a generation budget."""
    request_id: int
    tokens: np.ndarray          # int32 [P] prompt
    qos: str
    max_new_tokens: int
    arrival_s: float            # virtual arrival time


@dataclasses.dataclass(frozen=True)
class DecodeResponse:
    """A retired request: greedy continuation + its latency accounting."""
    request_id: int
    qos: str
    tokens: np.ndarray          # int32, generated greedily (<= max_new)
    prompt_len: int
    b_kv: int                   # stored cache bit-width it decoded under
    ttft_s: float               # arrival -> first token (virtual clock)
    itl_mean_s: float           # mean inter-token latency (0 if 1 token)
    finished_s: float
    cancelled: bool = False     # retired mid-decode by cancel()


@dataclasses.dataclass(frozen=True)
class ClassDecodeStats:
    """Per-QoS-class latency aggregates of a :class:`DecodeReport`."""
    qos: str
    b_hat: int
    b_kv: int
    requests: int
    tokens: int
    ttft_mean_s: float
    ttft_max_s: float
    itl_mean_s: float
    plan_bits: tuple = ()       # per-agent-layer bits under a plan
    itl_p50_s: float = 0.0
    itl_p95_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class DecodeReport:
    """Whole-run aggregates of a :class:`DecodeEngine`."""
    requests_served: int
    cancelled: int
    tokens_generated: int
    prefills: int
    decode_rounds: int          # token steps run, summed over chunks
    total_delay_s: float        # virtual clock at the end of the run
    total_energy_j: float
    throughput_tps: float       # generated tokens / modeled second
    throughput_rps: float
    admission: str              # "continuous" | "barrier"
    classes: tuple = ()         # ClassDecodeStats per QoS class
    kv_bytes: int = 0           # stored cache bytes across admissions
    kv_bytes_full: int = 0      # same cache at full precision
    codesign_hits: int = 0      # this engine's cache attribution
    codesign_misses: int = 0
    compile_hits: int = 0       # this engine's compile-cache lookups: a
    compile_misses: int = 0     # miss is one capture on the card
    compiled_variants: int = 0  # entries of the (maybe shared) cache
    h2d_bytes: int = 0          # host->device bytes of the interface
    d2h_bytes: int = 0          # device->host bytes of the interface


# ---------------------------------------------------------------------------
# cache-activation statistic
# ---------------------------------------------------------------------------

_KV_LAMBDA_MEMO: Dict[tuple, float] = {}


def _params_fingerprint(params) -> tuple:
    """A cheap identity for a parameter tree: every leaf's (shape, dtype)
    plus the first leaf's leading bytes."""
    leaves = list(tree_leaves(params))
    head = leaves[0].reshape(-1)[:8].detach().cpu().numpy().tobytes()
    return (tuple((tuple(lf.shape), str(lf.dtype)) for lf in leaves), head)


def fit_kv_lambda(model, params, *, seq: int = 16) -> float:
    """MLE λ_kv over K/V cache magnitudes from one calibration prefill of
    the deterministic prompt ``arange(seq) % vocab`` at full precision.

    Memoized per (config, seq, parameter fingerprint), as in the
    reference: the prefill is a real forward pass.
    """
    key = (model.cfg, int(seq), _params_fingerprint(params))
    if key not in _KV_LAMBDA_MEMO:
        cfg = model.cfg
        dev = next(tree_leaves(params)).device
        toks = (torch.arange(seq, device=dev) % int(cfg.vocab_size))
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks[None]})
        mags = torch.cat([torch.abs(cache["k"]).reshape(-1),
                          torch.abs(cache["v"]).reshape(-1)])
        _KV_LAMBDA_MEMO[key] = float(exponential_mle(mags))
    return _KV_LAMBDA_MEMO[key]


# ---------------------------------------------------------------------------
# the decode functions (shared by the engine and the reference)
# ---------------------------------------------------------------------------

def _container_dtype(cfg, b_kv: int) -> torch.dtype:
    return torch.int8 if b_kv < 16 else getattr(torch, cfg.dtype)


class _PrefillIO:
    """A prefill graph's static inputs, filled before each call: the
    padded prompt ``tokens [1, S]``, its last index ``last [1]`` and the
    ``slot [1]`` to scatter into; and its output, the first greedy token
    ``tok0 [1]``."""

    def __init__(self, s_bucket: int, device):
        self.tokens = torch.zeros((1, s_bucket), dtype=torch.int32,
                                  device=device)
        self.last = torch.zeros((1,), dtype=torch.int32, device=device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=device)
        self.tok0 = torch.zeros((1,), dtype=torch.int32, device=device)


class _StepIO:
    """A token step's static state: the ``[B, _CHUNK]`` token block, the
    device step counter that indexes it, the per-row eos flags and the eos
    id (-1: never, and then a chunk never reads a flag back)."""

    def __init__(self, batch: int, eos: int, device):
        self.eos_exit = eos >= 0
        self.out = torch.zeros((batch, _CHUNK), dtype=torch.int32,
                               device=device)
        self.step = torch.zeros((1,), dtype=torch.int64, device=device)
        self.eos_hit = torch.zeros((batch,), dtype=torch.bool,
                                   device=device)
        self.eos = torch.full((), eos, dtype=torch.int32, device=device)


class _SlotBuffers:
    """A device-resident slot block: quantized cache [L, B, T, KV, dh],
    scales [L, B, T, KV], per-slot position and last token [B], and the
    static inputs of its graphs (one :class:`_StepIO`, one
    :class:`_PrefillIO` per prompt bucket)."""

    def __init__(self, cfg, t_bucket: int, batch: int, b_kv: int, device,
                 eos: int = -1):
        self.t_bucket = int(t_bucket)
        self.device = torch.device(device)
        shape = (cfg.n_layers, batch, t_bucket, cfg.n_kv_heads,
                 cfg.head_dim)
        cont = _container_dtype(cfg, b_kv)
        self.k_codes = torch.zeros(shape, dtype=cont, device=device)
        self.v_codes = torch.zeros(shape, dtype=cont, device=device)
        self.k_scales = torch.ones(shape[:-1], dtype=torch.float32,
                                   device=device)
        self.v_scales = torch.ones(shape[:-1], dtype=torch.float32,
                                   device=device)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.step_io = _StepIO(batch, eos, device)
        self._prefill_io: Dict[int, _PrefillIO] = {}
        self._spec_io: Optional[_SpecIO] = None

    def prefill_io(self, s_bucket: int) -> _PrefillIO:
        if s_bucket not in self._prefill_io:
            self._prefill_io[s_bucket] = _PrefillIO(s_bucket, self.device)
        return self._prefill_io[s_bucket]

    def spec_io(self) -> "_SpecIO":
        """The block's speculative-round state, made on first use."""
        if self._spec_io is None:
            self._spec_io = _SpecIO(self)
        return self._spec_io

    def canonical(self) -> List[torch.Tensor]:
        """The decode state: codes, scales, positions and last tokens."""
        return [self.k_codes, self.v_codes, self.k_scales, self.v_scales,
                self.pos, self.tok]

    def written(self) -> List[torch.Tensor]:
        """Every tensor the block's graphs write."""
        io = self.step_io
        return self.canonical() + [io.out, io.step, io.eos_hit] \
            + [p.tok0 for p in self._prefill_io.values()] \
            + (self._spec_io.written() if self._spec_io is not None else [])


class _SpecIO:
    """A slot block's speculative-round state.

    The draft chain runs on ``scratch``, a copy of the block's canonical
    state made once a round (commit-on-verify: a draft never writes the
    canonical buffers), writing its greedy tokens into column ``di`` of
    ``drafts [B, _SPEC_MAX_K]``.  The verify chain writes the canonical
    buffers in place and keeps the reference's loop state on the device:
    the delivered block ``out [B, _SPEC_MAX_K + 1]``, its column counter
    ``i``, per-row emitted and accepted counts, the active flags and their
    any-reduction (the one flag the host reads back per verify step), the
    remaining budgets and the round's draft count.
    """

    def __init__(self, buf: _SlotBuffers):
        dev = buf.device
        b = buf.pos.shape[0]

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.scratch = [torch.zeros_like(t) for t in buf.canonical()]
        self.drafts = zeros((b, _SPEC_MAX_K), torch.int32)
        self.di = zeros((1,), torch.int64)
        self.out = zeros((b, _SPEC_MAX_K + 1), torch.int32)
        self.i = zeros((1,), torch.int64)
        self.act = zeros((b,), torch.bool)
        self.any_act = zeros((1,), torch.bool)
        self.cnt = zeros((b,), torch.int32)
        self.acc = zeros((b,), torch.int32)
        self.rem = zeros((b,), torch.int32)
        self.n_draft = zeros((1,), torch.int64)
        self.eos = buf.step_io.eos

    def written(self) -> List[torch.Tensor]:
        return self.scratch + [self.drafts, self.di, self.out, self.i,
                               self.act, self.any_act, self.cnt, self.acc,
                               self.rem, self.n_draft]


@torch.no_grad()
def _prefill_slot(model, b_kv: int, weights, buf: _SlotBuffers,
                  io: _PrefillIO) -> None:
    """Prefill ``io.tokens``, quantize its cache block and write it into
    slot ``io.slot`` of ``buf`` (position ``io.last + 1``, last token the
    first greedy one, also in ``io.tok0``).  Positions past the prompt
    keep the previous occupant's stale entries: attention masks them until
    this occupant overwrites them token by token."""
    logits, cache = model.prefill(weights, {"tokens": io.tokens},
                                  last_index=io.last)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    k, v = cache["k"], cache["v"]            # [L, 1, S, KV, dh]
    if b_kv >= 16:
        kq, vq = k, v
        ksn = vsn = torch.ones(k.shape[:-1], dtype=torch.float32,
                               device=k.device)
    else:
        kq, ksn = kv_quantize(k, b_kv)
        vq, vsn = kv_quantize(v, b_kv)
    s = k.shape[2]
    for dst, src in ((buf.k_codes, kq), (buf.v_codes, vq),
                     (buf.k_scales, ksn), (buf.v_scales, vsn)):
        dst[:, :, :s].index_copy_(1, io.slot, src.to(dst.dtype))
    buf.pos.index_copy_(0, io.slot, cache["len"])
    buf.tok.index_copy_(0, io.slot, tok0)
    io.tok0.copy_(tok0)


@torch.no_grad()
def _decode_step(model, b_kv: int, weights, buf: _SlotBuffers,
                 io: _StepIO) -> None:
    """One greedy decode step over every slot of ``buf``: the tokens go to
    column ``io.step`` of ``io.out`` and into ``buf.tok``, positions
    advance, ``io.eos_hit`` marks rows that emitted ``io.eos``.  Dead slots
    still compute, but every op is row-independent, so nothing escapes
    their row."""
    logits, qc = model.decode_step_q(
        weights, {"k_codes": buf.k_codes, "v_codes": buf.v_codes,
                  "k_scales": buf.k_scales, "v_scales": buf.v_scales,
                  "len": buf.pos},
        {"token": buf.tok[:, None], "pos": buf.pos}, b_kv=b_kv)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    io.out.index_copy_(1, io.step, nxt[:, None])
    io.eos_hit.logical_or_(nxt == io.eos)
    buf.tok.copy_(nxt)
    buf.pos.copy_(qc["len"])
    io.step.add_(1)


def _decode_chunk(step: Callable[[], Any], io: _StepIO, live: np.ndarray,
                  n_steps: int):
    """Up to ``n_steps`` calls of ``step`` (a graph's replay, or the eager
    closure); returns (token block [B, _CHUNK] int32 on the device, steps
    run).  With an eos id the chunk ends early once every live row has
    emitted it (one flag read back per step); otherwise nothing is read
    back between steps."""
    io.out.zero_()
    io.step.zero_()
    io.eos_hit.zero_()
    steps = 0
    while steps < n_steps:
        step()
        steps += 1
        if io.eos_exit and not np.any((live > 0)
                                      & ~io.eos_hit.cpu().numpy()):
            break
    return io.out, steps


@torch.no_grad()
def _spec_draft_step(model, b_kv: int, weights, io: _SpecIO) -> None:
    """One greedy draft step under the draft weights over the scratch copy
    of the block: its tokens go to column ``io.di`` of ``io.drafts``.  The
    scratch's positions run past a row's budget (and, clamped to T - 1 by
    ``decode_step_q``, past the cache); those drafts are never compared."""
    kc, vc, ks, vs, pos, tok = io.scratch
    logits, qc = model.decode_step_q(
        weights, {"k_codes": kc, "v_codes": vc, "k_scales": ks,
                  "v_scales": vs, "len": pos},
        {"token": tok[:, None], "pos": pos}, b_kv=b_kv)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    io.drafts.index_copy_(1, io.di, nxt[:, None])
    tok.copy_(nxt)
    pos.copy_(qc["len"])
    io.di.add_(1)


@torch.no_grad()
def _spec_verify_step(model, b_kv: int, weights, buf: _SlotBuffers,
                      io: _SpecIO) -> None:
    """One iteration of the reference's verify loop under the target
    weights, in place on the canonical block.

    Every row steps ``decode_step_q`` from its current token (exactly the
    batch-1 reference's next step); an inactive row's written entries (at
    its write position, clamped to T - 1) are restored from the copy taken
    before the step and its position and token held, so the buffers equal
    the reference's functional ``where(act, new, old)`` at every position.
    Then the reference's bookkeeping: emission column ``i`` for every row,
    counts, the accepted prefix, and a row goes inactive at a rejected
    draft, the bonus token (``i == n_draft``), eos or its budget.
    """
    rows = torch.arange(buf.pos.shape[0], device=buf.pos.device)
    at = torch.clamp(buf.pos, max=buf.t_bucket - 1)
    state = [buf.k_codes, buf.v_codes, buf.k_scales, buf.v_scales]
    saved = [t[:, rows, at] for t in state]
    logits, qc = model.decode_step_q(
        weights, {"k_codes": buf.k_codes, "v_codes": buf.v_codes,
                  "k_scales": buf.k_scales, "v_scales": buf.v_scales,
                  "len": buf.pos},
        {"token": buf.tok[:, None], "pos": buf.pos}, b_kv=b_kv)
    g = torch.argmax(logits, dim=-1).to(torch.int32)
    act = io.act
    for t, old in zip(state, saved):
        keep = act.reshape((1, -1) + (1,) * (old.dim() - 2))
        t[:, rows, at] = torch.where(keep, t[:, rows, at], old)
    buf.pos.copy_(torch.where(act, qc["len"], buf.pos))
    buf.tok.copy_(torch.where(act, g, buf.tok))
    io.out.index_copy_(1, io.i, g[:, None])
    io.cnt.add_(act.to(torch.int32))
    draft_i = io.drafts.index_select(
        1, torch.clamp(io.i, max=_SPEC_MAX_K - 1))[:, 0]
    match = (io.i < io.n_draft) & (g == draft_i)
    io.acc.add_((act & match).to(torch.int32))
    io.act.copy_(act & match & (g != io.eos) & (io.cnt < io.rem))
    io.any_act.copy_(torch.any(io.act).reshape(1))
    io.i.add_(1)


def _spec_draft_chain(draft: Optional[Callable[[], Any]],
                      buf: _SlotBuffers, io: _SpecIO, n_draft: int) -> None:
    """Copy the block into the scratch and run ``draft`` (a graph's replay
    or the eager closure) ``n_draft`` times; nothing is read back."""
    io.drafts.zero_()
    io.di.zero_()
    if n_draft:
        for dst, src in zip(io.scratch, buf.canonical()):
            dst.copy_(src)
        for _ in range(n_draft):
            draft()


def _spec_verify_chain(verify: Callable[[], Any], io: _SpecIO,
                       live: np.ndarray, rem: np.ndarray, n_draft: int,
                       read_flags: bool = True) -> int:
    """The reference's verify loop over ``io.drafts``: ``verify`` runs
    while its counter is at most ``n_draft`` and any row is active (one
    flag read back per step), or, with ``read_flags=False``, a fixed
    ``n_draft + 1`` times (the extra steps find no row active and change
    no bit).  Returns the steps run; the delivered block, counts and
    accepted prefixes stay in ``io``."""
    io.out.zero_()
    io.cnt.zero_()
    io.acc.zero_()
    io.i.zero_()
    io.act.copy_(torch.from_numpy(np.asarray(live) > 0))
    io.rem.copy_(torch.from_numpy(np.asarray(rem, np.int32)))
    io.n_draft.fill_(int(n_draft))
    steps = 0
    while steps <= n_draft:
        verify()
        steps += 1
        if read_flags and not bool(io.any_act):
            break
    return steps


def _spec_round(draft, verify, buf: _SlotBuffers, live: np.ndarray,
                rem: np.ndarray, n_draft: int, read_flags: bool = True):
    """One speculative round: the draft chain, then the verify chain.
    Returns (delivered block [B, _SPEC_MAX_K + 1], emitted [B], accepted
    [B]) as host arrays, and the verify steps run."""
    io = buf.spec_io()
    _spec_draft_chain(draft, buf, io, n_draft)
    steps = _spec_verify_chain(verify, io, live, rem, n_draft, read_flags)
    return (io.out.cpu().numpy(), io.cnt.cpu().numpy(),
            io.acc.cpu().numpy(), steps)


def _small_written(buf: _SlotBuffers) -> List[torch.Tensor]:
    """What the block's graphs write besides its caches (the canonical
    block's and the speculative scratch's codes and scales): positions,
    tokens and the graphs' I/O, bytes to kilobytes."""
    caches = buf.canonical()[:4] + (buf._spec_io.scratch[:4]
                                    if buf._spec_io is not None else [])
    return [t for t in buf.written() if not any(t is c for c in caches)]


def _save_entries(buf: _SlotBuffers, caches: List[torch.Tensor],
                  pos: torch.Tensor) -> Callable[[], None]:
    """Save what a token step writes: each row's cache entries at its
    write position ``min(pos, T - 1)`` and the block's small tensors;
    returns the closure that puts them back (its ``nbytes``: the bytes
    saved)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    at = torch.clamp(pos, max=buf.t_bucket - 1).long()
    entries = [t[:, rows, at] for t in caches]
    smalls = _small_written(buf)
    small = [t.clone() for t in smalls]

    def restore():
        for t, v in zip(caches, entries):
            t[:, rows, at] = v
        for t, v in zip(smalls, small):
            t.copy_(v)
    restore.nbytes = sum(v.numel() * v.element_size()
                         for v in entries + small)
    return restore


def _save_prefill(buf: _SlotBuffers, io: _PrefillIO) -> Callable[[], None]:
    """Save what a prefill writes: the slot's cache rows up to its prompt
    bucket and the block's small tensors; returns the closure that puts
    them back (its ``nbytes``: the bytes saved)."""
    s, slot = io.tokens.shape[1], io.slot.clone()
    caches = buf.canonical()[:4]
    entries = [t[:, :, :s].index_select(1, slot) for t in caches]
    smalls = _small_written(buf)
    small = [t.clone() for t in smalls]

    def restore():
        for t, v in zip(caches, entries):
            t[:, :, :s].index_copy_(1, slot, v)
        for t, v in zip(smalls, small):
            t.copy_(v)
    restore.nbytes = sum(v.numel() * v.element_size()
                         for v in entries + small)
    return restore


def _capture(cache: CompiledForwardCache, run, buf: _SlotBuffers, keep,
             save: Callable[[], Callable[[], None]]):
    """``run`` as a :class:`CapturedCall`.  On the card the capture's eager
    warm-up run is a real prefill or step, so what it writes is saved
    first (``save()``: the entries at the rows' write positions or the
    prefilled slot's rows, and the small tensors, not a copy of the
    block) and put back after it: a capture never changes the slots it
    ran on."""
    if buf.device.type != "cuda":
        return CapturedCall(run, buf.device, keep=keep)
    restore = save()
    entry = CapturedCall(run, buf.device, cache.pool(), keep=keep)
    restore()
    return entry


def _prefill_call(cache, model, b_kv: int, weights, buf: _SlotBuffers,
                  s_bucket: int) -> CapturedCall:
    io = buf.prefill_io(s_bucket)
    return _capture(cache, lambda: _prefill_slot(model, b_kv, weights, buf,
                                                 io),
                    buf, keep=(model, weights, buf),
                    save=lambda: _save_prefill(buf, io))


def _step_call(cache, model, b_kv: int, weights,
               buf: _SlotBuffers) -> CapturedCall:
    return _capture(cache, lambda: _decode_step(model, b_kv, weights, buf,
                                                buf.step_io),
                    buf, keep=(model, weights, buf),
                    save=lambda: _save_entries(buf, buf.canonical()[:4],
                                               buf.pos))


def _spec_draft_call(cache, model, b_kv: int, weights,
                     buf: _SlotBuffers) -> CapturedCall:
    io = buf.spec_io()
    return _capture(cache, lambda: _spec_draft_step(model, b_kv, weights,
                                                    io),
                    buf, keep=(model, weights, buf),
                    save=lambda: _save_entries(buf, io.scratch[:4],
                                               io.scratch[4]))


def _spec_verify_call(cache, model, b_kv: int, weights,
                      buf: _SlotBuffers) -> CapturedCall:
    io = buf.spec_io()
    return _capture(cache, lambda: _spec_verify_step(model, b_kv, weights,
                                                     buf, io),
                    buf, keep=(model, weights, buf),
                    save=lambda: _save_entries(buf, buf.canonical()[:4],
                                               buf.pos))


def _spec_key(kind: str, model, weights, buf: _SlotBuffers,
              b_kv: int) -> tuple:
    """A draft (``"spec-draft"``, keyed on the draft tree) or verify
    (``"spec-verify"``) step's key, extended as :func:`_step_key` is."""
    return (kind, model.cfg, buf.pos.shape[0], buf.t_bucket, b_kv,
            id(model), tree_key(weights), id(buf))


def _prefill_key(model, weights, buf: _SlotBuffers, s_bucket: int,
                 b_kv: int) -> tuple:
    return ("decode-prefill", model.cfg, s_bucket, buf.t_bucket,
            buf.pos.shape[0], b_kv, id(model), tree_key(weights), id(buf))


def _step_key(model, weights, buf: _SlotBuffers, b_kv: int) -> tuple:
    return ("decode-fused", model.cfg, buf.pos.shape[0], buf.t_bucket, b_kv,
            id(model), tree_key(weights), id(buf))


# ---------------------------------------------------------------------------
# engine internals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ClassState:
    """One QoS class's resolved operating point."""
    qos: QosClass
    b_hat: int
    b_eff: float                # mean agent bits (= b_hat when uniform)
    b_kv: int
    f: float
    f_server: float
    plan_key: tuple             # keys the materialized weight tree
    plan_bits: tuple
    solution: Any = None        # DecodeSolution when solved


@dataclasses.dataclass
class _Active:
    """One in-flight request occupying a decode slot."""
    req: DecodeRequest
    generated: List[int]
    admitted_s: float
    ttft_s: float
    last_emit_s: float
    itls: List[float]
    on_token: Optional[Callable]


class _Group(_SlotBuffers):
    """One (QoS class, cache bucket) slot block of ``max_batch`` slots.
    Inactive rows hold pos = 0 / token = 0 and compute garbage that never
    escapes the row; the next admission overwrites the prompt span before
    position 0 is attended."""

    def __init__(self, cfg, qos_name: str, t_bucket: int, max_batch: int,
                 b_kv: int, device, eos: int):
        super().__init__(cfg, t_bucket, max_batch, b_kv, device, eos)
        self.qos_name = qos_name
        self.slots: List[Optional[_Active]] = [None] * max_batch
        self.barrier_open = True

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """Continuous-batching greedy decode over quantized KV-cache slots.

    Per class, ``auto=True`` runs one memoized ``solve_decode`` for
    (b̂, f, f̃, b_kv), or with ``mixed_precision`` one
    ``solve_decode_mixed`` for (per-layer bits, f, f̃, b_kv); the class's
    agent partition is then materialized
    once as a fake-quantized weight tree (``runtime.qat``), shared by
    classes with the same plan.  An infeasible class raises
    ``ValueError``.  ``auto=False`` pins b̂ = 8 / b_kv = 8 at the maximum
    frequencies until :meth:`set_operating_point` says otherwise.
    ``admission`` is ``"continuous"`` or ``"barrier"``; ``eos_id`` retires
    a request at its first emission of that token.  Prefills and token
    steps run through ``compile_cache`` (one CUDA graph per variant on the
    card; shared with other engines or the oracle when passed in), and
    :meth:`warmup` captures them up front.  Runs on the CUDA card unless
    ``device="cpu"`` is asked for.
    """

    def __init__(self, model, params, sysp: SystemParams, *,
                 classes: Sequence[QosClass],
                 max_batch: int = 4,
                 max_new_tokens: int = 16,
                 admission: str = "continuous",
                 mixed_precision: bool = False,
                 kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                 kv_weight: float = 1.0,
                 b_emb: Optional[int] = None,
                 auto: bool = True,
                 lam: Optional[float] = None,
                 lam_kv: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 codesign_cache: Optional[CodesignCache] = None,
                 compile_cache: Optional[CompiledForwardCache] = None,
                 seq_bucket_base: int = DEFAULT_SEQ_BASE,
                 tracer=None, metrics=None, device=None):
        gap = decode_protocol_gap(model)
        if gap is not None:
            raise TypeError(f"{type(model).__name__} {gap}; the decode "
                            "engine needs the DecoderLM decode protocol")
        if admission not in ("continuous", "barrier"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if not classes:
            raise ValueError("need at least one QoS class")
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        set_float32_numerics()
        self.model = model
        self.cfg = model.cfg
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.sysp = sysp
        self.split = self.cfg.split_layer
        self.max_batch = int(max_batch)
        self.max_new_tokens = int(max_new_tokens)
        self.admission = admission
        self.mixed_precision = bool(mixed_precision)
        self.kv_ladder = tuple(int(b) for b in kv_ladder)
        self.kv_weight = float(kv_weight)
        self.b_emb = b_emb
        self.eos_id = int(eos_id) if eos_id is not None else None
        self.seq_bucket_base = int(seq_bucket_base)
        self._axes = model.logical_axes()
        self.lam = float(lam) if lam is not None \
            else fit_lambda(self.params, self.split)
        self.lam_kv = float(lam_kv) if lam_kv is not None \
            else fit_kv_lambda(model, self.params)
        self.codesign_cache = codesign_cache if codesign_cache is not None \
            else CodesignCache()
        self.compile_cache = compile_cache if compile_cache is not None \
            else CompiledForwardCache()
        # the no-op singletons by default: an uninstrumented engine pays
        # nothing on the decode path
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._own_hits = self._own_misses = 0
        self._own_compile_hits = self._own_compile_misses = 0
        self._weights: Dict[tuple, Any] = {}
        self._layer_stats: Optional[mp.LayerStats] = None
        self._classes: Dict[str, Optional[_ClassState]] = {}
        self._groups: Dict[tuple, _Group] = {}
        self._rr: List[tuple] = []          # round-robin group order
        self._queue: List[DecodeRequest] = []
        self._on_token: Dict[int, Optional[Callable]] = {}
        self._next_rid = 0
        self._clock = 0.0
        self._energy = 0.0
        self._prefills = 0
        self._rounds = 0
        self._served = 0
        self._cancelled = 0
        self._tokens_out = 0
        self._kv_bytes = 0
        self._kv_bytes_full = 0
        self._h2d = 0
        self._d2h = 0
        self._class_lat: Dict[str, Dict[str, list]] = {}
        for c in classes:
            if auto:
                self._resolve_class(c)
            else:
                self._classes[c.name] = None
                self.set_operating_point(c.name, 8, 8, qos=c)
            self._class_lat[c.name] = {"ttft": [], "itl": [], "tokens": []}

    # ------------------------------------------------------------------
    # operating points
    # ------------------------------------------------------------------
    def flop_split(self, tokens: int):
        """(agent_flops, server_flops) for ``tokens`` positions."""
        per_layer = self.cfg.active_param_count() / max(self.cfg.n_layers, 1)
        n_agent = 2.0 * per_layer * self.split * tokens
        n_server = 2.0 * per_layer * (self.cfg.n_layers - self.split) \
            * tokens
        return n_agent, n_server

    def layer_stats(self) -> mp.LayerStats:
        """Per-agent-layer (λ^(l), A^(l)) on the engine's device, memoized."""
        if self._layer_stats is None:
            self._layer_stats = mp.decoder_layer_stats(self.params,
                                                       self.split)
        return self._layer_stats

    def _resolve_class(self, c: QosClass) -> None:
        h0, m0 = self.codesign_cache.hits, self.codesign_cache.misses
        b_max = int(self.sysp.b_full)
        if self.mixed_precision:
            sol = self.codesign_cache.solve_decode_mixed(
                self.layer_stats(), self.lam_kv, self.sysp, c, b_max,
                b_emb=self.b_emb, kv_ladder=self.kv_ladder,
                kv_weight=self.kv_weight)
        else:
            sol = self.codesign_cache.solve_decode(
                self.lam, self.lam_kv, self.sysp, c, b_max,
                b_emb=self.b_emb, kv_ladder=self.kv_ladder,
                kv_weight=self.kv_weight)
        dh = self.codesign_cache.hits - h0
        dm = self.codesign_cache.misses - m0
        self._own_hits += dh
        self._own_misses += dm
        if dh:
            self.metrics.counter("codesign.cache_hits",
                                 engine="DecodeEngine", qos=c.name).inc(dh)
        if dm:
            self.metrics.counter("codesign.cache_misses",
                                 engine="DecodeEngine", qos=c.name).inc(dm)
        if sol is None:
            raise ValueError(
                f"QoS class {c.name!r} (T0={c.t0}, E0={c.e0}) is "
                "infeasible at every KV-cache bit-width "
                f"{self.kv_ladder}")
        target = mp.plan_from_bits(sol.inner.bits) \
            if self.mixed_precision else sol.b_hat
        self._classes[c.name] = None
        self.set_operating_point(c.name, target, sol.b_kv, f=sol.f,
                                 f_server=sol.f_server, qos=c,
                                 solution=sol)

    def set_operating_point(self, qos_name: str, target, b_kv: int, *,
                            f: Optional[float] = None,
                            f_server: Optional[float] = None,
                            qos: Optional[QosClass] = None,
                            solution=None) -> None:
        """Pin a class's (weights bit target, b_kv, frequencies).

        ``target`` is a uniform b̂ or a :class:`QuantPlan` over the agent
        partition.  Call it before the class's first admission: live
        slots hold caches made under the previous weights.
        """
        if qos is None:
            prev = self._classes.get(qos_name)
            if prev is None:
                raise KeyError(f"unknown QoS class {qos_name!r}")
            qos = prev.qos
        b_kv = int(b_kv)
        if b_kv < 2:
            raise ValueError(f"b_kv={b_kv} below the 2-bit floor")
        if isinstance(target, QuantPlan):
            plan_key = target.key()
            b_eff = float(target.mean_bits(self.split))
            b_hat = int(round(b_eff))
            plan_bits = tuple(target.layer_bit_list(self.split))
            qcfg: Any = target
        else:
            b_hat = int(target)
            b_eff = float(b_hat)
            plan_key = ("uniform", b_hat)
            plan_bits = ()
            qcfg = QuantConfig(bits=b_hat, scheme="uniform",
                               granularity="per-channel")
        if plan_key not in self._weights:
            self._weights[plan_key] = fake_quantize_agent(
                self.params, self._axes, self.cfg, qcfg, ste=False)
        self._classes[qos_name] = _ClassState(
            qos=qos, b_hat=b_hat, b_eff=b_eff, b_kv=b_kv,
            f=float(f) if f is not None else self.sysp.f_max,
            f_server=float(f_server) if f_server is not None
            else self.sysp.f_server_max,
            plan_key=plan_key, plan_bits=plan_bits, solution=solution)

    def solution_for(self, qos_name: str):
        """The class's decode codesign solution (None when pinned)."""
        return self._classes[qos_name].solution

    def b_kv_for(self, qos_name: str) -> int:
        return self._classes[qos_name].b_kv

    def class_params(self, qos_name: str):
        """The class's fake-quantized weight tree: what the sequential
        reference must decode with for parity."""
        return self._weights[self._classes[qos_name].plan_key]

    # ------------------------------------------------------------------
    # captured calls
    # ------------------------------------------------------------------
    def _cached(self, key: tuple, build: Callable, plan: str, bucket: str):
        """The captured call for ``key`` through the compile cache; a miss
        is one capture, traced as ``forward.capture`` and timed under its
        (plan, bucket) tags."""
        cc = self.compile_cache
        h0, m0 = cc.hits, cc.misses
        if key in cc:
            exe = cc.get(key, build)
        else:
            with self.tracer.span("forward.capture", plan=plan,
                                  bucket=bucket):
                t0 = time.monotonic()
                exe = cc.get(key, build)
                self.metrics.histogram(
                    "compile.seconds", plan=plan,
                    bucket=bucket).observe(time.monotonic() - t0)
        dh, dm = cc.hits - h0, cc.misses - m0
        self._own_compile_hits += dh
        self._own_compile_misses += dm
        if dh:
            self.metrics.counter("compile.cache_hits",
                                 engine="DecodeEngine").inc(dh)
        if dm:
            self.metrics.counter("compile.cache_misses",
                                 engine="DecodeEngine").inc(dm)
        return exe

    def _prefill_exe(self, c: _ClassState, g: _Group, s_bucket: int):
        w = self._weights[c.plan_key]
        return self._cached(
            _prefill_key(self.model, w, g, s_bucket, c.b_kv),
            lambda: _prefill_call(self.compile_cache, self.model, c.b_kv, w,
                                  g, s_bucket),
            plan=f"decode-prefill/bkv{c.b_kv}",
            bucket=f"{s_bucket}->{g.t_bucket}x{self.max_batch}")

    def _decode_exe(self, c: _ClassState, g: _Group):
        w = self._weights[c.plan_key]
        return self._cached(
            _step_key(self.model, w, g, c.b_kv),
            lambda: _step_call(self.compile_cache, self.model, c.b_kv, w, g),
            plan=f"decode-fused/bkv{c.b_kv}",
            bucket=f"{g.t_bucket}x{self.max_batch}")

    def warmup(self, max_prompt: int, max_new: Optional[int] = None) -> int:
        """Capture every reachable variant; returns the number of captures
        this triggered (on the CPU: cache entries made).  For each class:
        one token step per cache bucket of the ladder up to ``max_prompt +
        max_new``, and one prefill per (prompt bucket s, cache bucket t)
        pair with s <= t (the scatter makes the slot block part of the
        graph), as the reference's warm-up compiles.  After a warm-up
        covering the traffic's bounds, serving never captures."""
        m0 = self._own_compile_misses
        mn = int(max_new) if max_new is not None else self.max_new_tokens
        t_rungs = seq_ladder(max_prompt + mn, self.seq_bucket_base)
        for name, c in self._classes.items():
            for t in t_rungs:
                self._decode_exe(c, self._group(name, t))
            for s in seq_ladder(max_prompt, self.seq_bucket_base):
                for t in t_rungs:
                    if t >= s:
                        self._prefill_exe(c, self._group(name, t), s)
        return self._own_compile_misses - m0

    # ------------------------------------------------------------------
    # queue API
    # ------------------------------------------------------------------
    def submit(self, tokens, qos: str,
               max_new_tokens: Optional[int] = None,
               arrival_s: Optional[float] = None,
               on_token: Optional[Callable] = None) -> int:
        """Queue a prompt; returns its request id.  ``on_token(request_id,
        token, t_s)`` streams each generated token at its virtual
        emission time."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty prompt")
        if qos not in self._classes:
            raise KeyError(f"unknown QoS class {qos!r}")
        m = int(max_new_tokens) if max_new_tokens is not None \
            else self.max_new_tokens
        if m < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        arr = float(arrival_s) if arrival_s is not None else self._clock
        self._queue.append(DecodeRequest(
            request_id=rid, tokens=toks, qos=qos, max_new_tokens=m,
            arrival_s=arr))
        self._on_token[rid] = on_token
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return sum(g.active_count() for g in self._groups.values())

    @property
    def clock_s(self) -> float:
        return self._clock

    def request_bucket(self, req: DecodeRequest) -> int:
        """A request's cache bucket: a function of its OWN prompt length
        and budget, never of its batch-mates."""
        return int(seq_bucket(req.tokens.size + req.max_new_tokens,
                              self.seq_bucket_base))

    def cancel(self, request_id: int) -> Optional[DecodeResponse]:
        """Retire a request mid-decode (or drop it from the queue); frees
        the slot at once and returns the partial response, or None if the
        id is unknown or already retired."""
        for i, r in enumerate(self._queue):
            if r.request_id == request_id:
                del self._queue[i]
                self._cancelled += 1
                self._on_token.pop(request_id, None)
                return DecodeResponse(
                    request_id=request_id, qos=r.qos,
                    tokens=np.zeros((0,), np.int32),
                    prompt_len=r.tokens.size,
                    b_kv=self._classes[r.qos].b_kv,
                    ttft_s=float("nan"), itl_mean_s=0.0,
                    finished_s=self._clock, cancelled=True)
        for g in self._groups.values():
            for i, act in enumerate(g.slots):
                if act is not None and act.req.request_id == request_id:
                    return self._retire(g, i, cancelled=True)
        return None

    def fast_forward(self, t_s: float) -> None:
        """Advance the virtual clock to ``t_s`` (never backwards)."""
        self._clock = max(self._clock, float(t_s))

    def decode_round_cost(self, qos_name: str, t_bucket: int):
        """(seconds, joules) of one decode step for the class at cache
        bucket ``t_bucket``."""
        return self._round_cost(self._classes[qos_name], int(t_bucket))

    def snapshot_request(self, request_id: int) -> Optional[dict]:
        """Freeze one in-flight request into a host-side snapshot the
        batch-1 reference resumes bitwise: the serving supervisor's
        crash-recovery hook.

        The slot's slice of its block (codes and scales [L, 1, T, KV, dh]
        and [L, 1, T, KV], its position and last token) is the
        reference's batch-width-1 state, since every step is
        row-independent, so ``greedy_decode_reference(state=...)``
        continues it token for token.  One device-to-host copy per tensor,
        counted in the report's ``d2h_bytes``.  Returns None for unknown,
        still-queued or already-retired ids: only in-flight requests have
        cache state to save."""
        for g in self._groups.values():
            for slot, act in enumerate(g.slots):
                if act is None or act.req.request_id != request_id:
                    continue
                c = self._classes[act.req.qos]
                sl = slice(slot, slot + 1)
                state = {
                    "k_codes": g.k_codes[:, sl].cpu().numpy(),
                    "v_codes": g.v_codes[:, sl].cpu().numpy(),
                    "k_scales": g.k_scales[:, sl].cpu().numpy(),
                    "v_scales": g.v_scales[:, sl].cpu().numpy(),
                    "pos": np.int32(int(g.pos[slot])),
                    "last_token": np.int32(int(g.tok[slot])),
                    "t_bucket": np.int32(g.t_bucket),
                }
                self._d2h += sum(v.nbytes for v in state.values())
                return {"request": act.req, "qos": act.req.qos,
                        "b_kv": c.b_kv, "generated": list(act.generated),
                        "ttft_s": act.ttft_s, "itls": list(act.itls),
                        "last_emit_s": act.last_emit_s,
                        "t_bucket": int(g.t_bucket), "state": state}
        return None

    # ------------------------------------------------------------------
    # the decode loop
    # ------------------------------------------------------------------
    def step(self, max_decode_steps: Optional[int] = None) \
            -> List[DecodeResponse]:
        """One engine round: admit what the policy allows, then run one
        decode chunk for the next non-empty slot block (round-robin).
        Returns the requests that retired.  ``max_decode_steps`` caps the
        chunk; 1 gives one token per round."""
        out: List[DecodeResponse] = []
        if self.in_flight == 0 and self._queue:
            nxt = min(r.arrival_s for r in self._queue)
            if nxt > self._clock:
                self._clock = nxt         # fast-forward an idle engine
        self._admit(out)
        g = self._next_group()
        if g is not None:
            self._decode_round(g, out, max_decode_steps)
        return out

    def drain(self) -> List[DecodeResponse]:
        out: List[DecodeResponse] = []
        while self._queue or self.in_flight:
            out.extend(self.step())
        return out

    def _group(self, qos: str, t_bucket: int) -> _Group:
        """The class's slot block at ``t_bucket`` (at its current b_kv),
        made on first use; :meth:`warmup` makes them ahead of traffic."""
        b_kv = self._classes[qos].b_kv
        key = (qos, int(t_bucket), b_kv)
        if key not in self._groups:
            self._groups[key] = _Group(
                self.cfg, qos, t_bucket, self.max_batch, b_kv, self.device,
                self.eos_id if self.eos_id is not None else -1)
        return self._groups[key]

    def _group_for(self, req: DecodeRequest) -> _Group:
        g = self._group(req.qos, self.request_bucket(req))
        key = (req.qos, g.t_bucket, self._classes[req.qos].b_kv)
        if key not in self._rr:
            self._rr.append(key)        # round-robin in order of first use
        return g

    def _admit(self, out: List[DecodeResponse]) -> None:
        admitted = True
        while admitted:
            admitted = False
            for qi, req in enumerate(self._queue):
                if req.arrival_s > self._clock:
                    continue
                g = self._group_for(req)
                if self.admission == "barrier" and not g.barrier_open:
                    continue
                slot = g.free_slot()
                if slot is None:
                    continue
                del self._queue[qi]
                self._prefill_into(g, slot, req, out)
                admitted = True
                break
        if self.admission == "barrier":
            for g in self._groups.values():
                if g.active_count() > 0:
                    g.barrier_open = False

    def _prefill_into(self, g: _Group, slot: int, req: DecodeRequest,
                      out: List[DecodeResponse]) -> None:
        c = self._classes[req.qos]
        p_len = req.tokens.size
        s_bucket = int(seq_bucket(p_len, self.seq_bucket_base))
        self.tracer.instant("decode.admit", rid=req.request_id,
                            qos=req.qos, slot=slot, prompt_len=p_len,
                            t_bucket=g.t_bucket)
        padded = np.zeros((1, s_bucket), np.int32)
        padded[0, :p_len] = req.tokens
        exe = self._prefill_exe(c, g, s_bucket)
        with self.tracer.span("decode.prefill", rid=req.request_id,
                              qos=req.qos, s_bucket=s_bucket,
                              t_bucket=g.t_bucket):
            first = _run_prefill(exe, g.prefill_io(s_bucket), padded,
                                 p_len, slot)
        # the interface's traffic: the padded prompt and two scalars in,
        # the first token out
        self._h2d += padded.nbytes + 8
        self._d2h += 4
        # bill the prefill at its bucketed workload on the virtual clock
        t_pre, e_pre = self._prefill_cost(c, s_bucket)
        self._clock += t_pre
        self._energy += e_pre
        self._prefills += 1
        shape = (self.cfg.n_layers, 1, g.t_bucket, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        self._kv_bytes += 2 * kv_cache_bytes(shape, c.b_kv)
        self._kv_bytes_full += int(2 * np.prod(shape)
                                   * self.sysp.b_full / 8.0)
        act = _Active(req=req, generated=[first],
                      admitted_s=self._clock,
                      ttft_s=self._clock - req.arrival_s,
                      last_emit_s=self._clock, itls=[],
                      on_token=self._on_token.pop(req.request_id, None))
        g.slots[slot] = act
        m = self.metrics
        if m.enabled:
            m.counter("decode.prefills", engine="DecodeEngine",
                      qos=req.qos).inc()
            m.counter("decode.h2d_bytes",
                      engine="DecodeEngine").inc(padded.nbytes + 8)
            m.counter("decode.d2h_bytes", engine="DecodeEngine").inc(4)
            m.histogram("decode.ttft_s", engine="DecodeEngine",
                        qos=req.qos).observe(act.ttft_s)
        if act.on_token is not None:
            act.on_token(req.request_id, first, self._clock)
        if len(act.generated) >= req.max_new_tokens:
            out.append(self._retire(g, slot))

    def _next_group(self) -> Optional[_Group]:
        for _ in range(len(self._rr)):
            key = self._rr.pop(0)
            self._rr.append(key)
            g = self._groups[key]
            if g.active_count() > 0:
                return g
        return None

    def _chunk_steps(self, g: _Group, t_round: float,
                     max_steps: Optional[int]) -> int:
        """Steps this chunk may run: the tightest of the live slots'
        remaining budgets, the next queued arrival, the block width and
        the caller's cap."""
        rem = min(a.req.max_new_tokens - len(a.generated)
                  for a in g.slots if a is not None)
        k = max(1, min(rem, _CHUNK))
        future = [r.arrival_s for r in self._queue
                  if r.arrival_s > self._clock]
        if future:
            due = (min(future) - self._clock) / max(t_round, 1e-12)
            k = min(k, max(1, int(math.ceil(due))))
        if max_steps is not None:
            k = min(k, max(1, int(max_steps)))
        return k

    def _decode_round(self, g: _Group, out: List[DecodeResponse],
                      max_steps: Optional[int] = None) -> None:
        c = self._classes[g.qos_name]
        t_round, e_round = self._round_cost(c, g.t_bucket)
        k = self._chunk_steps(g, t_round, max_steps)
        live = np.zeros((self.max_batch,), np.int32)
        live_rows = [i for i, a in enumerate(g.slots) if a is not None]
        live[live_rows] = 1
        exe = self._decode_exe(c, g)
        with self.tracer.span("decode.chunk", qos=g.qos_name,
                              live_rows=len(live_rows),
                              t_bucket=g.t_bucket, max_steps=k):
            blk, steps = _decode_chunk(exe, g.step_io, live, k)
            blk = blk.cpu().numpy()
        # the interface's traffic, independent of the cache size: the live
        # mask and two scalars in, the token block and step count out
        self._h2d += live.nbytes + 8
        self._d2h += blk.nbytes + 4
        m = self.metrics
        if m.enabled:
            m.counter("decode.chunks", engine="DecodeEngine",
                      qos=g.qos_name).inc()
            m.counter("decode.chunk_steps", engine="DecodeEngine",
                      qos=g.qos_name).inc(steps)
            m.counter("decode.h2d_bytes",
                      engine="DecodeEngine").inc(live.nbytes + 8)
            m.counter("decode.d2h_bytes",
                      engine="DecodeEngine").inc(blk.nbytes + 4)
            m.gauge("decode.live_rows", engine="DecodeEngine",
                    qos=g.qos_name).set(len(live_rows))
        clock0 = self._clock
        self._clock += steps * t_round
        self._energy += steps * e_round
        self._rounds += steps
        finished: List[int] = []
        done = set()
        for j in range(steps):
            t_emit = clock0 + (j + 1) * t_round
            for i in live_rows:
                if i in done:
                    continue
                act = g.slots[i]
                tok_ij = int(blk[i, j])
                act.generated.append(tok_ij)
                act.itls.append(t_emit - act.last_emit_s)
                act.last_emit_s = t_emit
                if act.on_token is not None:
                    act.on_token(act.req.request_id, tok_ij, t_emit)
                if (self.eos_id is not None and tok_ij == self.eos_id) \
                        or len(act.generated) >= act.req.max_new_tokens:
                    done.add(i)
                    finished.append(i)
        for i in finished:
            out.append(self._retire(g, i))

    def _retire(self, g: _Group, slot: int,
                cancelled: bool = False) -> DecodeResponse:
        act = g.slots[slot]
        g.slots[slot] = None
        g.pos[slot] = 0
        g.tok[slot] = 0
        if g.active_count() == 0:
            g.barrier_open = True
        c = self._classes[act.req.qos]
        itl = float(np.mean(act.itls)) if act.itls else 0.0
        if cancelled:
            self._cancelled += 1
        else:
            self._served += 1
            lat = self._class_lat[act.req.qos]
            lat["ttft"].append(act.ttft_s)
            lat["itl"].extend(act.itls)
            lat["tokens"].append(len(act.generated))
        self._tokens_out += len(act.generated)
        self.tracer.instant("decode.retire", rid=act.req.request_id,
                            qos=act.req.qos, tokens=len(act.generated),
                            cancelled=cancelled)
        m = self.metrics
        if m.enabled:
            m.counter("decode.retired", engine="DecodeEngine",
                      qos=act.req.qos).inc()
            m.counter("decode.tokens", engine="DecodeEngine",
                      qos=act.req.qos).inc(len(act.generated))
            # per-token ITL, observed in one batch at retirement so the
            # emission loop stays instrument-free
            h = m.histogram("decode.itl_s", engine="DecodeEngine",
                            qos=act.req.qos)
            for v in act.itls:
                h.observe(v)
        return DecodeResponse(
            request_id=act.req.request_id, qos=act.req.qos,
            tokens=np.asarray(act.generated, np.int32),
            prompt_len=act.req.tokens.size, b_kv=c.b_kv,
            ttft_s=act.ttft_s, itl_mean_s=itl,
            finished_s=act.last_emit_s, cancelled=cancelled)

    # ------------------------------------------------------------------
    # billing (float64 on the host)
    # ------------------------------------------------------------------
    def _prefill_cost(self, c: _ClassState, s_bucket: int):
        n_a, n_s = self.flop_split(s_bucket)
        p = dataclasses.replace(self.sysp, n_flop_agent=n_a,
                                n_flop_server=n_s)
        t = float(agent_delay(c.b_eff, c.f, p)) \
            + float(server_delay(c.f_server, p))
        e = float(agent_energy(c.b_eff, c.f, p)) \
            + float(server_energy(c.f_server, p))
        return t, e

    def _round_cost(self, c: _ClassState, t_bucket: int):
        """One decode step over the FULL slot block: all ``max_batch``
        rows and the whole [L, B, T] cache read at b_kv are billed whether
        or not every slot is live."""
        n_a, n_s = self.flop_split(self.max_batch)
        kv_full = 2.0 * self.cfg.n_layers * self.max_batch * t_bucket \
            * self.cfg.n_kv_heads * self.cfg.head_dim \
            * (self.sysp.b_full / 8.0)
        p = dataclasses.replace(self.sysp, n_flop_agent=n_a,
                                n_flop_server=n_s, kv_bytes_full=kv_full)
        t = float(agent_delay(c.b_eff, c.f, p)) \
            + float(server_delay(c.f_server, p)) \
            + float(kv_delay(c.b_kv, p))
        e = float(agent_energy(c.b_eff, c.f, p)) \
            + float(server_energy(c.f_server, p)) \
            + float(kv_energy(c.b_kv, p))
        return t, e

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def report(self) -> DecodeReport:
        classes = []
        for name, c in self._classes.items():
            lat = self._class_lat[name]
            itls = np.asarray(lat["itl"], np.float64)
            classes.append(ClassDecodeStats(
                qos=name, b_hat=c.b_hat, b_kv=c.b_kv,
                requests=len(lat["ttft"]),
                tokens=int(sum(lat["tokens"])),
                ttft_mean_s=float(np.mean(lat["ttft"]))
                if lat["ttft"] else 0.0,
                ttft_max_s=float(np.max(lat["ttft"]))
                if lat["ttft"] else 0.0,
                itl_mean_s=float(np.mean(itls)) if itls.size else 0.0,
                plan_bits=c.plan_bits,
                itl_p50_s=float(np.percentile(itls, 50))
                if itls.size else 0.0,
                itl_p95_s=float(np.percentile(itls, 95))
                if itls.size else 0.0))
        clock = max(self._clock, 1e-12)
        return DecodeReport(
            requests_served=self._served, cancelled=self._cancelled,
            tokens_generated=self._tokens_out, prefills=self._prefills,
            decode_rounds=self._rounds, total_delay_s=self._clock,
            total_energy_j=self._energy,
            throughput_tps=self._tokens_out / clock,
            throughput_rps=self._served / clock,
            admission=self.admission, classes=tuple(classes),
            kv_bytes=self._kv_bytes, kv_bytes_full=self._kv_bytes_full,
            codesign_hits=self._own_hits,
            codesign_misses=self._own_misses,
            compile_hits=self._own_compile_hits,
            compile_misses=self._own_compile_misses,
            compiled_variants=len(self.compile_cache),
            h2d_bytes=self._h2d, d2h_bytes=self._d2h)


# ---------------------------------------------------------------------------
# the non-batched sequential reference
# ---------------------------------------------------------------------------

def _run_prefill(exe, io: _PrefillIO, padded: np.ndarray, p_len: int,
                 slot: int) -> int:
    """Fill a prefill's static inputs, run it, return the first token."""
    io.tokens.copy_(torch.from_numpy(padded))
    io.last.fill_(p_len - 1)
    io.slot.fill_(slot)
    exe()
    return int(io.tok0[0])


def greedy_decode_reference(model, weights, tokens, max_new_tokens: int, *,
                            b_kv: int,
                            seq_bucket_base: int = DEFAULT_SEQ_BASE,
                            reserve_tokens: Optional[int] = None,
                            compile_cache: Optional[
                                CompiledForwardCache] = None,
                            state: Optional[dict] = None,
                            return_state: bool = False,
                            device=None):
    """One request at batch width 1: the parity oracle.

    Decodes ``max_new_tokens`` greedy tokens from ``tokens`` under the
    same bucketing and the same captured prefill-and-scatter and token
    step as :class:`DecodeEngine`, at batch width 1; the engine must
    reproduce it token for token at any batch width, admission order and
    chunking.  ``compile_cache`` memoizes its graphs and its batch-1 slot
    block (a fresh cache by default, so each call captures anew on the
    card); pass the engine's to reuse them across calls.

    ``reserve_tokens`` fixes the cache bucket from a larger planned budget
    (``T = seq_bucket(prompt + reserve)``) so a decode can be split across
    calls: ``return_state=True`` also returns the state as plain numpy
    arrays, and passing it back as ``state`` continues bitwise as the
    uninterrupted run would.  Runs on the CUDA card unless
    ``device="cpu"`` is asked for.
    """
    dev = resolve_device(device)
    set_float32_numerics()
    cfg = model.cfg
    cache = compile_cache if compile_cache is not None \
        else CompiledForwardCache()
    weights = tree_map(lambda a: a.to(dev), weights)
    out: List[int] = []
    if state is None:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        p_len = toks.size
        if p_len == 0:
            raise ValueError("empty prompt")
        t_bucket = int(seq_bucket(
            p_len + (reserve_tokens if reserve_tokens is not None
                     else max_new_tokens), seq_bucket_base))
    else:
        t_bucket = int(state["t_bucket"])
    buf = cache.buffers(("decode-slots", cfg, t_bucket, 1, b_kv, dev),
                        lambda: _SlotBuffers(cfg, t_bucket, 1, b_kv, dev))
    if state is None:
        s_bucket = int(seq_bucket(p_len, seq_bucket_base))
        padded = np.zeros((1, s_bucket), np.int32)
        padded[0, :p_len] = toks
        exe = cache.get(_prefill_key(model, weights, buf, s_bucket, b_kv),
                        lambda: _prefill_call(cache, model, b_kv, weights,
                                              buf, s_bucket))
        out.append(_run_prefill(exe, buf.prefill_io(s_bucket), padded,
                                p_len, 0))
        remaining = max_new_tokens - 1
    else:
        for name in ("k_codes", "v_codes", "k_scales", "v_scales"):
            getattr(buf, name).copy_(torch.from_numpy(
                np.asarray(state[name])))
        buf.pos.fill_(int(state["pos"]))
        buf.tok.fill_(int(state["last_token"]))
        remaining = max_new_tokens
    live = np.ones((1,), np.int32)
    while remaining > 0:
        step = cache.get(_step_key(model, weights, buf, b_kv),
                         lambda: _step_call(cache, model, b_kv, weights,
                                            buf))
        blk, steps = _decode_chunk(step, buf.step_io, live,
                                   min(remaining, _CHUNK))
        out.extend(blk[0, :steps].cpu().tolist())
        remaining -= steps
    result = np.asarray(out, np.int32)
    if return_state:
        return result, {"k_codes": buf.k_codes.cpu().numpy(),
                        "v_codes": buf.v_codes.cpu().numpy(),
                        "k_scales": buf.k_scales.cpu().numpy(),
                        "v_scales": buf.v_scales.cpu().numpy(),
                        "pos": np.int32(int(buf.pos[0])),
                        "last_token": np.int32(int(buf.tok[0])),
                        "t_bucket": np.int32(t_bucket)}
    return result
