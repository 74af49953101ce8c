"""Co-inference serving (paper §II), the sequential and batched engines
(``repro/runtime/serve_engine.py``).

:class:`CoInferenceEngine` serves one batch tensor at a time through the
paper's pipeline: agent stage (embedding + layers ``[0, split)`` at
bit-width b̂) -> uplink quantization of the boundary activation at
``b_emb`` -> server stage (layers ``[split, L)`` at full precision + tied
head), with the (b̂, f, f̃) operating point chosen by ``core.codesign``.
:class:`BatchedCoInferenceEngine` queues requests, groups them by QoS
class, pads them into one forward per batch and amortizes the (P1) solve
through :class:`CodesignCache`; per request it returns what the sequential
engine returns for the request alone.

Agent execution paths:

* ``kernel`` — weights are int8- or int4-resident (``group_quantize`` at
  configure time, one launch for all of them) and every agent matmul
  launches ``qmm``/``qmm_int4``; uniform b̂ ∈ {4, 8} or a per-layer
  :class:`QuantPlan` (container chosen per layer, > 8-bit layers
  fake-quantized);
* ``fake`` — quantize-dequantize at b̂, plain matmuls (and the fallback of
  the kernel path at other uniform widths, as in the reference).

``compiled=True`` pads each token batch to its (batch quantum, sequence
bucket) shape and serves it through one compiled forward per (plan,
bucket) (``fastpath.CompiledForwardCache``): a replayed CUDA graph on the
card, the same closure uncaptured on the CPU.  The engines run on the CUDA
card unless ``device="cpu"`` is asked for; on the CPU every kernel wrapper
runs its plain version.  ``BatchedCoInferenceEngine(mixed_precision=True)``
solves the layer-wise allocation of ``core.mixed_precision`` per QoS class
instead of (P1) and serves each class's :class:`QuantPlan`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Literal, Optional, Sequence

import numpy as np
import torch

from ..core import codesign as cd
from ..core import mixed_precision as mp
from ..core.cost_model import (SystemParams, agent_delay, agent_energy,
                               server_delay, server_energy, transport_delay,
                               transport_energy)
from ..core.quantization import (QuantConfig, QuantPlan, quantize_dequantize,
                                 wire_bytes)
from ..device import resolve_device, set_float32_numerics
from ..kernels import ops as kops
from ..kernels.bucketing import (DEFAULT_SEQ_BASE, next_geometric,
                                 seq_bucket, seq_ladder)
from ..models import layers as L
from ..models.lm import tree_leaves, tree_map
from ..obs import NULL_METRICS, NULL_TRACER, OCCUPANCY_BUCKETS, ReportBase
from . import fastpath as fp
from .qat import fake_quantize_agent


@dataclasses.dataclass(frozen=True)
class ServeStats:
    b_hat: int                  # uniform b̂, or round(mean bits) of a plan
    f: float
    f_server: float
    agent_delay_s: float
    server_delay_s: float
    transport_delay_s: float
    total_delay_s: float
    energy_j: float             # compute + uplink tx energy (eqs. 6-7 + radio)
    transport_energy_j: float   # the uplink tx share of energy_j
    emb_bytes: int
    agent_flops: float
    server_flops: float
    # wire bytes per leading batch row (sums to emb_bytes)
    emb_row_bytes: tuple = ()
    # per-agent-layer bits when a mixed-precision plan is active (else ())
    plan_bits: tuple = ()


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One (T0, E0) service class; the engine solves (P1) per class."""
    name: str
    t0: float
    e0: float


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One queued inference request (token ids + QoS class)."""
    request_id: int
    tokens: np.ndarray          # int32 [S]
    qos: str
    arrival_s: float            # virtual arrival time (queueing model)


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request accounting inside a served batch."""
    request_id: int
    qos: str
    b_hat: int
    batch_size: int
    queue_wait_s: float         # modeled wait before its batch started
    batch_delay_s: float        # forward delay of the batch it rode in
    total_delay_s: float        # queue wait + batch delay
    energy_j: float             # amortized share of the batch energy
    emb_bytes: int              # this request's uplink bytes


@dataclasses.dataclass(frozen=True)
class ServeResponse:
    request_id: int
    logits: torch.Tensor        # [S, vocab], padding stripped
    stats: RequestStats


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """What one batched forward cost and how well the batch was packed."""
    qos: str
    batch_size: int
    b_hat: int
    agent_path: str             # kernel-int8/kernel-int4/fake (what ran)
    f: float
    f_server: float
    real_tokens: int            # sum of request lengths
    padded_tokens: int          # batch_size * padded seq len
    occupancy: float            # real / padded (1.0 = no padding waste)
    batch_delay_s: float        # agent + uplink + server for the batch
    amortized_delay_s: float    # batch_delay / batch_size
    energy_j: float
    amortized_energy_j: float
    emb_bytes: int
    queue_wait_mean_s: float
    queue_wait_max_s: float
    # per-agent-layer bits when the class serves a mixed plan (else ())
    plan_bits: tuple = ()


@dataclasses.dataclass(frozen=True)
class EngineReport(ReportBase):
    """Whole-run aggregates of a :class:`BatchedCoInferenceEngine`."""
    requests_served: int
    batches_served: int
    mean_batch_size: float
    mean_occupancy: float
    total_delay_s: float        # virtual clock at the end of the run
    total_energy_j: float
    throughput_rps: float       # requests / modeled second
    codesign_hits: int          # THIS engine's cache hits (not cache-global)
    codesign_misses: int        # (P1) solves this engine actually triggered
    # compiled-path counters, all zero when the engine serves eagerly:
    # THIS engine's own lookups (the cache may be shared), every miss one
    # capture; ``compiled_variants`` counts the cache's entries
    compile_hits: int = 0
    compile_misses: int = 0
    compiled_variants: int = 0


def fit_lambda(params, split: int) -> float:
    """MLE λ over the agent-partition weight magnitudes (paper eq. (3)).

    Scans the stacked leaves of ``params["layers"]`` (ndim >= 3, floating)
    in the reference's leaf order (sorted keys) and fits the exponential
    rate over layers ``[0, split)``.
    """
    total, count = 0.0, 0
    for leaf in tree_leaves(params["layers"]):
        if leaf.ndim >= 3 and torch.is_floating_point(leaf):
            sl = leaf[: min(split, leaf.shape[0])]
            total += float(torch.sum(torch.abs(sl)))
            count += sl.numel()
    return count / max(total, 1e-30) if count else 100.0


class CodesignCache:
    """Memoizes ``(SystemParams, QosClass) -> solution``.

    Every decision input (the weight statistic ``lam``, the hardware
    constants, the class's (T0, E0)) is hashable, so one dict amortizes the
    host-side solve across every request of a class and across engines
    sharing the cache.  Infeasible classes are cached as ``None``.  The
    uniform, decode and layer-wise solves live in disjoint keyspaces of
    one store.
    """

    def __init__(self):
        self._store: Dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(lam: float, sysp: SystemParams, qos: QosClass,
            b_max: int, b_emb: Optional[int] = None,
            env_key: Optional[tuple] = None) -> tuple:
        # keyed on the numbers, not qos.name: two classes with equal
        # (T0, E0) share one solve; ``env_key`` tags a solve made under an
        # environment-adjusted SystemParams (the adaptive engine's)
        return (round(float(lam), 12), sysp, float(qos.t0), float(qos.e0),
                int(b_max), b_emb, env_key)

    def _get(self, k: tuple, solve):
        if k in self._store:
            self.hits += 1
        else:
            self.misses += 1
            self._store[k] = solve()
        return self._store[k]

    def solve(self, lam: float, sysp: SystemParams, qos: QosClass,
              b_max: int, b_emb: Optional[int] = None,
              env_key: Optional[tuple] = None
              ) -> Optional[cd.CodesignSolution]:
        return self._get(
            self.key(lam, sysp, qos, b_max, b_emb, env_key),
            lambda: cd.solve_sca(lam, sysp, qos.t0, qos.e0, b_max=b_max,
                                 b_emb=b_emb))

    def solve_mixed(self, stats: mp.LayerStats, sysp: SystemParams,
                    qos: QosClass, b_max: int,
                    b_emb: Optional[int] = None,
                    env_key: Optional[tuple] = None
                    ) -> Optional[mp.MixedSolution]:
        """Memoized per-layer bit allocation, keyed on the layer statistics
        (λ^(l), A^(l)), the allocation's whole decision input, in a
        "mixed"-tagged keyspace beside :meth:`solve`'s."""
        k = ("mixed", stats.key(), sysp, float(qos.t0), float(qos.e0),
             int(b_max), b_emb, env_key)
        return self._get(k, lambda: mp.allocate_bits(
            stats, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb))

    def solve_decode(self, lam: float, lam_kv: float, sysp: SystemParams,
                     qos: QosClass, b_max: int,
                     b_emb: Optional[int] = None,
                     kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                     kv_weight: float = 1.0,
                     env_key: Optional[tuple] = None
                     ) -> Optional[cd.DecodeSolution]:
        """Memoized joint (b̂, f, f̃, b_kv) decode solve, in a "kv"-tagged
        keyspace beside :meth:`solve`'s, so decode and prefill engines
        share one memoizer."""
        k = ("kv", round(float(lam), 12), round(float(lam_kv), 12), sysp,
             float(qos.t0), float(qos.e0), int(b_max), b_emb,
             tuple(int(b) for b in kv_ladder), float(kv_weight), env_key)
        return self._get(k, lambda: cd.solve_decode(
            lam, lam_kv, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb,
            kv_ladder=kv_ladder, kv_weight=kv_weight))

    def solve_decode_mixed(self, stats: mp.LayerStats, lam_kv: float,
                           sysp: SystemParams, qos: QosClass, b_max: int,
                           b_emb: Optional[int] = None,
                           kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                           kv_weight: float = 1.0,
                           env_key: Optional[tuple] = None
                           ) -> Optional[mp.MixedDecodeSolution]:
        """Memoized per-layer allocation and b_kv (the decode counterpart
        of :meth:`solve_mixed`), in a "kv-mixed"-tagged keyspace."""
        k = ("kv-mixed", stats.key(), round(float(lam_kv), 12), sysp,
             float(qos.t0), float(qos.e0), int(b_max), b_emb,
             tuple(int(b) for b in kv_ladder), float(kv_weight), env_key)
        return self._get(k, lambda: mp.allocate_bits_decode(
            stats, lam_kv, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb,
            kv_ladder=kv_ladder, kv_weight=kv_weight))

    def solve_speculative(self, lam: float, lam_kv: float,
                          sysp: SystemParams, qos: QosClass, b_max: int,
                          b_emb: Optional[int] = None,
                          kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                          kv_weight: float = 1.0,
                          draft_ladder: "tuple[int, ...]" = (2, 4, 8),
                          lookahead: "tuple[int, ...]" = (2, 4, 8),
                          env_key: Optional[tuple] = None
                          ) -> Optional[cd.SpeculativeSolution]:
        """Memoized joint (b̂, f, f̃, b_kv, b_draft, k) speculative solve,
        in a "spec"-tagged keyspace carrying the draft ladder and the
        lookahead menu beside :meth:`solve_decode`'s inputs."""
        k = ("spec", round(float(lam), 12), round(float(lam_kv), 12), sysp,
             float(qos.t0), float(qos.e0), int(b_max), b_emb,
             tuple(int(b) for b in kv_ladder), float(kv_weight),
             tuple(int(b) for b in draft_ladder),
             tuple(int(b) for b in lookahead), env_key)
        return self._get(k, lambda: cd.solve_speculative(
            lam, lam_kv, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb,
            kv_ladder=kv_ladder, kv_weight=kv_weight,
            draft_ladder=draft_ladder, lookahead=lookahead))

    def solve_speculative_mixed(self, stats: mp.LayerStats, lam_kv: float,
                                sysp: SystemParams, qos: QosClass,
                                b_max: int, b_emb: Optional[int] = None,
                                kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                                kv_weight: float = 1.0,
                                draft_ladder: "tuple[int, ...]" = (2, 4, 8),
                                lookahead: "tuple[int, ...]" = (2, 4, 8),
                                env_key: Optional[tuple] = None
                                ) -> Optional[mp.MixedSpeculativeSolution]:
        """Memoized per-layer allocation and (b_kv, b_draft, k), the
        speculative counterpart of :meth:`solve_decode_mixed`, in a
        "spec-mixed"-tagged keyspace."""
        k = ("spec-mixed", stats.key(), round(float(lam_kv), 12), sysp,
             float(qos.t0), float(qos.e0), int(b_max), b_emb,
             tuple(int(b) for b in kv_ladder), float(kv_weight),
             tuple(int(b) for b in draft_ladder),
             tuple(int(b) for b in lookahead), env_key)
        return self._get(k, lambda: mp.allocate_bits_speculative(
            stats, lam_kv, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb,
            kv_ladder=kv_ladder, kv_weight=kv_weight,
            draft_ladder=draft_ladder, lookahead=lookahead))

    def __len__(self) -> int:
        return len(self._store)


class CoInferenceEngine:
    """One agent/server pair serving a dense DecoderLM."""

    def __init__(self, model, params, sysp: SystemParams, *,
                 lam: Optional[float] = None,
                 scheme: str = "uniform",
                 path: Literal["fake", "kernel"] = "fake",
                 b_emb: int = 8,
                 cache_weights: bool = False,
                 compiled: bool = False,
                 compile_cache: Optional[fp.CompiledForwardCache] = None,
                 seq_bucket_base: int = DEFAULT_SEQ_BASE,
                 batch_quantum: Optional[int] = None,
                 tracer=None, metrics=None,
                 device=None):
        if not hasattr(model, "run_layers_window"):
            raise TypeError(
                f"{type(model).__name__} lacks run_layers_window; "
                "co-inference split execution needs the DecoderLM protocol")
        if compiled and not hasattr(model, "embed"):
            raise TypeError(
                f"{type(model).__name__} lacks the embed hook; the "
                "compiled fast path needs it")
        self.device = resolve_device(device)
        set_float32_numerics()
        self.model = model
        self.cfg = model.cfg
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.sysp = sysp
        self.scheme = scheme
        self.path = path
        self.b_emb = b_emb
        self.split = self.cfg.split_layer
        # compiled fast path: token batches pad to the (batch quantum, seq
        # bucket) ladder and run one compiled forward per (plan, bucket)
        self.compiled = bool(compiled)
        self.seq_bucket_base = int(seq_bucket_base)
        self.batch_quantum = int(batch_quantum) if batch_quantum else None
        self.compile_cache = compile_cache if compile_cache is not None \
            else (fp.CompiledForwardCache() if compiled else None)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        # this engine's own compile-cache lookups (the cache may be shared)
        self._own_compile_hits = 0
        self._own_compile_misses = 0
        # weight key -> (segment descs, stacked arrays) of the kernel path
        self._stacked: Dict[tuple, tuple] = {}
        # weight key -> the compile cache's shared entry of that weight set
        self._shared: Dict[tuple, dict] = {}
        self._axes = model.logical_axes()
        self.lam = float(lam) if lam is not None \
            else fit_lambda(self.params, self.split)
        self.b_hat: int = 8
        # the cost model's bit-width: b̂, or a plan's mean agent bits
        self.b_eff: float = 8.0
        self.plan: Optional[QuantPlan] = None
        self.f: float = sysp.f_max
        self.f_server: float = sysp.f_server_max
        # set by configure(): fake-quantized params, or the per-layer
        # quantized records
        self._agent_params = None
        self._qlinears = None
        self._layer_stats: Optional[mp.LayerStats] = None
        # stable plan key -> materialized agent weights, so the batched
        # engine flips between QoS classes without re-quantizing
        self._weight_cache: Optional[Dict[tuple, tuple]] = \
            {} if cache_weights else None
        self.configure(self.b_hat, self.f, self.f_server)

    def flop_split(self, tokens: int):
        """(agent_flops, server_flops) for one forward over ``tokens``."""
        per_layer = self.cfg.active_param_count() / max(self.cfg.n_layers, 1)
        n_agent = 2.0 * per_layer * self.split * tokens
        n_server = 2.0 * per_layer * (self.cfg.n_layers - self.split) * tokens
        return n_agent, n_server

    # ------------------------------------------------------------------
    # configuration (the paper's decision variables)
    # ------------------------------------------------------------------
    def configure(self, b_hat, f: Optional[float] = None,
                  f_server: Optional[float] = None) -> None:
        """Set the operating point and materialize the agent weights.

        ``b_hat`` is a uniform bit-width or a :class:`QuantPlan`.  A plan
        whose agent layers all resolve to one width degenerates to the
        uniform path when that path quantizes identically, exactly as in
        the reference, so ``agent_path`` strings match.  Materialized
        weights are memoized on the stable plan key when
        ``cache_weights`` is on, and, with a compile cache, shared through
        it by every engine over the same params object (so their captured
        graphs are shared too).
        """
        kernel_ok = self.path == "kernel" and not self.cfg.n_experts
        plan = None
        if isinstance(b_hat, QuantPlan):
            plan = b_hat
            ub = plan.uniform_layer_bits(self.split)
            same_quant = plan.scheme == self.scheme \
                and plan.granularity == "per-channel"
            plan_kernel = kernel_ok and plan.scheme == "uniform"
            if ub is not None and same_quant and \
                    (not plan_kernel or ub in (4, 8) or ub > 8):
                b_hat, plan = ub, None
        if f is not None:
            self.f = float(f)
        if f_server is not None:
            self.f_server = float(f_server)
        self.plan = plan
        if plan is None:
            self.b_hat = int(b_hat)
            self.b_eff = float(self.b_hat)
            key = ("uniform", self.b_hat)
        else:
            self.b_eff = plan.mean_bits(self.split)
            self.b_hat = int(round(self.b_eff))
            key = plan.key()
        # the identity of the materialized weights: the weight cache, the
        # restacked segments and the compiled forwards all key on it
        self._weight_key = key
        if self._weight_cache is not None and key in self._weight_cache:
            self._agent_params, self._qlinears = self._weight_cache[key]
            return
        if self.compile_cache is not None:
            # engines over one params object and one compile cache share
            # the materialized weights, and with them the captured graphs
            # that bake those tensors in; the entry keeps ``params`` alive,
            # so its addresses cannot be reused under a live key
            entry = self.compile_cache.buffers(
                ("agent-weights", fp.tree_key(self.params), key,
                 self.scheme, self.path),
                lambda: {"weights": self._materialize(plan),
                         "params": self.params, "stacked": None})
            self._agent_params, self._qlinears = entry["weights"]
            self._shared[key] = entry
        else:
            self._agent_params, self._qlinears = self._materialize(plan)
        if self._weight_cache is not None:
            self._weight_cache[key] = (self._agent_params, self._qlinears)

    def _materialize(self, plan: Optional[QuantPlan]):
        """(fake-quantized agent params, kernel weight records) at the
        current operating point: one of the two is None."""
        kernel_ok = self.path == "kernel" and not self.cfg.n_experts
        if plan is not None:
            if kernel_ok and plan.scheme == "uniform":
                return None, self._quantize_kernel_weights(plan)
            return fake_quantize_agent(self.params, self._axes, self.cfg,
                                       plan, ste=False), None
        if kernel_ok and self.b_hat in (4, 8):
            return None, self._quantize_kernel_weights(
                QuantPlan.uniform(self.b_hat, scheme=self.scheme))
        qcfg = QuantConfig(bits=self.b_hat, scheme=self.scheme,
                           granularity="per-channel")
        return fake_quantize_agent(self.params, self._axes, self.cfg, qcfg,
                                   ste=False), None

    @property
    def agent_path(self) -> str:
        """What materialized at the current operating point:
        ``kernel-int8``/``kernel-int4``, ``kernel-mixed[b0/b1/...]`` or
        ``fake``."""
        if self._qlinears is not None:
            if self.plan is not None:
                bl = "/".join(str(r["bits"]) for r in self._qlinears)
                return f"kernel-mixed[{bl}]"
            return f"kernel-int{self.b_hat}"
        return "fake"

    def auto_configure(self, qos: QosClass,
                       cache: Optional[CodesignCache] = None
                       ) -> Optional[cd.CodesignSolution]:
        """Solve (P1) for this QoS class and apply the solution; with
        ``cache`` the solve is memoized (:class:`CodesignCache`)."""
        b_max = int(self.sysp.b_full)
        if cache is not None:
            sol = cache.solve(self.lam, self.sysp, qos, b_max,
                              b_emb=self.b_emb)
        else:
            sol = cd.solve_sca(self.lam, self.sysp, qos.t0, qos.e0,
                               b_max=b_max, b_emb=self.b_emb)
        if sol is None:
            return None
        self.configure(sol.b_hat, sol.f, sol.f_server)
        return sol

    # ------------------------------------------------------------------
    # mixed-precision configuration
    # ------------------------------------------------------------------
    def layer_stats(self) -> mp.LayerStats:
        """Per-agent-layer (λ^(l), A^(l)) on the engine's device, computed
        once and memoized: the allocation's whole decision input besides
        the cost model."""
        if self._layer_stats is None:
            self._layer_stats = mp.decoder_layer_stats(self.params,
                                                       self.split)
        return self._layer_stats

    def plan_of(self, sol: mp.MixedSolution) -> QuantPlan:
        """The :class:`QuantPlan` realizing an allocation on this engine."""
        return mp.plan_from_bits(sol.bits, scheme=self.scheme)

    def auto_configure_mixed(self, qos: QosClass,
                             cache: Optional[CodesignCache] = None
                             ) -> Optional[mp.MixedSolution]:
        """Solve the per-layer bit allocation for this QoS class and apply
        its plan (the layer-wise :meth:`auto_configure`); with ``cache``
        the allocation is memoized on the layer statistics."""
        b_max = int(self.sysp.b_full)
        if cache is not None:
            sol = cache.solve_mixed(self.layer_stats(), self.sysp, qos,
                                    b_max, b_emb=self.b_emb)
        else:
            sol = mp.allocate_bits(self.layer_stats(), self.sysp, qos.t0,
                                   qos.e0, b_max=b_max, b_emb=self.b_emb)
        if sol is None:
            return None
        self.configure(self.plan_of(sol), sol.f, sol.f_server)
        return sol

    # ------------------------------------------------------------------
    # kernel-path weight prep (dense DecoderLM)
    # ------------------------------------------------------------------
    def _quantize_kernel_weights(self, plan: QuantPlan):
        """Per-layer weight records for wq/wk/wv/wo/mlp of layers [0,split).

        Layer i materializes at ``plan.layer_bits(i)``: bits <= 4 →
        int4-packed, 5..8 → int8, group size ``plan.group_size`` along the
        contraction axis, every such matrix in one ``group_quantize``
        launch on the card.  Layers wider than 8 bits keep fake-quantized
        full-precision matrices.
        """
        lp = self.params["layers"]
        mlp_names = [n for n in ("wi_gate", "wi_up", "wi", "wo")
                     if n in lp["ffn"]]
        out, slots, ws, bits = [], [], [], []
        for i in range(self.split):
            b = plan.layer_bits(i)
            rec = {"attn": {}, "ffn": {}, "bits": b}
            for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                ("ffn", mlp_names)):
                for n in names:
                    w = lp[part][n][i].to(torch.float32).contiguous()
                    if b <= 8:
                        slots.append((rec, part, n))
                        ws.append(w)
                        bits.append(b)
                    else:
                        rec[part][n] = quantize_dequantize(
                            w, plan.config_for_layer(i))
            out.append(rec)
        for (rec, part, n), q in zip(slots, kops.quantize_linears(
                ws, bits, group_size=plan.group_size)):
            rec[part][n] = q
        return out

    def _stacked_segments(self):
        """Layer-stacked segments of the current kernel weights, memoized
        on the weight key."""
        key = self._weight_key
        if key not in self._stacked:
            entry = self._shared.get(key)
            if entry is None:
                self._stacked[key] = fp.restack_segments(self._qlinears)
            else:
                if entry["stacked"] is None:
                    entry["stacked"] = fp.restack_segments(self._qlinears)
                self._stacked[key] = entry["stacked"]
        return self._stacked[key]

    def _agent_forward_kernel(self, x, positions):
        """Agent layers over the quantized weights, one loop per segment.
        ``x`` is [B, S, D] for any B: the matmul wrappers flatten every
        leading dim into the kernel's M axis."""
        descs, arrays = self._stacked_segments()
        side = fp.layer_side_tree(self.params["layers"], self.cfg)
        for desc, seg in zip(descs, arrays):
            x = fp.scan_segment(self.cfg, desc, seg, side, x, positions,
                                desc.length, self.model.attend)
        return x

    # ------------------------------------------------------------------
    # compiled fast path
    # ------------------------------------------------------------------
    def bucket_shape(self, b: int, s: int):
        """The (batch, seq) bucket a [b, s] token batch pads up to: S on
        the geometric seq ladder, B to the batch quantum (next multiple)
        or, quantum-less, to the next power of two."""
        sp = seq_bucket(s, base=self.seq_bucket_base)
        if self.batch_quantum:
            q = self.batch_quantum
            bp = -(-b // q) * q
        else:
            bp = next_geometric(b, 1)
        return bp, sp

    def _agent_repr(self):
        """(container signature, agent argument tree, segment descs) for
        the current operating point: kernel-resident weights restacked
        into segments (memoized per weight key), or the fake path's
        parameter tree."""
        if self._qlinears is not None:
            descs, arrays = self._stacked_segments()
            return ("kernel",) + descs, arrays, descs
        agent = self._agent_params if self._agent_params is not None \
            else self.params
        return ("fake",), agent, None

    def _compiled_executable(self, bp: int, sp: int):
        """The compiled forward for the current plan at bucket (bp, sp),
        through the compile cache (one capture per miss on the card).

        The key is the reference's ``(config, weight key, container
        signature, bucket, split, b_emb)`` and, last, the addresses of the
        parameter and agent tensors the graph bakes in: the closure bakes in
        config constants (rope theta, window, activation, ...) and, on the
        card, the weights themselves, so a cache shared by engines over
        different models or different weights never serves one engine's
        graph to another."""
        sig, agent, descs = self._agent_repr()
        key = (self.cfg, self._weight_key, sig, (bp, sp), self.split,
               self.b_emb, (fp.tree_key(self.params), fp.tree_key(agent)))

        def build():
            fwd = fp.build_forward(self.model, self.split, self.b_emb, descs,
                                   "kernel" if descs is not None else "fake",
                                   bp)
            pool = cc.pool() if self.device.type == "cuda" else None
            return fp.compile_forward(fwd, self.params, agent, bp, sp,
                                      self.device, pool)

        cc = self.compile_cache
        h0, m0 = cc.hits, cc.misses
        if key in cc:
            exe = cc.get(key, build)
        else:
            # a miss is one capture: traced and timed, keyed by (plan,
            # bucket); the span is "forward.capture" (the closure's first
            # build on a CPU engine)
            plan_tag = str(self._weight_key)
            bucket_tag = f"{bp}x{sp}"
            with self.tracer.span("forward.capture", plan=plan_tag,
                                  bucket=bucket_tag):
                t0 = time.monotonic()
                exe = cc.get(key, build)
                self.metrics.histogram(
                    "compile.seconds", plan=plan_tag,
                    bucket=bucket_tag).observe(time.monotonic() - t0)
        dh, dm = cc.hits - h0, cc.misses - m0
        self._own_compile_hits += dh
        self._own_compile_misses += dm
        if dh:
            self.metrics.counter("compile.cache_hits",
                                 engine=type(self).__name__).inc(dh)
        if dm:
            self.metrics.counter("compile.cache_misses",
                                 engine=type(self).__name__).inc(dm)
        return exe

    def precompile(self, batch: int, seq: int) -> None:
        """Warm the compile cache for a [batch, seq] workload at the
        current operating point (a capture, and its eager warm-up run)."""
        if self.compile_cache is None:
            raise RuntimeError("precompile() needs compiled=True")
        bp, sp = self.bucket_shape(batch, seq)
        self._compiled_executable(bp, sp)

    def _serve_batch_compiled(self, tokens, lengths=None):
        """Bucket-pad, run the compiled forward, bill the padded workload.

        Per-request logits equal the eager engine's at the same bucket:
        the graph replays the kernels the eager path launches.  They are
        sliced to the real (b0, s0) and copied out of the graph's pool
        before anything can replay it again."""
        toks = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                          else tokens, np.int64)
        b0, s0 = toks.shape
        lens = np.asarray(lengths, np.int64) if lengths is not None \
            else np.full((b0,), s0, np.int64)
        bp, sp = self.bucket_shape(b0, s0)
        padded = np.zeros((bp, sp), np.int64)
        padded[:b0, :s0] = toks
        lens_p = np.zeros((bp,), np.int64)
        lens_p[:b0] = lens
        exe = self._compiled_executable(bp, sp)
        with torch.no_grad():
            exe.tokens.copy_(torch.from_numpy(padded))
            exe.lengths.copy_(torch.from_numpy(lens_p))
            logits = exe()[:b0, :s0].clone()

        # uplink wire bytes per real row: transport()'s accounting
        row_bytes = self._row_wire_bytes(lens)
        # the batch is billed at the padded workload: bucket padding is
        # compute the hardware really runs
        return logits, self._stats(bp * sp, row_bytes)

    # ------------------------------------------------------------------
    # the two inference stages + transport
    # ------------------------------------------------------------------
    def _batch_to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.as_tensor(v).to(
                    self.device, dtype=torch.long if k == "tokens" else None)
                for k, v in batch.items()}

    def agent_stage(self, batch: Dict[str, Any]):
        """Embedding + layers [0, split) at bit-width b̂."""
        batch = self._batch_to_device(batch)
        src = self._agent_params if self._agent_params is not None \
            else self.params
        x, positions = self.model._embed(src, batch)
        if self._qlinears is not None:
            x = self._agent_forward_kernel(x, positions)
        else:
            x, _ = self.model.run_layers_window(
                src, x, positions, 0, self.split,
                products=L.tc_matmul_group)
        return x, positions

    def transport(self, emb: torch.Tensor, lengths=None):
        """Quantize the boundary activation for the uplink; returns
        (received embedding, per-row wire bytes).  The absmax scale is one
        per leading batch row (one request's own transmission); ``lengths``
        marks right-padding, which is zeroed and not billed."""
        if lengths is not None:
            real = np.asarray(lengths, np.int64)
        else:
            real = np.full((emb.shape[0],), emb.shape[1], np.int64)
        emb_q = fp.transport_quantize(
            emb, torch.as_tensor(real, device=emb.device), self.b_emb,
            emb.shape[0])
        return emb_q, self._row_wire_bytes(real)

    def _row_wire_bytes(self, real_lengths) -> tuple:
        """Per-request uplink wire bytes: the raw activation at
        b_emb >= 16, else the realizable code container plus one f32
        absmax scale per request."""
        d = int(self.cfg.d_model)
        if self.b_emb >= 16:
            itemsize = np.dtype(self.cfg.dtype).itemsize
            return tuple(int(s) * d * itemsize for s in real_lengths)
        return tuple(wire_bytes(int(s) * d, self.b_emb) + 4
                     for s in real_lengths)

    def server_stage(self, emb: torch.Tensor, positions):
        """Layers [split, L) at full precision + head, every product on
        the row-independent tensor-core GEMM (``layers.tc_matmul``): a
        request's logits do not depend on the batch it shares."""
        x, _ = self.model.run_layers_window(self.params, emb, positions,
                                            self.split, self.cfg.n_layers,
                                            products=L.tc_matmul_group)
        x = L.apply_norm(self.cfg, x, self.params["final_norm"])
        return L.unembed(self.cfg, self.params["embed"], x,
                         matmul=L.tc_matmul)

    # ------------------------------------------------------------------
    def serve_batch(self, batch: Dict[str, Any], lengths=None):
        """Full co-inference pass; returns (logits, ServeStats).

        ``lengths`` flags right-padded rows (see :meth:`transport`).  With
        ``compiled=True`` a token-only batch runs the compiled forward of
        its bucket."""
        if self.compiled and set(batch) == {"tokens"}:
            return self._serve_batch_compiled(batch["tokens"], lengths)
        with torch.no_grad():
            emb, positions = self.agent_stage(batch)
            emb_rx, row_bytes = self.transport(emb, lengths)
            logits = self.server_stage(emb_rx, positions)
        return logits, self._stats(positions.numel(), row_bytes)

    def _stats(self, tokens: int, row_bytes: tuple) -> ServeStats:
        """The cost model's delay and energy for a forward over ``tokens``
        shipping ``row_bytes`` on the uplink."""
        emb_bytes = sum(row_bytes)
        n_a, n_s = self.flop_split(tokens)
        p = dataclasses.replace(self.sysp, n_flop_agent=n_a,
                                n_flop_server=n_s,
                                emb_bytes_full=float(emb_bytes)
                                * 16.0 / self.b_emb)
        t_a = float(agent_delay(self.b_eff, self.f, p))
        t_s = float(server_delay(self.f_server, p))
        t_x = float(transport_delay(self.b_emb, p))
        e_x = float(transport_energy(self.b_emb, p))
        e = float(agent_energy(self.b_eff, self.f, p)
                  + server_energy(self.f_server, p)) + e_x
        return ServeStats(
            b_hat=self.b_hat, f=self.f, f_server=self.f_server,
            agent_delay_s=t_a, server_delay_s=t_s, transport_delay_s=t_x,
            total_delay_s=t_a + t_s + t_x, energy_j=e,
            transport_energy_j=e_x, emb_bytes=emb_bytes,
            agent_flops=n_a, server_flops=n_s, emb_row_bytes=row_bytes,
            plan_bits=(self.plan.layer_bit_list(self.split)
                       if self.plan is not None else ()))


# ---------------------------------------------------------------------------
# batched engine
# ---------------------------------------------------------------------------

class BatchedCoInferenceEngine:
    """Queue -> per-QoS-class batches -> one forward per batch.

    Scheduling: strict FIFO *across* classes: each step serves the class of
    the oldest pending request, pulling up to ``max_batch`` of that class's
    oldest requests into one batch.  Classes never share a batch, because a
    batch runs at exactly one (b̂, f, f̃) operating point.

    Requests are right-padded to the longest sequence in their batch (or,
    compiled, to the batch's bucket) and their logits are sliced back to
    the true length; per request they are what :class:`CoInferenceEngine`
    returns for the request alone (bitwise on the CPU).

    Time is virtual: a batch starts at max(clock, last member's arrival),
    runs for the cost model's batch delay, and advances the clock.
    """

    def __init__(self, model, params, sysp: SystemParams, *,
                 classes: Sequence[QosClass],
                 max_batch: int = 8,
                 path: Literal["fake", "kernel"] = "fake",
                 b_emb: int = 8,
                 lam: Optional[float] = None,
                 scheme: str = "uniform",
                 codesign_cache: Optional[CodesignCache] = None,
                 pad_token: int = 0,
                 mixed_precision: bool = False,
                 compiled: bool = False,
                 compile_cache: Optional[fp.CompiledForwardCache] = None,
                 seq_bucket_base: int = DEFAULT_SEQ_BASE,
                 tracer=None, metrics=None,
                 device=None):
        if not classes:
            raise ValueError("need at least one QosClass")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        # compiled serving buckets every batch to (max_batch, seq bucket):
        # the compiled-variant count is len(seq ladder) x active plans
        self.engine = CoInferenceEngine(model, params, sysp, lam=lam,
                                        scheme=scheme, path=path,
                                        b_emb=b_emb, cache_weights=True,
                                        compiled=compiled,
                                        compile_cache=compile_cache,
                                        seq_bucket_base=seq_bucket_base,
                                        batch_quantum=max_batch,
                                        tracer=tracer, metrics=metrics,
                                        device=device)
        self.tracer = self.engine.tracer
        self.metrics = self.engine.metrics
        self.compiled = bool(compiled)
        self.sysp = sysp
        self.max_batch = int(max_batch)
        self.pad_token = int(pad_token)
        self.mixed_precision = bool(mixed_precision)
        self.classes: Dict[str, QosClass] = {c.name: c for c in classes}
        if len(self.classes) != len(classes):
            raise ValueError("duplicate QosClass names")
        self.codesign_cache = codesign_cache \
            if codesign_cache is not None else CodesignCache()
        self._queue: Deque[ServeRequest] = collections.deque()
        self._next_id = 0
        self._clock = 0.0
        self.batch_history: List[BatchStats] = []
        self._served = 0
        self._energy = 0.0
        # every class resolved up front, one (P1) solve (or, mixed, one
        # layer-wise allocation) per distinct decision input; hits/misses
        # counted per call, so report() attributes this engine only its
        # own lookups
        self._own_hits = 0
        self._own_misses = 0
        self._solutions: Dict[str, Any] = {}
        self._plans: Dict[str, QuantPlan] = {}
        for c in classes:
            sol = self._resolve_class(c)
            if sol is None:
                raise ValueError(
                    f"QoS class {c.name!r} is infeasible under "
                    f"(T0={c.t0}, E0={c.e0})")
            self._solutions[c.name] = sol
            if self.mixed_precision:
                self._plans[c.name] = self.engine.plan_of(sol)

    # ------------------------------------------------------------------
    # per-class operating points
    # ------------------------------------------------------------------
    def _resolve_class(self, c: QosClass):
        """The class's operating point; None = infeasible (the constructor
        raises).  ``AdaptiveCoInferenceEngine`` overrides this to solve
        under the environment's state and to degrade instead of returning
        None."""
        return self._counted_solution(c)

    def _counted_solution(self, c: QosClass,
                          sysp: Optional[SystemParams] = None,
                          env_key: Optional[tuple] = None):
        """:meth:`_class_solution` with this engine's own hit/miss
        attribution (the cache may be shared across engines)."""
        cache = self.codesign_cache
        h0, m0 = cache.hits, cache.misses
        sol = self._class_solution(c, sysp=sysp, env_key=env_key)
        dh, dm = cache.hits - h0, cache.misses - m0
        self._own_hits += dh
        self._own_misses += dm
        if dh:
            self.metrics.counter("codesign.cache_hits",
                                 engine=type(self).__name__,
                                 qos=c.name).inc(dh)
        if dm:
            self.metrics.counter("codesign.cache_misses",
                                 engine=type(self).__name__,
                                 qos=c.name).inc(dm)
        return sol

    def _class_solution(self, c: QosClass,
                        sysp: Optional[SystemParams] = None,
                        env_key: Optional[tuple] = None):
        """One memoized (P1) solve, or layer-wise allocation in
        mixed-precision mode, for class ``c`` under ``sysp`` (default: the
        engine's static params), tagged with ``env_key``."""
        p = self.sysp if sysp is None else sysp
        b_max = int(p.b_full)
        if self.mixed_precision:
            return self.codesign_cache.solve_mixed(
                self.engine.layer_stats(), p, c, b_max=b_max,
                b_emb=self.engine.b_emb, env_key=env_key)
        return self.codesign_cache.solve(self.engine.lam, p, c, b_max=b_max,
                                         b_emb=self.engine.b_emb,
                                         env_key=env_key)

    def solution_for(self, qos_name: str):
        """The class's operating point: a ``CodesignSolution`` (uniform
        mode) or a ``MixedSolution`` (mixed-precision mode)."""
        return self._solutions[qos_name]

    def plan_for(self, qos_name: str) -> Optional[QuantPlan]:
        """The class's :class:`QuantPlan` (None in uniform mode)."""
        return self._plans.get(qos_name)

    def _configure_class(self, name: str) -> None:
        """Put the engine at the class's operating point (a weight-cache
        lookup after the class's first batch)."""
        sol = self._solutions[name]
        self.engine.configure(self._plans.get(name, sol.b_hat), sol.f,
                              sol.f_server)

    def warmup(self, max_seq: int) -> int:
        """Compile every (class plan, seq bucket) forward for requests up
        to ``max_seq`` tokens; afterwards every step whose sequences fit
        the ladder is a compile-cache hit.  Returns the number of forwards
        compiled (captured on the card) by this call; those already in a
        shared cache are not compiled again."""
        if not self.compiled:
            raise RuntimeError("warmup() needs compiled=True")
        cc = self.engine.compile_cache
        m0 = cc.misses
        for name in self.classes:
            self._configure_class(name)
            for s in seq_ladder(max_seq, base=self.engine.seq_bucket_base):
                self.engine.precompile(self.max_batch, s)
        return cc.misses - m0

    # ------------------------------------------------------------------
    # queue API
    # ------------------------------------------------------------------
    def submit(self, tokens, qos: str,
               arrival_s: Optional[float] = None) -> int:
        """Enqueue one request; returns its request id."""
        if qos not in self.classes:
            raise KeyError(f"unknown QoS class {qos!r}; have "
                           f"{sorted(self.classes)}")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty request")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(ServeRequest(
            request_id=rid, tokens=toks, qos=qos,
            arrival_s=float(arrival_s) if arrival_s is not None
            else self._clock))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def oldest_pending_arrival(self) -> Optional[float]:
        """Earliest arrival among queued requests (None when empty); not
        simply the queue head, since ``submit`` accepts any
        ``arrival_s``."""
        if not self._queue:
            return None
        return min(r.arrival_s for r in self._queue)

    @property
    def clock_s(self) -> float:
        return self._clock

    def fast_forward(self, t_s: float) -> None:
        """Advance the virtual clock to ``t_s`` (never backwards)."""
        self._clock = max(self._clock, float(t_s))

    def cancel(self, request_id: int) -> bool:
        """Drop a still-queued request; True when it was queued."""
        n0 = len(self._queue)
        self._queue = collections.deque(
            r for r in self._queue if r.request_id != request_id)
        return len(self._queue) < n0

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _take_batch(self) -> List[ServeRequest]:
        """The oldest request decides the class; pull up to max_batch of
        it, only requests already arrived by the batch's start instant
        (max(clock, head arrival))."""
        head = self._queue[0]
        cls = head.qos
        t_start = max(self._clock, head.arrival_s)
        picked = []
        for r in self._queue:
            if r.qos == cls and r.arrival_s <= t_start * (1.0 + 1e-12):
                picked.append(r)
                if len(picked) == self.max_batch:
                    break
        ids = {r.request_id for r in picked}
        self._queue = collections.deque(
            r for r in self._queue if r.request_id not in ids)
        return picked

    def step(self) -> List[ServeResponse]:
        """Serve one batch; returns its responses ([] if queue empty)."""
        if not self._queue:
            return []
        with self.tracer.span("batch.assemble"):
            reqs = self._take_batch()
            qos = self.classes[reqs[0].qos]
            self._configure_class(qos.name)
            s_max = max(r.tokens.size for r in reqs)
            lengths = [r.tokens.size for r in reqs]
            padded = np.full((len(reqs), s_max), self.pad_token, np.int32)
            for i, r in enumerate(reqs):
                padded[i, :r.tokens.size] = r.tokens
        with self.tracer.span("batch.forward", qos=qos.name,
                              n=len(reqs), seq=s_max):
            logits, stats = self.engine.serve_batch(
                {"tokens": padded}, lengths=lengths)

        start = max(self._clock, max(r.arrival_s for r in reqs))
        self._clock = start + stats.total_delay_s
        n = len(reqs)
        waits = [start - r.arrival_s for r in reqs]
        real = sum(r.tokens.size for r in reqs)
        if self.compiled:
            # padded to the (batch quantum, seq bucket) shape
            bp, sp = self.engine.bucket_shape(n, s_max)
            n_padded = bp * sp
        else:
            n_padded = n * s_max
        bstats = BatchStats(
            qos=qos.name, batch_size=n, b_hat=stats.b_hat,
            agent_path=self.engine.agent_path, f=stats.f,
            f_server=stats.f_server, real_tokens=real,
            padded_tokens=n_padded, occupancy=real / n_padded,
            batch_delay_s=stats.total_delay_s,
            amortized_delay_s=stats.total_delay_s / n,
            energy_j=stats.energy_j,
            amortized_energy_j=stats.energy_j / n,
            emb_bytes=stats.emb_bytes,
            queue_wait_mean_s=sum(waits) / n,
            queue_wait_max_s=max(waits),
            plan_bits=stats.plan_bits)
        self.batch_history.append(bstats)
        self._served += n
        self._energy += stats.energy_j
        m = self.metrics
        if m.enabled:
            eng = type(self).__name__
            m.counter("serve.requests", engine=eng, qos=qos.name).inc(n)
            m.counter("serve.batches", engine=eng, qos=qos.name).inc()
            m.histogram("serve.batch_occupancy",
                        buckets=OCCUPANCY_BUCKETS, engine=eng,
                        qos=qos.name).observe(bstats.occupancy)
            m.histogram("serve.batch_delay_s", engine=eng,
                        qos=qos.name).observe(bstats.batch_delay_s)

        return [ServeResponse(
            request_id=r.request_id,
            logits=logits[i, :r.tokens.size],
            stats=RequestStats(
                request_id=r.request_id, qos=qos.name,
                b_hat=stats.b_hat, batch_size=n,
                queue_wait_s=waits[i],
                batch_delay_s=stats.total_delay_s,
                total_delay_s=waits[i] + stats.total_delay_s,
                energy_j=stats.energy_j / n,
                emb_bytes=stats.emb_row_bytes[i]))
            for i, r in enumerate(reqs)]

    def drain(self) -> List[ServeResponse]:
        """Serve until the queue is empty; responses in completion order."""
        out: List[ServeResponse] = []
        while self._queue:
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------
    def report(self) -> EngineReport:
        nb = len(self.batch_history)
        cc = self.engine.compile_cache
        return EngineReport(
            requests_served=self._served,
            batches_served=nb,
            mean_batch_size=self._served / nb if nb else 0.0,
            mean_occupancy=(sum(b.occupancy for b in self.batch_history)
                            / nb if nb else 0.0),
            total_delay_s=self._clock,
            total_energy_j=self._energy,
            throughput_rps=self._served / self._clock
            if self._clock > 0 else 0.0,
            codesign_hits=self._own_hits,
            codesign_misses=self._own_misses,
            compile_hits=self.engine._own_compile_hits,
            compile_misses=self.engine._own_compile_misses,
            compiled_variants=len(cc) if cc is not None else 0)
